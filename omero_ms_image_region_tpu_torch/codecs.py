"""Image encoding: RGBA render output -> HTTP bytes.

Replaces the reference's encode stage (``ImageRegionRequestHandler.java:
576-600``): JPEG via the compression service with a float quality
(``LocalCompress``, set at ``:457-460``), PNG via ImageIO, TIFF via the JAI
``TIFFImageWriter``.

Encoding is host-side CPU work downstream of the render kernel; the handler
runs it in a worker thread so the event loop never blocks on it.  ``PIL``
is imported where it is used, so the render path imports without it.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

# LocalCompressImpl's default JPEG quality when the request carries none.
DEFAULT_JPEG_QUALITY = 0.85

CONTENT_TYPES = {
    "jpeg": "image/jpeg",
    "png": "image/png",
    "tif": "image/tiff",
}


class UnknownFormatError(ValueError):
    """Unsupported output format (the reference logs and returns null,
    surfacing as a 404; ``ImageRegionRequestHandler.java:598-600``)."""


def quality_percent(quality: Optional[float]) -> int:
    """Request 0..1 float -> integer percent, with the LocalCompress
    default."""
    q = DEFAULT_JPEG_QUALITY if quality is None else quality
    return max(1, min(100, round(q * 100)))


def encode_rgba(rgba: np.ndarray, fmt: str,
                quality: Optional[float] = None) -> bytes:
    """Encode an RGBA tile to ``jpeg`` / ``png`` / ``tif`` bytes.

    ``rgba`` is u8[H, W, 4].  The reference builds an opaque
    ``TYPE_INT_RGB`` image from the packed ints (``ImageUtil
    .createBufferedImage``, ``:576-578``), so alpha is dropped for every
    format here too.  ``quality`` is the request's 0..1 float.
    """
    if fmt not in CONTENT_TYPES:
        raise UnknownFormatError(f"Unknown format {fmt}")
    from PIL import Image

    img = Image.fromarray(np.ascontiguousarray(rgba[..., :3]), mode="RGB")
    buf = io.BytesIO()
    if fmt == "jpeg":
        img.save(buf, format="JPEG", quality=quality_percent(quality))
    elif fmt == "png":
        img.save(buf, format="PNG")
    else:
        img.save(buf, format="TIFF")
    return buf.getvalue()


def encode_mask_png(grid: np.ndarray,
                    fill_color: Tuple[int, int, int, int]) -> bytes:
    """Encode a 0/1 mask grid as a palettized PNG.

    Mirrors the reference's 2-entry ``IndexColorModel``: index 0 fully
    transparent, index 1 the fill color with its alpha
    (``ShapeMaskRequestHandler.java:185-203``).
    """
    from PIL import Image

    grid = np.ascontiguousarray(grid.astype(np.uint8))
    img = Image.fromarray(grid, mode="P")
    r, g, b, a = fill_color
    img.putpalette([0, 0, 0, r, g, b][: 6])
    buf = io.BytesIO()
    img.save(buf, format="PNG", transparency=bytes([0, a]))
    return buf.getvalue()


def decode_to_rgba(data: bytes) -> np.ndarray:
    """Decode any supported image to u8[H, W, 4] (test/verification aid)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img)
