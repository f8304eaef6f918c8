"""Shape-mask value object.

Replaces the consumed surface of ``ome.model.roi.Mask``
(``ShapeMaskRequestHandler.java:96-115``: fill color, packed 1-bit bytes,
width, height).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


DEFAULT_FILL_COLOR = (255, 255, 0, 255)  # yellow; ShapeMaskRequestHandler.java:99


@dataclass
class Mask:
    """A binary ROI mask: row-major 1-bit packed bytes plus dimensions.

    ``fill_color`` is the RGBA stored on the mask object, if any; the request
    may override it (``ShapeMaskRequestHandler.java:100-106``).
    """

    shape_id: int
    width: int
    height: int
    bytes_: bytes
    fill_color: Optional[Tuple[int, int, int, int]] = None

    def resolved_fill_color(
        self, override: Optional[Tuple[int, int, int, int]] = None
    ) -> Tuple[int, int, int, int]:
        if override is not None:
            return override
        if self.fill_color is not None:
            return self.fill_color
        return DEFAULT_FILL_COLOR
