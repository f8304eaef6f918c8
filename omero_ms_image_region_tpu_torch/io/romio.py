"""The pre-FS OMERO pixel buffer: raw planes under ``<data.dir>/Pixels/<id>``.

The port's copy of the JAX package's ``io/romio.py``.  Images imported
before OMERO 5's ManagedRepository keep their pixel data in the legacy
ROMIO layout the reference reads through ``ome.io.nio.PixelsService`` (the
``/OMERO/Pixels`` bean, ``beanRefContext.xml:13-16``; ``config.yaml:19-20``
``omero.data.dir``): one file per Pixels row holding size_z*size_c*size_t
raw planes, **big-endian**, plane order z fastest (XYZCT: index =
z + size_z * (c + size_c * t)), no pyramid.

Geometry and pixel type are not in the file: they come from the ``pixels``
DB row, which the resolving caller (``services.db_metadata
.resolve_image_paths`` and ``io.service``) has in hand.  Like the port's
other readers, a region read can fill a caller's array (``out=``, the
handler's pinned staging buffer): the big-endian rows are byteswapped
straight into it, one copy.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..models.pixels import PIXELS_TYPES, Pixels
from ..server.region import RegionDef


class RomioPixelSource:
    """PixelSource over one legacy ROMIO pixels file."""

    def __init__(self, path: str, pixels: Pixels):
        self.path = path
        self._px = pixels
        self._dtype = np.dtype(PIXELS_TYPES[pixels.pixels_type].dtype)
        self._big = self._dtype.newbyteorder(">")
        self._plane_bytes = (pixels.size_x * pixels.size_y
                             * self._dtype.itemsize)
        n_planes = pixels.size_z * pixels.size_c * pixels.size_t
        self._f = open(path, "rb")
        size = os.fstat(self._f.fileno()).st_size
        if size < n_planes * self._plane_bytes:
            self._f.close()
            raise ValueError(
                f"{path}: ROMIO file holds {size} bytes, geometry needs "
                f"{n_planes * self._plane_bytes}")

    def _plane_offset(self, z: int, c: int, t: int) -> int:
        px = self._px
        if not (0 <= z < px.size_z and 0 <= c < px.size_c
                and 0 <= t < px.size_t):
            raise ValueError(f"plane ({z}, {c}, {t}) out of bounds")
        return (z + px.size_z * (c + px.size_c * t)) * self._plane_bytes

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def resolution_levels(self) -> int:
        return 1

    def resolution_descriptions(self) -> List[Tuple[int, int]]:
        return [(self._px.size_x, self._px.size_y)]

    def tile_size(self) -> Tuple[int, int]:
        # The reference server's default tile for a buffer without tiles.
        return (min(self._px.size_x, 256), min(self._px.size_y, 256))

    def _pread(self, n: int, offset: int) -> np.ndarray:
        data = os.pread(self._f.fileno(), n, offset)
        if len(data) != n:
            raise EOFError(f"{self.path}: short read")
        return np.frombuffer(data, self._big)

    def get_region(self, z: int, c: int, t: int, region: RegionDef,
                   level: int = 0, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        if level != 0:
            raise ValueError("ROMIO buffers have no pyramid levels")
        px = self._px
        x0, y0, w, h = region.x, region.y, region.width, region.height
        if not (0 <= x0 and 0 <= y0 and x0 + w <= px.size_x
                and y0 + h <= px.size_y and w > 0 and h > 0):
            raise ValueError(f"region {region.as_tuple()} out of bounds")
        if out is None:
            out = np.empty((h, w), self._dtype)
        base = self._plane_offset(z, c, t)
        item = self._dtype.itemsize
        if w == px.size_x:
            # Full-width rows are one contiguous span.
            rows = self._pread(h * w * item, base + y0 * w * item)
            out[...] = rows.reshape(h, w)
        else:
            for i in range(h):
                out[i] = self._pread(
                    w * item, base + ((y0 + i) * px.size_x + x0) * item)
        return out

    def get_stack(self, c: int, t: int) -> np.ndarray:
        px = self._px
        out = np.empty((px.size_z, px.size_y, px.size_x), self._dtype)
        region = RegionDef(0, 0, px.size_x, px.size_y)
        for z in range(px.size_z):
            self.get_region(z, c, t, region, 0, out=out[z])
        return out

    def close(self) -> None:
        self._f.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self._f.close()
        except Exception:
            pass
