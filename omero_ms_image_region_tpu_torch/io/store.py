"""On-disk chunked multi-resolution pixel store.

Stands in for the OMERO binary repository + Bio-Formats pyramid that back the
reference's ``PixelsService.getPixelBuffer`` (``ImageRegionRequestHandler
.java:302-309``).  No external formats (zarr/tifffile are not in the image),
so the layout is deliberately minimal and read-optimized:

  <root>/
    meta.json             image geometry + dtype + chunk + level table
    level_{n}.dat         all chunks of level n, row-major chunk grid per
                          plane, planes ordered [t][c][z]; every chunk is
                          padded to the full (chunk_h, chunk_w) so offsets
                          are a closed form and a tile read is 1..4
                          contiguous preads.

Chunks are padded with zeros; readers slice the valid interior using the
level dimensions.  This is the same trade zarr makes (fixed chunk grid,
edge padding) and keeps the door open for an O_DIRECT / C++ pread pool.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from ..server.region import RegionDef

_META = "meta.json"


class ChunkedPyramidStore:
    """PixelSource over the on-disk chunked pyramid layout."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, _META)) as f:
            self.meta = json.load(f)
        m = self.meta
        self._dtype = np.dtype(m["dtype"])
        self.size_z = m["size_z"]
        self.size_c = m["size_c"]
        self.size_t = m["size_t"]
        self.chunk_h = m["chunk_h"]
        self.chunk_w = m["chunk_w"]
        self._level_dims: List[Tuple[int, int]] = [
            (lv["size_x"], lv["size_y"]) for lv in m["levels"]
        ]
        self._maps: List[Optional[np.memmap]] = [None] * len(self._level_dims)

    # -- geometry -----------------------------------------------------------

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def resolution_levels(self) -> int:
        return len(self._level_dims)

    def resolution_descriptions(self) -> List[Tuple[int, int]]:
        return list(self._level_dims)

    def tile_size(self) -> Tuple[int, int]:
        return (self.chunk_w, self.chunk_h)

    def _grid(self, level: int) -> Tuple[int, int]:
        sx, sy = self._level_dims[level]
        return (-(-sy // self.chunk_h), -(-sx // self.chunk_w))  # (gy, gx)

    def _map_level(self, level: int) -> np.memmap:
        mm = self._maps[level]
        if mm is None:
            gy, gx = self._grid(level)
            shape = (self.size_t, self.size_c, self.size_z, gy, gx,
                     self.chunk_h, self.chunk_w)
            mm = np.memmap(
                os.path.join(self.root, f"level_{level}.dat"),
                dtype=self._dtype, mode="r", shape=shape,
            )
            self._maps[level] = mm
        return mm

    # -- reads --------------------------------------------------------------

    def get_region(self, z: int, c: int, t: int, region: RegionDef,
                   level: int = 0, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        sx, sy = self._level_dims[level]
        x0, y0 = region.x, region.y
        x1, y1 = x0 + region.width, y0 + region.height
        if not (0 <= x0 <= x1 <= sx and 0 <= y0 <= y1 <= sy):
            raise ValueError(
                f"region {region.as_tuple()} outside level {level} "
                f"bounds ({sx}x{sy})"
            )
        mm = self._map_level(level)
        if out is None:
            out = np.empty((region.height, region.width), dtype=self._dtype)
        ch, cw = self.chunk_h, self.chunk_w
        for gy in range(y0 // ch, -(-y1 // ch)):
            for gx in range(x0 // cw, -(-x1 // cw)):
                cy0, cx0 = gy * ch, gx * cw
                ix0, ix1 = max(x0, cx0), min(x1, cx0 + cw)
                iy0, iy1 = max(y0, cy0), min(y1, cy0 + ch)
                if ix0 >= ix1 or iy0 >= iy1:
                    continue
                chunk = mm[t, c, z, gy, gx]
                out[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = \
                    chunk[iy0 - cy0:iy1 - cy0, ix0 - cx0:ix1 - cx0]
        return out

    def get_stack(self, c: int, t: int) -> np.ndarray:
        sx, sy = self._level_dims[0]
        region = RegionDef(0, 0, sx, sy)
        out = np.empty((self.size_z, sy, sx), dtype=self._dtype)
        for z in range(self.size_z):
            self.get_region(z, c, t, region, 0, out=out[z])
        return out

    def close(self) -> None:
        self._maps = [None] * len(self._level_dims)


def _downsample2(plane: np.ndarray) -> np.ndarray:
    """Mean-pool by 2 (the usual pyramid reduction)."""
    h, w = plane.shape[0] // 2, plane.shape[1] // 2
    if h < 1 or w < 1:
        return plane[:1, :1]
    v = plane[: h * 2, : w * 2].astype(np.float64)
    v = v.reshape(h, 2, w, 2).mean(axis=(1, 3))
    if np.issubdtype(plane.dtype, np.integer):
        v = np.round(v)
    return v.astype(plane.dtype)


def build_pyramid(
    planes: np.ndarray,
    root: str,
    chunk: Tuple[int, int] = (256, 256),
    n_levels: Optional[int] = None,
    min_level_size: int = 256,
) -> ChunkedPyramidStore:
    """Write a [C, Z, H, W] (or [T, C, Z, H, W]) array as a chunked pyramid.

    ``n_levels=None`` halves until min(w, h) < min_level_size (the
    Bio-Formats-style pyramid the reference serves via resolution levels).
    """
    if planes.ndim == 4:
        planes = planes[None]
    if planes.ndim != 5:
        raise ValueError("planes must be [T, C, Z, H, W] or [C, Z, H, W]")
    T, C, Z, H, W = planes.shape
    ch, cw = chunk[1], chunk[0]

    levels = [planes]
    while True:
        if n_levels is not None and len(levels) >= n_levels:
            break
        _, _, _, h, w = levels[-1].shape
        if n_levels is None and min(h // 2, w // 2) < min_level_size:
            break
        if min(h // 2, w // 2) < 1:
            break
        prev = levels[-1]
        ds = np.stack([
            np.stack([
                np.stack([_downsample2(prev[t, c, z])
                          for z in range(Z)])
                for c in range(C)
            ])
            for t in range(T)
        ])
        levels.append(ds)

    os.makedirs(root, exist_ok=True)
    meta = {
        "version": 1,
        "dtype": planes.dtype.name,
        "size_z": Z, "size_c": C, "size_t": T,
        "chunk_h": ch, "chunk_w": cw,
        "levels": [
            {"size_x": lv.shape[-1], "size_y": lv.shape[-2]}
            for lv in levels
        ],
    }
    with open(os.path.join(root, _META), "w") as f:
        json.dump(meta, f)

    for n, lv in enumerate(levels):
        h, w = lv.shape[-2:]
        gy, gx = -(-h // ch), -(-w // cw)
        mm = np.memmap(
            os.path.join(root, f"level_{n}.dat"), dtype=planes.dtype,
            mode="w+", shape=(T, C, Z, gy, gx, ch, cw),
        )
        mm[:] = 0
        for t in range(T):
            for c in range(C):
                for z in range(Z):
                    for y in range(gy):
                        for x in range(gx):
                            part = lv[t, c, z, y * ch:(y + 1) * ch,
                                      x * cw:(x + 1) * cw]
                            mm[t, c, z, y, x, : part.shape[0],
                               : part.shape[1]] = part
        mm.flush()
        del mm
    return ChunkedPyramidStore(root)
