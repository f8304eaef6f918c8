"""In-memory pixel source (≙ ``ome.io.nio.InMemoryPlanarPixelBuffer``,
consumed at ``ImageRegionRequestHandler.java:554-555`` to re-render projected
planes, and the natural fake backend for tests): the port's copy of the JAX
package's ``io/memory.py``, with ``get_region(..., out=)``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..server.region import RegionDef


class InMemoryPixelSource:
    """PixelSource over a [C, Z, H, W] (or [Z, C, H, W]-free) ndarray.

    Optionally carries a synthesized downsampled pyramid (mean-pool by 2)
    so pyramid logic is testable without disk.
    """

    def __init__(self, planes: np.ndarray, tile: Tuple[int, int] = (256, 256),
                 pyramid_levels: int = 1):
        if planes.ndim != 4:
            raise ValueError("planes must be [C, Z, H, W]")
        self._levels = [planes]
        for _ in range(1, pyramid_levels):
            prev = self._levels[-1]
            h, w = prev.shape[-2] // 2, prev.shape[-1] // 2
            if h < 1 or w < 1:
                break
            ds = prev[..., : h * 2, : w * 2].reshape(
                prev.shape[0], prev.shape[1], h, 2, w, 2
            ).astype(np.float64).mean(axis=(3, 5))
            if np.issubdtype(planes.dtype, np.integer):
                ds = np.round(ds)
            self._levels.append(ds.astype(planes.dtype))
        self._tile = tile
        self.closed = False

    @property
    def dtype(self) -> np.dtype:
        return self._levels[0].dtype

    def resolution_levels(self) -> int:
        return len(self._levels)

    def resolution_descriptions(self) -> List[Tuple[int, int]]:
        return [(lv.shape[-1], lv.shape[-2]) for lv in self._levels]

    def tile_size(self) -> Tuple[int, int]:
        return self._tile

    def get_region(self, z: int, c: int, t: int, region: RegionDef,
                   level: int = 0, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        view = self._levels[level][c, z, region.y:region.y + region.height,
                                   region.x:region.x + region.width]
        if out is None:
            return np.array(view)
        out[...] = view
        return out

    def get_stack(self, c: int, t: int) -> np.ndarray:
        return np.array(self._levels[0][c])

    def close(self) -> None:
        self.closed = True
