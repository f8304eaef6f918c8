"""The ``PixelSource`` protocol (≙ ``ome.io.nio.PixelBuffer``).

The surface the region pipeline consumes from its pixel buffer
(SURVEY.md section 2b): region reads at a resolution level, whole-stack
reads, pyramid level/size enumeration, and the server tile size.  The
readers are ``store.ChunkedPyramidStore``, ``ometiff.OmeTiffSource``,
``ngff.NgffZarrSource`` and ``memory.InMemoryPixelSource``; unlike the
JAX package's, each region read can fill a caller's array (``out=``).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from ..server.region import RegionDef


@runtime_checkable
class PixelSource(Protocol):
    """Raw pixel reader for one image (5D XYZCT, with an XY pyramid)."""

    @property
    def dtype(self) -> np.dtype:
        ...

    def resolution_levels(self) -> int:
        """Number of pyramid levels (1 = not a pyramid)
        (≙ ``PixelBuffer.getResolutionLevels``,
        call site ``ImageRegionRequestHandler.java:446``)."""
        ...

    def resolution_descriptions(self) -> List[Tuple[int, int]]:
        """[(size_x, size_y)] per level, largest first
        (≙ ``getResolutionDescriptions``, ``:447-449``)."""
        ...

    def tile_size(self) -> Tuple[int, int]:
        """(width, height) of the server-preferred tile
        (≙ ``getTileSize``, ``:797``)."""
        ...

    def get_region(self, z: int, c: int, t: int, region: RegionDef,
                   level: int = 0, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        """Read a rectangular region of one plane at a pyramid level.

        Region coordinates are in the level's pixel space; the caller is
        responsible for truncation to level bounds (the reference truncates
        in ``getRegionDef``, ``:751-758``).  Returns [h, w] in the source
        dtype, or writes into ``out`` (an [h, w] array, cast to its dtype)
        and returns it.
        """
        ...

    def get_stack(self, c: int, t: int) -> np.ndarray:
        """Whole Z-stack of one channel at level 0: [Z, H, W]
        (≙ ``PixelBuffer.getStack``, ``ProjectionService.java:72``)."""
        ...

    def close(self) -> None:
        ...
