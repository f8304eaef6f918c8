"""Region / pyramid geometry.

Pure-function re-expression of the region math in
``ImageRegionRequestHandler.java``: region selection (``getRegionDef``
``:789-832``), bounds truncation (``truncateRegionDef`` ``:751-758``),
pre-flip mirroring (``flipRegionDef`` ``:770-780``), plane-bounds clamping
(``checkPlaneDef`` ``:651-681``), and OMERO resolution-order inversion
(``setResolutionLevel`` ``:840-853``).

These are host-side and shape-producing: they decide exactly which raw
rectangle the IO layer reads and which padded bucket the device kernel
receives, so they stay in Python and stay pure (the reference's own tests
test them the same way; SURVEY.md section 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass
class RegionDef:
    """A rectangular region (= omeis.providers.re.data.RegionDef)."""

    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0

    def as_tuple(self) -> Tuple[int, int, int, int]:
        return (self.x, self.y, self.width, self.height)


def truncate_region(size_x: int, size_y: int, region: RegionDef) -> RegionDef:
    """Clamp width/height so the region fits the image
    (= truncateRegionDef, ``:751-758``)."""
    region.width = min(region.width, size_x - region.x)
    region.height = min(region.height, size_y - region.y)
    return region


def flip_region(size_x: int, size_y: int, region: RegionDef,
                flip_horizontal: bool, flip_vertical: bool) -> RegionDef:
    """Mirror the region origin for flipped rendering so the flipped output
    of the mirrored read equals the straight read of the requested region
    (= flipRegionDef, ``:770-780``)."""
    if flip_horizontal:
        region.x = size_x - region.width - region.x
    if flip_vertical:
        region.y = size_y - region.height - region.y
    return region


def clamp_region_to_plane(resolution_levels: Sequence[Sequence[int]],
                          resolution: Optional[int],
                          region: Optional[RegionDef]) -> Optional[RegionDef]:
    """Reset out-of-bounds width/height against the selected resolution's
    plane size (= checkPlaneDef, ``:651-681``)."""
    if region is None:
        return None
    res = resolution or 0
    size_x, size_y = resolution_levels[res][0], resolution_levels[res][1]
    if region.width + region.x > size_x:
        region.width = size_x - region.x
    if region.height + region.y > size_y:
        region.height = size_y - region.y
    return region


def get_region_def(
    resolution_levels: Sequence[Sequence[int]],
    resolution: Optional[int],
    tile: Optional[RegionDef],
    region: Optional[RegionDef],
    image_tile_size: Tuple[int, int],
    max_tile_length: int,
    flip_horizontal: bool = False,
    flip_vertical: bool = False,
) -> RegionDef:
    """Resolve the pixel region to read (= getRegionDef, ``:789-832``).

    Tile requests use the tile's own width/height if given, else the
    image's native tile size, clamped to ``max_tile_length``; the offset is
    in tile units.  Region requests are pixel-space.  Neither => the whole
    plane at the selected resolution (returned WITHOUT truncate/flip, as in
    the reference's early return ``:822-827``).
    """
    res = resolution or 0
    size_x, size_y = resolution_levels[res][0], resolution_levels[res][1]
    out = RegionDef()
    if tile is not None:
        tile_w, tile_h = tile.width, tile.height
        if tile_w == 0:
            tile_w = image_tile_size[0]
        if tile_w > max_tile_length:
            tile_w = max_tile_length
        if tile_h == 0:
            tile_h = image_tile_size[1]
        if tile_h > max_tile_length:
            tile_h = max_tile_length
        out.width = tile_w
        out.height = tile_h
        out.x = tile.x * tile_w
        out.y = tile.y * tile_h
    elif region is not None:
        out.x, out.y = region.x, region.y
        out.width, out.height = region.width, region.height
    else:
        out.x, out.y = 0, 0
        out.width, out.height = size_x, size_y
        return out
    truncate_region(size_x, size_y, out)
    flip_region(size_x, size_y, out, flip_horizontal, flip_vertical)
    return out


# NOTE: the reference's setResolutionLevel inversion (``level = n - res - 1``,
# ``:845-852``) is deliberately NOT reproduced here: it converts between the
# largest-first descriptions order and OMERO's smallest-first PixelBuffer
# level order.  Our PixelSource numbers levels largest-first like the
# descriptions, so the request resolution IS the read level (see
# ImageRegionHandler._get_region).


def plan_region(resolution_levels: Sequence[Sequence[int]],
                resolution: Optional[int], tile: Optional[RegionDef],
                region: Optional[RegionDef],
                image_tile_size: Tuple[int, int], max_tile_length: int,
                flip_horizontal: bool = False,
                flip_vertical: bool = False) -> Tuple[RegionDef, int]:
    """The raw rectangle a request reads and the level it reads it at:
    :func:`get_region_def` clamped to the plane (:func:`clamp_region_to_
    plane`), and the request resolution, which indexes the largest-first
    level list directly.  One construction site for the handler's read
    and the prefetcher's predicted reads, so a predicted tile's raw-cache
    key is the key its request computes.  An empty region (width or
    height <= 0) lies outside the plane."""
    out = get_region_def(resolution_levels, resolution, tile, region,
                         image_tile_size, max_tile_length, flip_horizontal,
                         flip_vertical)
    clamp_region_to_plane(resolution_levels, resolution, out)
    return out, resolution or 0
