"""Degraded mode: the sidecar is down, tiles still serve from the CPU.

Counterpart of the JAX package's ``server/degraded.py``.  While the render
sidecar is unreachable (the connection died through every retry, or the
circuit breaker is open), a frontend with ``fault-tolerance.degraded-mode``
renders on its own CPU through the numpy reference renderer
(``refimpl``), so a viewer keeps panning at a lower rate.  Off by default
(it needs the data directory on the frontend's host); with it off a dead
sidecar answers 503.  Each degraded answer is counted
(``imageregion_degraded_renders_total``) and marked: its provenance tier is
``degraded`` (``server.sidecar.SidecarImageHandler``).

Host-only: nothing here touches the card, so a frontend with the fallback
armed still never initialises CUDA.  The bytes are the JAX frontend's
degraded bytes for the same request.  Projections are refused (503 with
``Retry-After``): a whole-plane projection on the frontend's CPU would
starve its event loop's other degraded renders.
"""

from __future__ import annotations

import asyncio
from typing import Sequence

import numpy as np

from .. import codecs
from ..models.pixels import Pixels
from ..utils.color import split_html_color
from ..utils.transient import check_deadline
from .ctx import ImageRegionCtx, ShapeMaskCtx
from .errors import BadRequestError, NotFoundError, OverloadedError
from .region import clamp_region_to_plane, get_region_def
from .settings import update_settings


class DegradedCpuHandler:
    """The sidecar handlers' call surface and exception contract, on the
    host."""

    def __init__(self, config):
        from ..io.service import PixelsService
        from ..ops.lut import LutProvider
        from ..services.metadata import LocalMetadataService

        self.pixels_service = PixelsService(
            config.data_dir, repo_root=config.omero_data_dir)
        self.metadata = LocalMetadataService(config.data_dir)
        self.lut_provider = LutProvider(config.lut_root)
        self.max_tile_length = config.max_tile_length

    async def render_image_region(self, ctx: ImageRegionCtx) -> bytes:
        if ctx.projection is not None:
            raise OverloadedError(
                "projections are unavailable in degraded mode "
                "(device backend down)", retry_after_s=5.0)
        pixels = await self.metadata.get_pixels_description(
            ctx.image_id, ctx.omero_session_key)
        if pixels is None or not await self.metadata.can_read(
                "Image", ctx.image_id, ctx.omero_session_key):
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        check_deadline("degraded render")
        return await asyncio.to_thread(self._render_sync, ctx, pixels)

    def _render_sync(self, ctx: ImageRegionCtx, pixels: Pixels) -> bytes:
        from ..models.rendering import (default_rendering_def,
                                        restrict_to_active)
        from ..refimpl import render_ref

        if ctx.z < 0 or ctx.z >= pixels.size_z:
            raise BadRequestError(
                f"Parameter 'theZ' not within bounds: {ctx.z}")
        if ctx.t < 0 or ctx.t >= pixels.size_t:
            raise BadRequestError(
                f"Parameter 'theT' not within bounds: {ctx.t}")
        src = self.pixels_service.get_pixel_source(ctx.image_id)
        if src.resolution_levels() > 1:
            levels: Sequence[Sequence[int]] = [
                list(d) for d in src.resolution_descriptions()]
        else:
            levels = [[pixels.size_x, pixels.size_y]]
        if ctx.resolution is not None and not (
                0 <= ctx.resolution < len(levels)):
            raise BadRequestError(
                f"Resolution {ctx.resolution} not within "
                f"[0, {len(levels)})")
        region = get_region_def(
            levels, ctx.resolution, ctx.tile, ctx.region, src.tile_size(),
            self.max_tile_length, ctx.flip_horizontal, ctx.flip_vertical)
        level = ctx.resolution or 0
        clamp_region_to_plane(levels, ctx.resolution, region)
        if region.width <= 0 or region.height <= 0:
            raise BadRequestError(
                f"Region {region.as_tuple()} outside image bounds")
        rdef = update_settings(default_rendering_def(pixels), ctx)
        rdef, active = restrict_to_active(rdef)
        if not active:
            raise BadRequestError("No active channels to render")
        raw = np.stack([src.get_region(ctx.z, c, ctx.t, region, level)
                        for c in active]).astype(np.float32)
        # The render is pointwise: the flips fold into the raw planes.
        if ctx.flip_vertical:
            raw = raw[:, ::-1, :]
        if ctx.flip_horizontal:
            raw = raw[:, :, ::-1]
        rgba = render_ref(raw, rdef, self.lut_provider)
        try:
            return codecs.encode_rgba(np.ascontiguousarray(rgba), ctx.format,
                                      ctx.compression_quality)
        except codecs.UnknownFormatError as e:
            raise NotFoundError(str(e))

    async def render_shape_mask(self, ctx: ShapeMaskCtx) -> bytes:
        if not await self.metadata.can_read(
                "Mask", ctx.shape_id, ctx.omero_session_key):
            raise NotFoundError(f"Cannot find Shape:{ctx.shape_id}")
        mask = await self.metadata.get_mask(ctx.shape_id,
                                            ctx.omero_session_key)
        if mask is None:
            raise NotFoundError(f"Cannot find Shape:{ctx.shape_id}")
        color = None
        if ctx.color is not None:
            color = split_html_color(ctx.color)
            if color is None:
                raise BadRequestError(f"Invalid color '{ctx.color}'")
        return await asyncio.to_thread(self._render_mask_sync, mask, color,
                                       ctx)

    @staticmethod
    def _render_mask_sync(mask, color, ctx: ShapeMaskCtx) -> bytes:
        from ..ops.maskops import rasterize_mask
        grid, palette = rasterize_mask(mask, color, ctx.flip_horizontal,
                                       ctx.flip_vertical)
        return codecs.encode_mask_png(grid, tuple(palette[1]))
