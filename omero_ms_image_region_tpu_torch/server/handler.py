"""Request orchestration: parsed ctx -> encoded image bytes.

The analogue of ``ImageRegionRequestHandler.java`` (metadata fetch
``:316-427``, region pipeline ``:429-604``) with the device part behind a
:class:`Renderer`.  The pipeline, in order:

  ACL (before anything is served) -> z/t/resolution bounds -> region ->
  raw read -> settings (``update_settings``, restricted to the active
  channels) -> render on the device -> flip -> unpack -> encode.

Not here yet: the byte cache, single-flight, admission, the device raw
cache and the prefetcher; a projection request (``p=``) is refused with a
400.

``format=jpeg`` follows the JAX handler's two routes.  A region above
``ImageRegionServices.jpeg_host_max_px`` pixels takes the device route,
:meth:`Renderer.render_jpeg`: render, JPEG front end and sparse wire on the
card, the native entropy coder on the host.  A region at or below it is
rendered on the card and its RGBA encoded with ``codecs.encode_rgba``
(PIL), the bytes of the JAX handler's tiny-region path.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from .. import codecs
from ..models.rendering import default_rendering_def, restrict_to_active
from ..ops import jpegenc
from ..ops.flip import flip_image
from ..ops.render import (batched_settings, pack_settings, raw_to_tensor,
                          render_tile_batch_packed, resolve_device,
                          settings_to_tensors, unpack_rgba)
from .ctx import ImageRegionCtx
from .errors import BadRequestError, NotFoundError
from .region import RegionDef, clamp_region_to_plane, get_region_def
from .settings import update_settings

DEFAULT_MAX_TILE_LENGTH = 2048  # beanRefContext.xml:63-66
# JPEG regions of at most this many pixels are rendered on the device and
# encoded with PIL, the bytes of the JAX handler's tiny-region path (its
# cpu_fallback_max_px default); larger ones take the device JPEG route.
JPEG_HOST_MAX_PX = 256 * 256


class Renderer:
    """Direct device render: one kernel launch per request.

    Owns its device: raw planes and settings are copied there, the render
    kernel and the flip run there, and only the packed tile comes back.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)

    async def render(self, raw: np.ndarray, settings: dict,
                     flip_horizontal: bool = False,
                     flip_vertical: bool = False) -> np.ndarray:
        """[C, H, W] raw + packed settings -> u32[H, W] packed RGBA."""
        return await asyncio.to_thread(self.render_sync, raw, settings,
                                       flip_horizontal, flip_vertical)

    def render_sync(self, raw: np.ndarray, settings: dict,
                    flip_horizontal: bool = False,
                    flip_vertical: bool = False) -> np.ndarray:
        raw_t = raw_to_tensor(raw, self.device)[None]
        tensors = settings_to_tensors(settings, self.device)
        packed = render_tile_batch_packed(raw_t, *batched_settings(tensors))
        packed = flip_image(packed[0], flip_horizontal, flip_vertical)
        return packed.cpu().numpy().view(np.uint32)

    async def render_jpeg(self, raw: np.ndarray, settings: dict,
                          quality: int, width: int, height: int,
                          flip_horizontal: bool = False,
                          flip_vertical: bool = False) -> bytes:
        """[C, h, w] raw + packed settings -> JFIF bytes of the (flipped)
        tile, ``width`` x ``height`` in its SOF0 header."""
        return await asyncio.to_thread(
            self.render_jpeg_sync, raw, settings, quality, width, height,
            flip_horizontal, flip_vertical)

    def render_jpeg_sync(self, raw: np.ndarray, settings: dict,
                         quality: int, width: int, height: int,
                         flip_horizontal: bool = False,
                         flip_vertical: bool = False) -> bytes:
        """The device JPEG route for one tile: raw to the device, the
        render (K1/K2, B=1), the coefficient front end over the tile's
        ceil-16 frame with the flips and the edge replication folded into
        its reads (K3), the sparse wire and its compaction (K4a, K4b);
        the compacted wire's used bytes back; the native entropy coder."""
        raw_t = raw_to_tensor(raw, self.device)[None]
        tensors = settings_to_tensors(settings, self.device)
        packed = render_tile_batch_packed(raw_t, *batched_settings(tensors))
        h, w = packed.shape[-2:]
        H, W = h + (-h) % 16, w + (-w) % 16
        y, cb, cr = jpegenc.packed_to_jpeg_coefficients(
            packed, quality, H, W, flip_horizontal, flip_vertical)
        return jpegenc.coefficients_to_jpegs(
            y, cb, cr, H, W, quality, [(width, height)])[0]


@dataclass
class ImageRegionServices:
    """Everything a handler needs, injected once at startup (the analogue of
    the Spring wiring, ``beanRefContext.xml:68-79``)."""

    pixels_service: object            # io.service.PixelsService
    metadata: object                  # services.metadata.LocalMetadataService
    renderer: Renderer
    lut_provider: object = None       # ops.lut.LutProvider
    max_tile_length: int = DEFAULT_MAX_TILE_LENGTH
    # 0 sends every JPEG region down the device route.
    jpeg_host_max_px: int = JPEG_HOST_MAX_PX


class ImageRegionHandler:
    """One instance per service; per-request state stays on the stack."""

    def __init__(self, services: ImageRegionServices):
        self.s = services

    async def render_image_region(self, ctx: ImageRegionCtx) -> bytes:
        """``render_image_region`` / ``render_image``: the encoded bytes."""
        raw, settings = await self.read(ctx)
        h, w = raw.shape[-2:]
        if ctx.format == "jpeg" and h * w > self.s.jpeg_host_max_px:
            quality = codecs.quality_percent(ctx.compression_quality)
            return await self.s.renderer.render_jpeg(
                raw, settings, quality, w, h, ctx.flip_horizontal,
                ctx.flip_vertical)
        packed = await self.s.renderer.render(
            raw, settings, ctx.flip_horizontal, ctx.flip_vertical)
        return await asyncio.to_thread(self.encode, unpack_rgba(packed),
                                       ctx)

    async def read(self, ctx: ImageRegionCtx) -> Tuple[np.ndarray, dict]:
        """ACL, bounds and region resolution, then the raw read.

        Returns the active channels' raw planes [C_active, h, w] in the
        storage dtype (mirrored where the request flips, as the reference
        reads) and their packed render settings.
        """
        pixels = await self.s.metadata.get_pixels_description(
            ctx.image_id, ctx.omero_session_key)
        if pixels is None or not await self.s.metadata.can_read(
                "Image", ctx.image_id, ctx.omero_session_key):
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        if ctx.z < 0 or ctx.z >= pixels.size_z:
            raise BadRequestError(
                f"Parameter 'theZ' not within bounds: {ctx.z}")
        if ctx.t < 0 or ctx.t >= pixels.size_t:
            raise BadRequestError(
                f"Parameter 'theT' not within bounds: {ctx.t}")
        if ctx.projection is not None:
            # Refused rather than rendered as a single plane.
            raise BadRequestError("Projection (p=) is not served yet")

        src = await asyncio.to_thread(self.s.pixels_service.get_pixel_source,
                                      ctx.image_id)
        if src.resolution_levels() > 1:
            levels: Sequence[Sequence[int]] = [
                list(d) for d in src.resolution_descriptions()]
        else:
            levels = [[pixels.size_x, pixels.size_y]]
        if ctx.resolution is not None and not (
                0 <= ctx.resolution < len(levels)):
            raise BadRequestError(
                f"Resolution {ctx.resolution} not within [0, {len(levels)})")

        region = get_region_def(
            levels, ctx.resolution, ctx.tile, ctx.region, src.tile_size(),
            self.s.max_tile_length, ctx.flip_horizontal, ctx.flip_vertical,
        )
        # The request resolution indexes the largest-first level list
        # directly; the store numbers levels largest-first too.
        level = ctx.resolution or 0
        clamp_region_to_plane(levels, ctx.resolution, region)
        if region.width <= 0 or region.height <= 0:
            raise BadRequestError(
                f"Region {region.as_tuple()} outside image bounds")

        rdef = update_settings(default_rendering_def(pixels), ctx)
        active_rdef, active = restrict_to_active(rdef)
        if not active:
            raise BadRequestError("No active channels to render")
        raw = await asyncio.to_thread(self._read_region, src, ctx, region,
                                      level, active)
        return raw, pack_settings(active_rdef, self.s.lut_provider)

    @staticmethod
    def _read_region(src, ctx: ImageRegionCtx, region: RegionDef,
                     level: int, active: List[int]) -> np.ndarray:
        # Storage dtype: the kernels widen on the device, so uint16
        # sources move half the bytes of a float32 copy.
        return np.stack([src.get_region(ctx.z, c, ctx.t, region, level)
                         for c in active])

    @staticmethod
    def encode(rgba: np.ndarray, ctx: ImageRegionCtx) -> bytes:
        """Format dispatch; an unknown format is a 404."""
        try:
            return codecs.encode_rgba(rgba, ctx.format,
                                      ctx.compression_quality)
        except codecs.UnknownFormatError as e:
            raise NotFoundError(str(e))
