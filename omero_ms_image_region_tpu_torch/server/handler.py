"""Request orchestration: parsed ctx -> encoded image bytes.

The analogue of ``ImageRegionRequestHandler.java`` (metadata fetch
``:316-427``, region pipeline ``:429-604``) and of the JAX package's
``server/handler.py`` (``render_image_region`` ``:332-458``,
``_get_region`` ``:509-624``) with the device part behind a renderer: the
batching renderer (``server.batcher``) in the default app, or the direct
:class:`Renderer`.  The pipeline, in order:

  ACL (per caller) -> single-flight (concurrent identical requests share
  one run) -> z/t/resolution bounds -> region -> settings
  (``update_settings``, restricted to the active channels) -> raw planes
  (the device raw cache on the event loop; on a miss, a read into a pinned
  buffer and one copy to the card in a worker thread) -> render on the
  device, flips included -> encode.

``format=jpeg`` follows the JAX handler's two routes.  A region above
``ImageRegionServices.jpeg_host_max_px`` pixels takes the device route,
``render_jpeg``: render, JPEG front end and sparse wire on the card, the
native entropy coder on the host.  A region at or below it is rendered on
the card and its RGBA encoded with ``codecs.encode_rgba`` (PIL), the bytes
of the JAX handler's tiny-region path.  Both renderers take the flips: the
batcher mirrors each tile's raw before padding it to its bucket (as the
JAX handler folds its flips into the raw), the direct renderer folds them
into K3's reads or flips the packed tile.

Admission (``server.admission``) sits inside the single-flight producer,
as in the JAX handler: a coalesced follower claims no slot.  The stages
are timed under the JAX package's span names (``utils.stopwatch``):
``get_pixels_description``, ``canRead``, ``PixelsService.getPixelBuffer``,
``PixelsService.readRegion`` (a raw-cache miss's read and copy),
``Renderer.renderAsPackedInt`` (the await of the renderer) and
``encodeImage`` (PIL); a follower's await is a ``dedup.coalesced`` span on
its trace.

Not here yet: the byte cache and the prefetcher; a projection request
(``p=``) is refused with a 400.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import codecs
from ..io.devicecache import region_key
from ..io.staging import HostPlanes, stage
from ..models.pixels import Pixels
from ..models.rendering import default_rendering_def, restrict_to_active
from ..ops import jpegenc
from ..ops.flip import flip_image
from ..ops.render import (batched_settings, pack_settings,
                          render_tile_batch_packed, resolve_device,
                          settings_to_tensors, unpack_rgba)
from ..utils import telemetry, transient
from ..utils.stopwatch import stopwatch
from .ctx import ImageRegionCtx
from .errors import BadRequestError, NotFoundError
from .region import RegionDef, clamp_region_to_plane, get_region_def
from .settings import render_identity_key, update_settings

DEFAULT_MAX_TILE_LENGTH = 2048  # beanRefContext.xml:63-66
# JPEG regions of at most this many pixels are rendered on the device and
# encoded with PIL, the bytes of the JAX handler's tiny-region path (its
# cpu_fallback_max_px default); larger ones take the device JPEG route.
JPEG_HOST_MAX_PX = 256 * 256


class Renderer:
    """Direct device render: one B=1 launch of each kernel per request.

    Owns its device: host planes are staged there through a pinned
    buffer, the kernels and the flip run there, and only the packed tile
    or the compacted wire comes back.  The reference handler of
    ``server.app.build_handler(batcher=False)``, which has no raw cache.
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
        raw_t = stage(raw, self.device)[None]
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
        raw_t = stage(raw, self.device)[None]
        tensors = settings_to_tensors(settings, self.device)
        packed = render_tile_batch_packed(raw_t, *batched_settings(tensors))
        h, w = packed.shape[-2:]
        H, W = h + (-h) % 16, w + (-w) % 16
        y, cb, cr = jpegenc.packed_to_jpeg_coefficients(
            packed, quality, H, W, flip_horizontal, flip_vertical)
        return jpegenc.coefficients_to_jpegs(
            y, cb, cr, H, W, quality, [(width, height)])[0]

    async def close(self) -> None:
        """Nothing to release (the batcher's counterpart stops its
        dispatchers)."""


@dataclass
class ImageRegionServices:
    """Everything a handler needs, injected once at startup (the analogue of
    the Spring wiring, ``beanRefContext.xml:68-79``)."""

    pixels_service: object            # io.service.PixelsService
    metadata: object                  # services.metadata.LocalMetadataService
    renderer: object                  # Renderer or batcher.BatchingRenderer
    lut_provider: object = None       # ops.lut.LutProvider
    max_tile_length: int = DEFAULT_MAX_TILE_LENGTH
    # 0 sends every JPEG region down the device route.
    jpeg_host_max_px: int = JPEG_HOST_MAX_PX
    raw_cache: object = None          # io.devicecache.DeviceRawCache
    # In-flight render dedup (singleflight.SingleFlight); None disables
    # coalescing.
    single_flight: object = None
    admission: object = None          # admission.AdmissionController


@dataclass
class _Plan:
    """A request resolved against its image: where to read and how to
    render."""

    src: object                       # io.pixelsource.PixelSource
    region: RegionDef
    level: int
    active: List[int]
    settings: dict


class ImageRegionHandler:
    """One instance per service; per-request state stays on the stack."""

    def __init__(self, services: ImageRegionServices):
        self.s = services

    async def render_image_region(self, ctx: ImageRegionCtx) -> bytes:
        """``render_image_region`` / ``render_image``: the encoded bytes.

        ACL runs per caller; concurrent identical requests then share one
        pipeline run (single-flight).  Without single-flight the await is
        still bounded by the request's deadline: a group whose members'
        budgets died after it was popped may still be running, and the
        caller gets its ``DeadlineExceededError`` at budget end.
        """
        t0 = time.perf_counter()
        pixels = await self._authorize(ctx)
        admission = self.s.admission

        async def produce() -> bytes:
            t_admit = admission.admit() if admission is not None else None
            completed = False
            try:
                transient.check_deadline("render pipeline")
                data = await self._get_region(ctx, pixels)
                completed = True
            finally:
                if admission is not None:
                    admission.release(t_admit, completed=completed)
            return data

        if self.s.single_flight is None:
            remaining = transient.remaining_ms()
            if remaining is None:
                return await produce()
            try:
                return await asyncio.wait_for(
                    produce(), timeout=max(0.0, remaining) / 1000.0)
            except asyncio.TimeoutError:
                raise transient.DeadlineExceededError(
                    "deadline exceeded awaiting render")
        data, coalesced = await self.s.single_flight.run(
            render_identity_key(ctx), produce)
        if coalesced:
            telemetry.record_span("dedup.coalesced", t0,
                                  (time.perf_counter() - t0) * 1000.0)
        return data

    async def read(self, ctx: ImageRegionCtx) -> Tuple[np.ndarray, dict]:
        """ACL, bounds and region resolution, then a host read that
        bypasses the raw cache.

        Returns the active channels' raw planes [C_active, h, w] in the
        storage dtype and their packed render settings.
        """
        plan = await self._plan(ctx, await self._authorize(ctx))
        raw = await asyncio.to_thread(self._read_planes, plan, ctx)
        return raw, plan.settings

    async def _authorize(self, ctx: ImageRegionCtx) -> Pixels:
        with stopwatch("get_pixels_description"):
            pixels = await self.s.metadata.get_pixels_description(
                ctx.image_id, ctx.omero_session_key)
        if pixels is None or not await self.can_read(
                ctx.image_id, ctx.omero_session_key):
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        return pixels

    async def can_read(self, image_id: int,
                       session_key: Optional[str]) -> bool:
        """The read ACL of an image for a caller."""
        with stopwatch("canRead"):
            return await self.s.metadata.can_read("Image", image_id,
                                                  session_key)

    async def _plan(self, ctx: ImageRegionCtx, pixels: Pixels) -> _Plan:
        if ctx.z < 0 or ctx.z >= pixels.size_z:
            raise BadRequestError(
                f"Parameter 'theZ' not within bounds: {ctx.z}")
        if ctx.t < 0 or ctx.t >= pixels.size_t:
            raise BadRequestError(
                f"Parameter 'theT' not within bounds: {ctx.t}")
        if ctx.projection is not None:
            # Refused rather than rendered as a single plane.
            raise BadRequestError("Projection (p=) is not served yet")

        with stopwatch("PixelsService.getPixelBuffer"):
            src = await asyncio.to_thread(
                self.s.pixels_service.get_pixel_source, ctx.image_id)
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
        clamp_region_to_plane(levels, ctx.resolution, region)
        if region.width <= 0 or region.height <= 0:
            raise BadRequestError(
                f"Region {region.as_tuple()} outside image bounds")

        rdef = update_settings(default_rendering_def(pixels), ctx)
        active_rdef, active = restrict_to_active(rdef)
        if not active:
            raise BadRequestError("No active channels to render")
        # The request resolution indexes the largest-first level list
        # directly; the store numbers levels largest-first too.
        return _Plan(src, region, ctx.resolution or 0, active,
                     pack_settings(active_rdef, self.s.lut_provider))

    async def _get_region(self, ctx: ImageRegionCtx,
                          pixels: Pixels) -> bytes:
        plan = await self._plan(ctx, pixels)
        raw = None
        cache = self.s.raw_cache
        if cache is not None:
            # A hit is a dict lookup: no thread hop.
            raw = cache.get(self._region_key(ctx, plan))
        if raw is None:
            raw = await asyncio.to_thread(self._load, plan, ctx)
        h, w = plan.region.height, plan.region.width
        renderer = self.s.renderer
        if ctx.format == "jpeg" and h * w > self.s.jpeg_host_max_px:
            quality = codecs.quality_percent(ctx.compression_quality)
            with stopwatch("Renderer.renderAsPackedInt"):
                return await renderer.render_jpeg(
                    raw, plan.settings, quality, w, h, ctx.flip_horizontal,
                    ctx.flip_vertical)
        with stopwatch("Renderer.renderAsPackedInt"):
            packed = await renderer.render(raw, plan.settings,
                                           ctx.flip_horizontal,
                                           ctx.flip_vertical)
        return await asyncio.to_thread(
            lambda: self.encode(unpack_rgba(packed), ctx))

    @staticmethod
    def _region_key(ctx: ImageRegionCtx, plan: _Plan) -> tuple:
        """The raw read's cache identity: one construction site for the
        event-loop probe and the loader."""
        return region_key(ctx.image_id, ctx.z, ctx.t, plan.level,
                          plan.region.as_tuple(), tuple(plan.active))

    @staticmethod
    def _read_planes(plan: _Plan, ctx: ImageRegionCtx,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """[C_active, h, w] planes in the storage dtype (the kernels widen
        on the device, so uint16 moves half the bytes of float32), read
        into ``out`` when given."""
        if out is None:
            return np.stack([
                plan.src.get_region(ctx.z, c, ctx.t, plan.region, plan.level)
                for c in plan.active])
        for i, c in enumerate(plan.active):
            plan.src.get_region(ctx.z, c, ctx.t, plan.region, plan.level,
                                out=out[i])
        return out

    def _load(self, plan: _Plan, ctx: ImageRegionCtx
              ) -> Union[np.ndarray, torch.Tensor]:
        """Raw planes for the renderer (worker thread).  With a raw cache:
        read straight into a pinned buffer, copied once to the card and
        cached there (a tensor).  Without: host planes, which the renderer
        stages."""
        with stopwatch("PixelsService.readRegion"):
            return self._load_inner(plan, ctx)

    def _load_inner(self, plan: _Plan, ctx: ImageRegionCtx
                    ) -> Union[np.ndarray, torch.Tensor]:
        cache = self.s.raw_cache
        if cache is None:
            return self._read_planes(plan, ctx)

        def read_pinned() -> HostPlanes:
            planes = HostPlanes(
                (len(plan.active), plan.region.height, plan.region.width),
                plan.src.dtype, cache.device)
            self._read_planes(plan, ctx, out=planes.array)
            return planes
        return cache.get_or_load(self._region_key(ctx, plan), read_pinned)

    @staticmethod
    def encode(rgba: np.ndarray, ctx: ImageRegionCtx) -> bytes:
        """Format dispatch; an unknown format is a 404."""
        try:
            with stopwatch("encodeImage"):
                return codecs.encode_rgba(rgba, ctx.format,
                                          ctx.compression_quality)
        except codecs.UnknownFormatError as e:
            raise NotFoundError(str(e))
