"""Request orchestration: parsed ctx -> encoded image bytes.

The analogue of ``ImageRegionRequestHandler.java`` (metadata fetch
``:316-427``, region pipeline ``:429-604``), ``ShapeMaskRequestHandler
.java`` and of the JAX package's ``server/handler.py``
(``render_image_region`` ``:332-458``, ``_get_region`` ``:509-624``,
``_project`` ``:751-831``, ``ShapeMaskHandler`` ``:839-945``,
``WorkloadsHandler`` ``:953-1088``) with the device part behind a
renderer: the batching renderer (``server.batcher``) in the default app,
or the direct :class:`Renderer`.  The image pipeline, in order:

  image-region cache -> ACL (per caller) -> single-flight (concurrent
  identical requests share one run) -> z/t/resolution bounds -> region ->
  settings (``update_settings``, restricted to the active channels) -> raw
  planes (the device raw cache on the event loop; on a miss, the staged
  read in a worker thread, :meth:`ImageRegionHandler._load_staged`) ->
  render on the device, flips included -> encode -> the cache's
  write-back.

A raw-cache miss stages as the JAX handler's ``load_staged`` does
(``:697-734``): a region of at least two bands of
:data:`_STAGE_BAND_ROWS` rows is cut into up to four bands whose bounds
snap to the source's tile rows, and each band is read into a pinned buffer
and staged through ``io.staging.stage``: packed on the host and decoded by
K10 into its rows of one [C, H, W] tensor where JAX would pack it, else
copied plain.  The copies and decodes are queued on the raw cache's
stream without a wait, so band k+1's read and pack overlap band k's copy
and K10, the overlap the JAX handler gets from asynchronous dispatch.  A
smaller region is one read and one ``stage``.

:meth:`ImageRegionHandler.render_image_region_stream` is the streaming
surface the app's chunked response reads (``wire.streaming``); in one
process the stream is the one body, as in the JAX handler.

``format=jpeg`` follows the JAX handler's two routes.  A region above
``ImageRegionServices.jpeg_host_max_px`` pixels takes the device route,
``render_jpeg``: render, JPEG front end and the renderer's wire engine on
the card (the sparse wire and the native entropy coder on the host, or the
Huffman stream, which the host frames).  A region at or below it is
rendered on the card and its RGBA encoded with ``codecs.encode_rgba``
(PIL), the bytes of the JAX handler's tiny-region path.  Both renderers take the flips: the
batcher mirrors each tile's raw before padding it to its bucket (as the
JAX handler folds its flips into the raw), the direct renderer folds them
into K3's reads or flips the packed tile.

Every ACL question, the image's, a mask's and the front's anonymous probe
for ``Vary``, goes through :func:`check_can_read` and the 60 s
``CanReadMemo`` (``services.metadata``), as in the JAX handler: against the
OMERO database a repeat request pays no ACL round trip.  The pixel source
comes from the data directory, else, when the metadata service resolves
binary-repository paths (``services.db_metadata``) and ``PixelsService``
has a ``repo_root``, from the OMERO repository
(:meth:`ImageRegionHandler._open_pixel_source`).

Admission (``server.admission``) sits inside the single-flight producer,
as in the JAX handler: a coalesced follower claims no slot.  With
``sessions.enabled`` each caller first draws its session's fairness token,
before single-flight.  Under the pressure governor's ladder
(``server.pressure``), ``shed_bulk`` sheds a full-plane or projection
render with a 503 before admission, and ``drop_quality`` caps an
interactive device-route JPEG's quality (its bytes are then not written to
the image-region cache).  A raw-cache miss records the plane's routing
identity (``ctx.plane_route_key``) for the explain plane.  The stages
are timed under the JAX package's span names (``utils.stopwatch``):
``get_pixels_description``, ``canRead``, ``PixelsService.getPixelBuffer``,
``PixelsService.readRegion`` (a raw-cache miss's read and copy),
``Renderer.renderAsPackedInt`` (the await of the renderer) and
``encodeImage`` (PIL); a follower's await is a ``dedup.coalesced`` span on
its trace.

A projection (``p=intmax|intmean|intsum``) renders the whole projected
plane at full resolution, as the reference does (``:506-558``): each
active channel's Z window is folded on the host (the JAX handler's
``placement="host"``; a plane above 64 MiB of uint16 in row bands), the
f32 plane goes to the card through a pinned buffer and into the device
raw cache under ``("proj", image, t, c, alg, start, end)`` when it takes
at most an eighth of the cache, and the f32 planes feed the render and
JPEG kernels on the card.  A projected JPEG always takes the device route
(the JAX handler's tiny-region path excludes projections).

:class:`ShapeMaskHandler` serves ``render_shape_mask``: the mask's ACL,
the stored mask, the colour override, the grid (the batcher's mask lane
and K8a in the default app; the host rasterizer for a renderer without
the lane or with ``device_masks`` off) and the palette PNG, the same bytes
either way.  :class:`WorkloadsHandler` composes the image and mask
pipelines: ``render_overlay`` (the base region as PNG, each shape's grid
by K8a and blend by K8b in request order) and ``render_animation`` (a z or
t strip, every frame started at once so the batcher groups them,
``FRME`` records in order).

After a tile GET the prefetcher (``services.prefetch``, on in the default
app) stages the predicted next tiles into the raw cache, and a raw-cache
hit is reported back to it (:meth:`TilePrefetcher.note_hit`), as in the
JAX handler; like the JAX handler it skips tiles of at most
``jpeg_host_max_px`` pixels (the JAX package renders those on the host and
never reads its raw cache for them).

The byte caches (``services.cache``, the JAX handler's flow): a tile GET
first asks the image-region cache under the request's cache key, before
admission, single-flight or any render; a hit still runs the caller's ACL
(through the memo) and records a ``cache.hit`` span, and a miss renders
and writes its bytes back.  The pixels description comes through the
pixels-metadata cache (:meth:`ImageRegionHandler._get_pixels`; an entry
that does not parse is read again from the service), and a mask with an
explicit colour through the shape-mask cache.  Each cache is off unless
its config block switches it on (``Caches.disabled`` is the services'
default).

The fleet's hooks (``parallel.fleet``), as in the JAX handler:
``render_image_region(ctx, adopt_cache=False)`` is a stolen render, read
from the source and rendered without inserting into this member's raw
cache (a raw-cache hit still serves), so stealing never moves a plane's
shard; ``skip_byte_cache=True`` skips the image-region cache's probe,
which the fleet handler above the router has already made, with the
caller's ACL; ``ImageRegionServices.pin_device`` is the member's card (the
renderer's and the raw cache's ``torch.device``; None: the app's).

Provenance (``utils.provenance``): the handlers mark where a response's
bytes came from on its ctx, as the JAX handlers do: ``byte_cache`` for an
image-region or shape-mask cache hit, ``hbm_warm`` or ``render_cold`` for
a raw-cache hit or miss, ``coalesced`` for a single-flight follower, and
the fairness tokens a session drew.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import codecs
from ..io.devicecache import region_key
from ..io.staging import (_TORCH_DTYPES, pinned_copy, read_pinned,
                          stage, storage_dtype)
from ..models.pixels import Pixels, pixels_type_range
from ..models.rendering import default_rendering_def, restrict_to_active
from ..ops import jpegenc
from ..ops import projection as projection_ops
from ..ops.flip import flip_image
from ..ops.maskops import (overlay_tensor, pack_mask_payload,
                           rasterize_mask, rasterize_tensor)
from ..ops.render import (batched_settings, pack_settings,
                          render_tile_batch_packed, resolve_device,
                          settings_to_tensors, unpack_rgba)
from ..services.cache import Caches
from ..services.metadata import CanReadMemo
from ..utils import provenance, telemetry, transient
from ..utils.color import split_html_color
from ..utils.stopwatch import stopwatch
from . import pressure
from .ctx import ImageRegionCtx, ShapeMaskCtx, plane_route_key
from .errors import BadRequestError, NotFoundError, OverloadedError
from .region import RegionDef, plan_region
from .settings import render_identity_key, update_settings

DEFAULT_MAX_TILE_LENGTH = 2048  # beanRefContext.xml:63-66
# JPEG regions of at most this many pixels are rendered on the device and
# encoded with PIL, the bytes of the JAX handler's tiny-region path (its
# cpu_fallback_max_px default); larger ones take the device JPEG route.
JPEG_HOST_MAX_PX = 256 * 256
# Projection banding: planes whose uint16 storage exceeds the threshold
# project in row bands (project_region_banded), so peak host memory is a
# chunk; each band targets about _PROJECTION_BAND_BYTES of f32 rows.
_PROJECTION_BAND_THRESHOLD_BYTES = 64 * 1024 * 1024
_PROJECTION_BAND_BYTES = 32 * 1024 * 1024
# Cold-staging band height: a region at least two bands tall stages band
# by band, so band k+1's read and pack overlap band k's copy and decode.
_STAGE_BAND_ROWS = 256


class Renderer:
    """Direct device render: one B=1 launch of each kernel per request.

    Owns its device: host planes are staged there through a pinned
    buffer, the kernels and the flip run there, and only the packed tile
    or the compacted wire comes back.  The reference handler of
    ``server.app.build_handler(batcher=False)``, which has no raw cache.

    ``jpeg_engine`` picks the device JPEG wire: ``"sparse"`` (the default)
    or ``"huffman"``, as the batcher's, or ``"bitpack"``, the JAX direct
    renderer's fully device-packed stream (K1, K3 and K6; the host only
    byte-swaps, 0xFF-stuffs and frames it).  The bitpack stream covers
    the whole MCU grid, so it serves MCU-aligned tiles only; any other
    tile, and a tile whose stream overflows its encoder's capacity, takes
    the sparse engine, as in JAX.
    """

    # Bitpack encoders, one per (H, W, quality); shapes and quality are
    # the client's, so a small LRU, not an unbounded dict.
    _MAX_BITPACK_ENCODERS = 8

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 jpeg_engine: str = "sparse"):
        if jpeg_engine not in ("sparse", "huffman", "bitpack"):
            raise ValueError(f"jpeg engine must be 'sparse', 'huffman' or "
                             f"'bitpack', got {jpeg_engine!r}")
        self.device = resolve_device(device)
        self.jpeg_engine = jpeg_engine
        self._bitpack_encoders: "OrderedDict" = OrderedDict()
        # render_jpeg_sync runs on worker threads: the LRU's bookkeeping
        # is under this lock.
        self._bitpack_lock = threading.Lock()

    def _bitpack_encoder(self, H: int, W: int,
                         quality: int) -> jpegenc.BitpackJpegEncoder:
        """The (H, W, quality) encoder: an LRU hit, else one built outside
        the lock and put in if absent (a racing thread's copy wins at
        most once)."""
        key = (H, W, quality)
        with self._bitpack_lock:
            enc = self._bitpack_encoders.get(key)
            if enc is not None:
                self._bitpack_encoders.move_to_end(key)
                return enc
        built = jpegenc.BitpackJpegEncoder(H, W, quality=quality)
        with self._bitpack_lock:
            enc = self._bitpack_encoders.setdefault(key, built)
            self._bitpack_encoders.move_to_end(key)
            while len(self._bitpack_encoders) > self._MAX_BITPACK_ENCODERS:
                self._bitpack_encoders.popitem(last=False)
        return enc

    async def render(self, raw: np.ndarray, settings: dict,
                     flip_horizontal: bool = False,
                     flip_vertical: bool = False) -> np.ndarray:
        """[C, H, W] raw + packed settings -> u32[H, W] packed RGBA."""
        return await asyncio.to_thread(self.render_sync, raw, settings,
                                       flip_horizontal, flip_vertical)

    def _on_device(self, raw: Union[np.ndarray, torch.Tensor]
                   ) -> torch.Tensor:
        """[1, C, h, w] on the device: host planes staged through a pinned
        buffer, device planes (a projection) as they are."""
        if isinstance(raw, torch.Tensor):
            return raw.to(self.device)[None]
        return pinned_copy(raw, self.device)[None]

    def render_sync(self, raw: np.ndarray, settings: dict,
                    flip_horizontal: bool = False,
                    flip_vertical: bool = False) -> np.ndarray:
        raw_t = self._on_device(raw)
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
        its reads (K3), the renderer's wire and its compaction (K4a and
        K4b, or K5 and K4b); the compacted wire's used bytes back; the
        native entropy coder or the Huffman stream's framing.  Under the
        bitpack engine an MCU-aligned tile's stream is K6's, its words
        back and framed by the host; an overflowing one is coded by the
        sparse engine from the same coefficients."""
        raw_t = self._on_device(raw)
        tensors = settings_to_tensors(settings, self.device)
        packed = render_tile_batch_packed(raw_t, *batched_settings(tensors))
        h, w = packed.shape[-2:]
        H, W = h + (-h) % 16, w + (-w) % 16
        y, cb, cr = jpegenc.packed_to_jpeg_coefficients(
            packed, quality, H, W, flip_horizontal, flip_vertical)

        def sparse(_i: int = 0) -> bytes:
            return jpegenc.coefficients_to_jpegs(
                y, cb, cr, H, W, quality, [(width, height)],
                engine="sparse")[0]
        if self.jpeg_engine == "bitpack":
            if width % 16 or height % 16:
                return sparse()
            enc = self._bitpack_encoder(H, W, quality)
            return enc.finish_batch(*enc.bits(y, cb, cr),
                                    dense_fallback=sparse)[0]
        return jpegenc.coefficients_to_jpegs(
            y, cb, cr, H, W, quality, [(width, height)],
            engine=self.jpeg_engine)[0]

    async def close(self) -> None:
        """Nothing to release (the batcher's counterpart stops its
        dispatchers)."""


@dataclass
class ImageRegionServices:
    """Everything a handler needs, injected once at startup (the analogue of
    the Spring wiring, ``beanRefContext.xml:68-79``)."""

    pixels_service: object            # io.service.PixelsService
    # services.metadata.LocalMetadataService or services.db_metadata
    # .DbMetadataService
    metadata: object
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
    prefetcher: object = None         # services.prefetch.TilePrefetcher
    can_read_memo: CanReadMemo = field(default_factory=CanReadMemo)
    # The byte caches (services.cache.Caches); disabled stacks unless the
    # app builds them from its config.
    caches: Caches = field(default_factory=Caches.disabled)
    # The warm-state snapshot and rehydrate (services.warmstate
    # .WarmStateManager), with persistence.enabled.
    warmstate: object = None
    # A fleet member's card (a torch.device); None: the app's device.
    pin_device: object = None


async def check_can_read(services: ImageRegionServices, object_type: str,
                         object_id: int,
                         session_key: Optional[str]) -> bool:
    """The memoized ACL check (memo, else the metadata service and a memo
    write-back), shared by the image and mask pipelines and the front."""
    memo = services.can_read_memo
    hit = await memo.get_async(session_key, object_type, object_id)
    if hit is not None:
        return hit
    with stopwatch("canRead"):
        ok = await services.metadata.can_read(object_type, object_id,
                                              session_key)
    await memo.put_async(session_key, object_type, object_id, ok)
    return ok


@dataclass
class _Plan:
    """A request resolved against its image: where to read and how to
    render."""

    src: object                       # io.pixelsource.PixelSource
    region: RegionDef
    level: int
    active: List[int]
    settings: dict
    levels: Sequence[Sequence[int]]   # (size_x, size_y) per level


class ImageRegionHandler:
    """One instance per service; per-request state stays on the stack."""

    def __init__(self, services: ImageRegionServices):
        self.s = services

    async def render_image_region(self, ctx: ImageRegionCtx,
                                  adopt_cache: bool = True,
                                  skip_byte_cache: bool = False) -> bytes:
        """``render_image_region`` / ``render_image``: the encoded bytes.

        The image-region cache first (``renderImageRegion``,
        ``:159-249``): a hit answers after the caller's ACL, with no
        admission and no render.  On a miss the ACL runs per caller;
        concurrent identical requests then share one pipeline run
        (single-flight), whose bytes are written back to the cache.
        Without single-flight the await is still bounded by the request's
        deadline: a group whose members' budgets died after it was popped
        may still be running, and the caller gets its
        ``DeadlineExceededError`` at budget end.

        ``adopt_cache=False`` (a fleet steal) renders from the source
        without inserting into the raw cache; ``skip_byte_cache=True`` (a
        fleet member behind the fleet handler) skips the cache probe the
        fleet handler made.  The write-back runs either way.
        """
        t0 = time.perf_counter()
        cached = (None if skip_byte_cache else
                  await self.s.caches.image_region.get(ctx.cache_key))
        if cached is not None:
            if await self.can_read(ctx.image_id, ctx.omero_session_key):
                telemetry.record_span("cache.hit", t0,
                                      (time.perf_counter() - t0) * 1000.0)
                provenance.mark(ctx, tier="byte_cache")
                return cached
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        pixels = await self._authorize(ctx)
        admission = self.s.admission
        # The session's fairness token, per caller and before coalescing.
        debit = (admission.admit_session(ctx) if admission is not None
                 else None)
        if debit is not None:
            provenance.mark(ctx, tokens=debit[1])

        async def produce() -> bytes:
            # Bulk work sheds first under the pressure ladder, before any
            # read or staging cost.
            pressure.shed_bulk_under_pressure(ctx)
            t_admit = admission.admit() if admission is not None else None
            completed = False
            try:
                transient.check_deadline("render pipeline")
                data = await self._get_region(ctx, pixels, adopt_cache)
                completed = True
            finally:
                if admission is not None:
                    admission.release(t_admit, completed=completed)
            if not getattr(ctx, "_pressure_quality_capped", False):
                await self.s.caches.image_region.set(ctx.cache_key, data)
            return data

        try:
            if self.s.single_flight is None:
                return await self._bounded(produce())
            data, coalesced = await self.s.single_flight.run(
                render_identity_key(ctx), produce)
        except OverloadedError:
            # Refused by the global bound (here or in the leader this
            # caller coalesced onto): the session gets its token back.
            if admission is not None:
                admission.refund_session(debit)
            raise
        if coalesced:
            telemetry.record_span("dedup.coalesced", t0,
                                  (time.perf_counter() - t0) * 1000.0)
            provenance.mark(ctx, coalesced=True)
        return data

    async def render_image_region_stream(self, ctx: ImageRegionCtx):
        """The chunked response's surface (the sidecar proxy streams wire
        chunks through the same call): in one process, the one body."""
        yield await self.render_image_region(ctx)

    @staticmethod
    async def _bounded(work):
        """Await ``work`` within the request's deadline, if it has one."""
        remaining = transient.remaining_ms()
        if remaining is None:
            return await work
        try:
            return await asyncio.wait_for(
                work, timeout=max(0.0, remaining) / 1000.0)
        except asyncio.TimeoutError:
            raise transient.DeadlineExceededError(
                "deadline exceeded awaiting render")

    async def read(self, ctx: ImageRegionCtx) -> Tuple[np.ndarray, dict]:
        """ACL, bounds and region resolution, then a host read that
        bypasses the raw cache.

        Returns the active channels' raw planes [C_active, h, w] in the
        storage dtype and their packed render settings.
        """
        plan = await self._plan(ctx, await self._authorize(ctx))
        raw = await asyncio.to_thread(self._read_planes, plan, ctx)
        return raw, plan.settings

    async def _get_pixels(self, ctx: ImageRegionCtx) -> Optional[Pixels]:
        """The pixels description, the pixels-metadata cache in front of
        the service (``ImageRegionRequestHandler.java:316-427``); an entry
        that does not parse falls through to the service."""
        key = ImageRegionCtx.pixels_metadata_cache_key(ctx.image_id)
        cached = await self.s.caches.pixels_metadata.get(key)
        if cached is not None:
            try:
                return Pixels.from_json(json.loads(cached))
            except (ValueError, KeyError):
                pass
        with stopwatch("get_pixels_description"):
            pixels = await self.s.metadata.get_pixels_description(
                ctx.image_id, ctx.omero_session_key)
        if pixels is not None:
            await self.s.caches.pixels_metadata.set(
                key, json.dumps(pixels.to_json()).encode())
        return pixels

    async def _authorize(self, ctx: ImageRegionCtx) -> Pixels:
        pixels = await self._get_pixels(ctx)
        if pixels is None or not await self.can_read(
                ctx.image_id, ctx.omero_session_key):
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        return pixels

    async def can_read(self, image_id: int,
                       session_key: Optional[str]) -> bool:
        """The read ACL of an image for a caller (memoized)."""
        return await check_can_read(self.s, "Image", image_id, session_key)

    async def _open_pixel_source(self, image_id: int, pixels: Pixels):
        """The image's pixel source: the data directory's (or the open
        handle's), else, when the metadata service resolves repository
        paths and the pixels service has a ``repo_root``, the first usable
        candidate in the OMERO binary repository (the reference's resolver
        bean and Bio-Formats, ``ImageRegionRequestHandler.java:302-309``).
        """
        svc = self.s.pixels_service
        try:
            return await asyncio.to_thread(svc.get_pixel_source, image_id)
        except FileNotFoundError:
            resolver = getattr(self.s.metadata, "resolve_image_paths", None)
            if resolver is None or not getattr(svc, "repo_root", None):
                raise
        candidates = await resolver(image_id)
        return await asyncio.to_thread(svc.get_pixel_source, image_id,
                                       candidates, pixels)

    async def _plan(self, ctx: ImageRegionCtx, pixels: Pixels) -> _Plan:
        if ctx.z < 0 or ctx.z >= pixels.size_z:
            raise BadRequestError(
                f"Parameter 'theZ' not within bounds: {ctx.z}")
        if ctx.t < 0 or ctx.t >= pixels.size_t:
            raise BadRequestError(
                f"Parameter 'theT' not within bounds: {ctx.t}")
        with stopwatch("PixelsService.getPixelBuffer"):
            src = await self._open_pixel_source(ctx.image_id, pixels)
        if src.resolution_levels() > 1:
            levels: Sequence[Sequence[int]] = [
                list(d) for d in src.resolution_descriptions()]
        else:
            levels = [[pixels.size_x, pixels.size_y]]
        if ctx.resolution is not None and not (
                0 <= ctx.resolution < len(levels)):
            raise BadRequestError(
                f"Resolution {ctx.resolution} not within [0, {len(levels)})")

        region, level = plan_region(
            levels, ctx.resolution, ctx.tile, ctx.region, src.tile_size(),
            self.s.max_tile_length, ctx.flip_horizontal, ctx.flip_vertical)
        if region.width <= 0 or region.height <= 0:
            raise BadRequestError(
                f"Region {region.as_tuple()} outside image bounds")

        rdef = update_settings(default_rendering_def(pixels), ctx)
        active_rdef, active = restrict_to_active(rdef)
        if not active:
            raise BadRequestError("No active channels to render")
        return _Plan(src, region, level, active,
                     pack_settings(active_rdef, self.s.lut_provider),
                     levels)

    async def _get_region(self, ctx: ImageRegionCtx, pixels: Pixels,
                          adopt_cache: bool = True) -> bytes:
        plan = await self._plan(ctx, pixels)
        if ctx.projection is not None:
            raw = await self._project(ctx, pixels, plan)
            h, w = pixels.size_y, pixels.size_x
            device_jpeg = ctx.format == "jpeg"
        else:
            raw = None
            cache, prefetcher = self.s.raw_cache, self.s.prefetcher
            if cache is not None:
                # A hit is a dict lookup: no thread hop.
                key = self._region_key(ctx, plan)
                raw = cache.get(key)
                if raw is not None and prefetcher is not None:
                    prefetcher.note_hit(key)
            provenance.mark(ctx, tier="render_cold" if raw is None
                            else "hbm_warm")
            if raw is None:
                raw = await asyncio.to_thread(self._load, plan, ctx,
                                              adopt_cache)
            h, w = plan.region.height, plan.region.width
            tiny = h * w <= self.s.jpeg_host_max_px
            if prefetcher is not None and ctx.tile is not None and not tiny:
                prefetcher.tile_served(
                    plan.src, ctx.image_id, ctx.z, ctx.t, ctx.resolution,
                    plan.levels, ctx.tile, plan.src.tile_size(),
                    self.s.max_tile_length, plan.active,
                    ctx.flip_horizontal, ctx.flip_vertical,
                    session_key=ctx.omero_session_key)
            device_jpeg = ctx.format == "jpeg" and not tiny
        renderer = self.s.renderer
        if device_jpeg:
            quality = pressure.pressure_quality(
                codecs.quality_percent(ctx.compression_quality), ctx)
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

    async def _project(self, ctx: ImageRegionCtx, pixels: Pixels,
                       plan: _Plan) -> torch.Tensor:
        """The Z-projection branch (``:506-558``): each active channel's
        projected full plane, f32 [C_active, H, W] on the card.

        Planes stream through ``ops.projection.project_planes`` (only the
        Z window's planes are read, one at a time) or, for a plane above
        ``_PROJECTION_BAND_THRESHOLD_BYTES`` of uint16,
        ``project_region_banded``; both fold on the host, as the JAX
        handler does.  A projected plane that takes at most an eighth of
        the raw cache is cached there, so one whole-slide plane cannot
        flush the tiles of a pan."""
        start = ctx.projection_start or 0
        end = (ctx.projection_end if ctx.projection_end is not None
               else pixels.size_z - 1)
        projection_ops.check_projection_bounds(
            start, end, 1, plan.active[0], ctx.t,
            pixels.size_z, pixels.size_c, pixels.size_t)
        type_max = pixels_type_range(pixels.pixels_type)[1]
        full = RegionDef(0, 0, pixels.size_x, pixels.size_y)
        src, device = plan.src, self.s.renderer.device

        def project_one(c: int) -> torch.Tensor:
            with stopwatch("ProjectionService.projectStack"):
                if (pixels.size_x * pixels.size_y * 2
                        > _PROJECTION_BAND_THRESHOLD_BYTES):
                    band = max(64, _PROJECTION_BAND_BYTES
                               // max(pixels.size_x * 4, 1))
                    return projection_ops.project_region_banded(
                        lambda z, y0, h: src.get_region(
                            z, c, ctx.t,
                            RegionDef(0, y0, pixels.size_x, h), 0),
                        ctx.projection, pixels.size_z, start, end, 1,
                        type_max,
                        plane_shape=(pixels.size_y, pixels.size_x),
                        band_rows=band, placement="host", device=device)
                return projection_ops.project_planes(
                    lambda z: src.get_region(z, c, ctx.t, full, 0),
                    ctx.projection, pixels.size_z, start, end, 1,
                    type_max, shape=(pixels.size_y, pixels.size_x),
                    placement="host", device=device)

        cache = self.s.raw_cache
        plane_bytes = pixels.size_x * pixels.size_y * 4
        cacheable = (cache is not None
                     and plane_bytes <= cache.max_bytes // 8)

        def run() -> torch.Tensor:
            out = []
            for c in plan.active:
                if cacheable:
                    key = ("proj", ctx.image_id, ctx.t, c,
                           int(ctx.projection), start, end)
                    out.append(cache.get_or_load(
                        key, lambda c=c: project_one(c)))
                else:
                    out.append(project_one(c))
            planes = torch.stack(out)
            if planes.is_cuda:
                # Read next on a lane's stream.
                torch.cuda.current_stream(planes.device).synchronize()
            return planes

        return await asyncio.to_thread(run)

    @staticmethod
    def _region_key(ctx: ImageRegionCtx, plan: _Plan) -> tuple:
        """The raw read's cache identity: one construction site for the
        event-loop probe and the loader."""
        return region_key(ctx.image_id, ctx.z, ctx.t, plan.level,
                          plan.region.as_tuple(), tuple(plan.active))

    @staticmethod
    def _read_planes(plan: _Plan, ctx: ImageRegionCtx) -> np.ndarray:
        """[C_active, h, w] planes in the storage dtype (the kernels widen
        on the device, so uint16 moves half the bytes of float32)."""
        return np.stack([
            plan.src.get_region(ctx.z, c, ctx.t, plan.region, plan.level)
            for c in plan.active])

    def _load(self, plan: _Plan, ctx: ImageRegionCtx,
              adopt_cache: bool = True) -> Union[np.ndarray, torch.Tensor]:
        """Raw planes for the renderer (worker thread).  With a raw cache
        that adopts the plane: read straight into a pinned buffer, copied
        once to the card and cached there (a tensor).  Without, or for a
        stolen render: host planes, which the renderer stages."""
        with stopwatch("PixelsService.readRegion"):
            return self._load_inner(plan, ctx, adopt_cache)

    def _load_inner(self, plan: _Plan, ctx: ImageRegionCtx,
                    adopt_cache: bool = True
                    ) -> Union[np.ndarray, torch.Tensor]:
        cache = self.s.raw_cache
        if cache is None or not adopt_cache:
            return self._read_planes(plan, ctx)
        return cache.get_or_load(
            self._region_key(ctx, plan),
            lambda: self._load_staged(plan, ctx, cache),
            route_key=plane_route_key(ctx))

    @staticmethod
    def _band_bounds(region: RegionDef, tile_h: int) -> List[int]:
        """Row bounds of the JAX handler's staging bands (``:711-725``):
        ``min(4, height // 256)`` bands, interior bounds snapped to the
        nearest tile row, so no tile row is read by two bands; [] when the
        region is under two bands."""
        n_bands = min(4, region.height // _STAGE_BAND_ROWS)
        if n_bands < 2:
            return []
        tile_h = max(1, tile_h)
        bounds = [0]
        for k in range(1, n_bands):
            b = region.height * k // n_bands
            snapped = ((region.y + b + tile_h // 2) // tile_h * tile_h
                       - region.y)
            b = min(max(snapped, bounds[-1] + 1), region.height - 1)
            if b > bounds[-1]:
                bounds.append(b)
        bounds.append(region.height)
        return bounds

    @classmethod
    def _load_staged(cls, plan: _Plan, ctx: ImageRegionCtx, cache):
        """A raw-cache miss's planes (module docstring): host planes for
        the cache to stage (under two bands), or the banded [C, H, W]
        tensor, staged on the cache's stream and waited for."""
        region, src = plan.region, plan.src
        bounds = cls._band_bounds(region, src.tile_size()[1])
        if not bounds:
            return read_pinned(src, ctx.z, ctx.t, region, plan.level,
                               plan.active, cache.device)
        dtype = storage_dtype(src.dtype)

        def run() -> torch.Tensor:
            out = torch.empty(
                (len(plan.active), region.height, region.width),
                dtype=_TORCH_DTYPES[dtype], device=cache.device)
            for y0, y1 in zip(bounds, bounds[1:]):
                band = read_pinned(
                    src, ctx.z, ctx.t,
                    RegionDef(region.x, region.y + y0, region.width,
                              y1 - y0),
                    plan.level, plan.active, cache.device)
                stage(band.array, cache.device, out=out[:, y0:y1],
                      planes=band)
            return out.view(torch.uint16) if dtype == np.uint16 else out

        planes = cache.upload(run)
        # The raw bytes staged, as for a host-array miss.  (The JAX cache
        # adds ``staged_bytes`` for host arrays only, so its banded misses
        # leave the field out of the ledger.)
        telemetry.add_cost("staged_bytes",
                           planes.numel() * planes.element_size())
        return planes

    @staticmethod
    def encode(rgba: np.ndarray, ctx: ImageRegionCtx) -> bytes:
        """Format dispatch; an unknown format is a 404."""
        try:
            with stopwatch("encodeImage"):
                return codecs.encode_rgba(rgba, ctx.format,
                                          ctx.compression_quality)
        except codecs.UnknownFormatError as e:
            raise NotFoundError(str(e))


class ShapeMaskHandler:
    """The mask pipeline (``ShapeMaskVerticle.java:67-155`` and
    ``ShapeMaskRequestHandler.java``).

    With ``device_masks`` (the default) a renderer that has a mask lane
    (``BatchingRenderer.rasterize_mask``) rasterizes there: same-shape
    masks group into one K8a launch.  Its grid equals the host
    rasterizer's bit for bit and the PNG tail is shared, so the bytes are
    the same either way.  The host rasterizer serves a renderer without a
    lane (the direct reference) and ``device_masks`` off.  The shape-mask
    cache is asked first (:meth:`cached_shape_mask`), and a PNG rendered
    under an explicit colour is written back, as in the reference."""

    def __init__(self, services: ImageRegionServices,
                 device_masks: bool = True):
        self.s = services
        self.device_masks = device_masks

    async def can_read(self, shape_id: int,
                       session_key: Optional[str]) -> bool:
        """The read ACL of a mask for a caller (memoized)."""
        return await check_can_read(self.s, "Mask", shape_id, session_key)

    async def cached_shape_mask(self, ctx: ShapeMaskCtx) -> Optional[bytes]:
        """The shape-mask cache's bytes when the caller may read the mask
        (a ``cache.hit`` span), else None: a miss, or a hit the caller may
        not read (the render path then answers its 404).  The app asks
        this before the session's fairness token, as the JAX app does."""
        t0 = time.perf_counter()
        cached = await self.s.caches.shape_mask.get(ctx.cache_key())
        if cached is None or not await self.can_read(
                ctx.shape_id, ctx.omero_session_key):
            return None
        telemetry.record_span("cache.hit", t0,
                              (time.perf_counter() - t0) * 1000.0)
        provenance.mark(ctx, tier="byte_cache")
        return cached

    async def render_shape_mask(self, ctx: ShapeMaskCtx) -> bytes:
        cached = await self.cached_shape_mask(ctx)
        if cached is not None:
            return cached
        if not await self.can_read(ctx.shape_id, ctx.omero_session_key):
            raise NotFoundError(f"Cannot find Shape:{ctx.shape_id}")
        with stopwatch("getMask"):
            mask = await self.s.metadata.get_mask(ctx.shape_id,
                                                  ctx.omero_session_key)
        if mask is None:
            raise NotFoundError(f"Cannot find Shape:{ctx.shape_id}")

        color = None
        if ctx.color is not None:
            color = split_html_color(ctx.color)
            if color is None:
                raise BadRequestError(f"Invalid color '{ctx.color}'")

        with stopwatch("renderShapeMask"):
            rasterize = (getattr(self.s.renderer, "rasterize_mask", None)
                         if self.device_masks else None)
            if rasterize is not None:
                png = await self._render_device(mask, color, ctx,
                                                rasterize)
                telemetry.WORKLOADS.count_request("mask_device")
            else:
                png = await asyncio.to_thread(self._render, mask, color,
                                              ctx)
                telemetry.WORKLOADS.count_request("mask_host")
        # Cached only under an explicit colour, as in the reference: a
        # cached default-colour PNG would hide a later change of the stored
        # fill (``ShapeMaskVerticle.java:140-148``).
        if ctx.color is not None:
            await self.s.caches.shape_mask.set(ctx.cache_key(), png)
        return png

    @staticmethod
    def _render(mask, color, ctx: ShapeMaskCtx) -> bytes:
        grid, palette = rasterize_mask(
            mask, color, ctx.flip_horizontal, ctx.flip_vertical)
        return codecs.encode_mask_png(grid, tuple(palette[1]))

    @staticmethod
    async def _render_device(mask, color, ctx: ShapeMaskCtx,
                             rasterize) -> bytes:
        """The payload checked and cut on the host (the host path's
        checks), one awaited group launch for the grid, the same PNG
        tail."""
        fill = mask.resolved_fill_color(color)
        packed = pack_mask_payload(mask.bytes_, mask.width, mask.height)
        grid = await rasterize(packed, mask.width, mask.height,
                               ctx.flip_horizontal, ctx.flip_vertical)
        return await asyncio.to_thread(codecs.encode_mask_png, grid,
                                       tuple(fill))


# Animation wire framing: each frame leaves as a length-prefixed record, so
# a scrubbing client can carve frame boundaries out of the stream.
ANIMATION_FRAME_MAGIC = b"FRME"


def frame_record(body: bytes) -> bytes:
    """``FRME`` + u32be length + encoded frame bytes."""
    return (ANIMATION_FRAME_MAGIC
            + len(body).to_bytes(4, "big") + body)


class WorkloadsHandler:
    """The routes that compose the image and mask pipelines: overlay
    composites and z/t animation strips.  It owns no pixels or caches:
    it drives the same handlers the plain routes use, so every identity,
    ACL and admission rule of those holds here too."""

    def __init__(self, image_handler: ImageRegionHandler,
                 mask_handler: ShapeMaskHandler, max_frames: int = 64):
        self.image_handler = image_handler
        self.mask_handler = mask_handler
        self.s = image_handler.s
        self.max_frames = max_frames

    async def render_overlay(self, ctx: ImageRegionCtx,
                             shape_ids: Sequence[int],
                             color: Optional[str] = None) -> bytes:
        """Region pixels and ROI masks composited on the card -> PNG.

        ``ctx`` carries ``format="png"`` (the app forces it: the base must
        be lossless).  Each mask must match the rendered region's size.
        The base is rendered by the image handler and decoded; then for
        each shape in request order its grid (K8a) and its blend over the
        running composite (K8b), the exact ``ops.maskops
        .overlay_masks_batch`` formula; the composite comes back once and
        is encoded."""
        if not shape_ids:
            raise BadRequestError("overlay needs at least one shapeId")
        fill_override = None
        if color is not None:
            fill_override = split_html_color(color)
            if fill_override is None:
                raise BadRequestError(f"Invalid color '{color}'")

        masks = []
        for sid in shape_ids:
            if not await self.mask_handler.can_read(sid,
                                                    ctx.omero_session_key):
                raise NotFoundError(f"Cannot find Shape:{sid}")
            with stopwatch("getMask"):
                mask = await self.s.metadata.get_mask(
                    sid, ctx.omero_session_key)
            if mask is None:
                raise NotFoundError(f"Cannot find Shape:{sid}")
            masks.append(mask)

        base_png = await self.image_handler.render_image_region(ctx)
        base = await asyncio.to_thread(codecs.decode_to_rgba, base_png)
        device = self.s.renderer.device

        def composite() -> bytes:
            out = pinned_copy(np.ascontiguousarray(base), device)
            for mask in masks:
                if (mask.height, mask.width) != base.shape[:2]:
                    raise BadRequestError(
                        f"Shape:{mask.shape_id} is "
                        f"{mask.width}x{mask.height}, region is "
                        f"{base.shape[1]}x{base.shape[0]}")
                packed = pack_mask_payload(mask.bytes_, mask.width,
                                           mask.height)
                grid = rasterize_tensor(
                    pinned_copy(packed[None], device), mask.width,
                    mask.height,
                    ctx.flip_horizontal, ctx.flip_vertical)
                fill = pinned_copy(np.array(
                    [mask.resolved_fill_color(fill_override)],
                    dtype=np.uint8), device)
                out = overlay_tensor(out[None], grid, fill)[0]
            return codecs.encode_rgba(out.cpu().numpy(), "png")

        with stopwatch("renderOverlay"):
            body = await asyncio.to_thread(composite)
        telemetry.WORKLOADS.count_request("overlay")
        return body

    async def render_animation_stream(self, frame_ctxs:
                                      Sequence[ImageRegionCtx]):
        """Async generator: a z/t frame range, length-prefixed frames
        yielded in order.

        Every frame's render starts at once, so the batcher's linger
        groups the strip while the client reads frame 0.  Closing the
        generator (a client that left, a deadline) cancels every frame not
        yet settled: its queued device work is dropped at the dispatch
        queue."""
        if not frame_ctxs:
            raise BadRequestError("animation needs at least one frame")
        if len(frame_ctxs) > self.max_frames:
            raise BadRequestError(
                f"animation of {len(frame_ctxs)} frames exceeds the "
                f"configured cap of {self.max_frames}")
        t0 = time.perf_counter()
        telemetry.WORKLOADS.count_stream()
        image = getattr(frame_ctxs[0], "image_id", None)
        telemetry.FLIGHT.record("animation.stream", image=image,
                                frames=len(frame_ctxs))
        tasks = [asyncio.ensure_future(
            self.image_handler.render_image_region(fctx))
            for fctx in frame_ctxs]
        served = 0
        try:
            for task in tasks:
                body = await task
                if served == 0:
                    telemetry.WORKLOADS.observe_first_frame_ms(
                        (time.perf_counter() - t0) * 1000.0)
                served += 1
                telemetry.WORKLOADS.count_frames()
                yield frame_record(body)
        finally:
            remaining = [t for t in tasks if not t.done()]
            for t in remaining:
                t.cancel()
            for t in tasks[served + 1:]:
                if t.done() and not t.cancelled():
                    t.exception()       # retrieved: the stream failed first
            if remaining:
                telemetry.WORKLOADS.count_stream_cancelled()
                telemetry.FLIGHT.record(
                    "animation.cancelled", image=image, served=served,
                    cancelled=len(remaining))
                # Settle the cancellations, so no "exception was never
                # retrieved" outlives the stream.
                await asyncio.gather(*remaining, return_exceptions=True)
