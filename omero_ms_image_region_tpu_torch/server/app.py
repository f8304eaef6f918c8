"""Minimal aiohttp app for the render routes.

Routes (the reference's, ``ImageRegionMicroserviceVerticle.java:214-231``;
trailing segments are tolerated as its ``:theT*`` patterns are):

  GET /webgateway/render_image_region/{imageId}/{theZ}/{theT}[/...]
  GET /webgateway/render_image/{imageId}/{theZ}/{theT}[/...]
  (the same two under /webclient)
  OPTIONS /          the feature document
  GET /healthz       liveness

``aiohttp`` is imported inside :func:`create_app`, so the render path
imports without it.
"""

from __future__ import annotations

import logging
from typing import Optional, Union

import torch

from .. import __version__, codecs
from ..io.devicecache import DeviceRawCache
from ..io.service import PixelsService
from ..ops.lut import LutProvider
from ..ops.render import resolve_device
from ..services.metadata import LocalMetadataService
from ..utils.transient import DeadlineExceededError, deadline_scope
from .batcher import BatchingRenderer
from .ctx import ImageRegionCtx
from .errors import BadRequestError, NotFoundError
from .handler import (JPEG_HOST_MAX_PX, ImageRegionHandler,
                      ImageRegionServices, Renderer)
from .singleflight import SingleFlight

log = logging.getLogger(__name__)

PROVIDER = "ImageRegionMicroservice"
FEATURES = ["flip", "png-tiles"]


def build_handler(data_dir: str, lut_root: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda",
                  jpeg_host_max_px: int = JPEG_HOST_MAX_PX,
                  batcher: bool = True) -> ImageRegionHandler:
    """The handler over a data directory of chunked pyramids, in the JAX
    app's default posture (``server/app.py:234-308`` there): the batching
    renderer (max_batch 8, linger 2 ms, pipeline depth 4, 2 device lanes),
    the device raw cache (2 GiB) and single-flight.  The cache's
    content-digest dedup stays off (``io.devicecache``).

    ``batcher=False`` builds the reference the tests hold the default
    against: the direct :class:`Renderer` (one B=1 launch of each kernel
    per request), with no raw cache and no single-flight."""
    device = resolve_device(device)
    if batcher:
        serving = dict(renderer=BatchingRenderer(device),
                       raw_cache=DeviceRawCache(device=device),
                       single_flight=SingleFlight())
    else:
        serving = dict(renderer=Renderer(device))
    return ImageRegionHandler(ImageRegionServices(
        pixels_service=PixelsService(data_dir),
        metadata=LocalMetadataService(data_dir),
        lut_provider=LutProvider(lut_root),
        jpeg_host_max_px=jpeg_host_max_px,
        **serving,
    ))


def create_app(data_dir: str, lut_root: Optional[str] = None,
               device: Union[str, torch.device] = "cuda",
               handler: Optional[ImageRegionHandler] = None,
               request_deadline_ms: float = 0.0):
    """The aiohttp application serving the render routes.  ``handler``
    overrides the one built from ``data_dir``/``lut_root``/``device``.
    ``request_deadline_ms`` > 0 gives every render request that budget
    (``utils.transient``; 0, the JAX default, leaves it unbounded): work
    whose budget is spent is dropped from the batch queue, and the client
    gets a 504.  The app's cleanup closes the handler's renderer."""
    from aiohttp import web

    handler = handler or build_handler(data_dir, lut_root, device)

    def status_of(e: Exception) -> web.Response:
        # The reference's empty 404/500 bodies
        # (ImageRegionMicroserviceVerticle.java:314-323); never a traceback.
        if isinstance(e, BadRequestError):
            return web.Response(status=400, text=str(e))
        if isinstance(e, (NotFoundError, FileNotFoundError)):
            return web.Response(status=404)
        if isinstance(e, DeadlineExceededError):
            return web.json_response({"error": str(e)}, status=504)
        log.exception("render failed", exc_info=e)
        return web.Response(status=500)

    async def render_image_region(request: web.Request) -> web.Response:
        params = dict(request.query)
        params.update(request.match_info)
        params.pop("tail", None)
        try:
            ctx = ImageRegionCtx.from_params(params)
            with deadline_scope(request_deadline_ms):
                body = await handler.render_image_region(ctx)
        except Exception as e:
            return status_of(e)
        return web.Response(body=body, headers={
            "Content-Type": codecs.CONTENT_TYPES.get(
                ctx.format, "application/octet-stream")})

    async def details(request: web.Request) -> web.Response:
        return web.json_response({
            "provider": PROVIDER,
            "version": __version__,
            "features": FEATURES,
            "options": {"maxTileLength": handler.s.max_tile_length},
        })

    async def healthz(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def close_renderer(app: web.Application) -> None:
        await handler.s.renderer.close()

    app = web.Application()
    app.on_cleanup.append(close_renderer)
    for prefix in ("webgateway", "webclient"):
        for route in ("render_image_region", "render_image"):
            base = f"/{prefix}/{route}/{{imageId}}/{{theZ}}/{{theT}}"
            app.router.add_get(base, render_image_region)
            app.router.add_get(base + "/{tail:.*}", render_image_region)
    app.router.add_get("/healthz", healthz)
    app.router.add_route("OPTIONS", "/{tail:.*}", details)
    return app
