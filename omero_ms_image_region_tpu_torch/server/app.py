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
from ..io.service import PixelsService
from ..ops.lut import LutProvider
from ..services.metadata import LocalMetadataService
from .ctx import ImageRegionCtx
from .errors import BadRequestError, NotFoundError
from .handler import (JPEG_HOST_MAX_PX, ImageRegionHandler,
                      ImageRegionServices, Renderer)

log = logging.getLogger(__name__)

PROVIDER = "ImageRegionMicroservice"
FEATURES = ["flip", "png-tiles"]


def build_handler(data_dir: str, lut_root: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda",
                  jpeg_host_max_px: int = JPEG_HOST_MAX_PX
                  ) -> ImageRegionHandler:
    """The handler over a data directory of chunked pyramids."""
    return ImageRegionHandler(ImageRegionServices(
        pixels_service=PixelsService(data_dir),
        metadata=LocalMetadataService(data_dir),
        renderer=Renderer(device),
        lut_provider=LutProvider(lut_root),
        jpeg_host_max_px=jpeg_host_max_px,
    ))


def create_app(data_dir: str, lut_root: Optional[str] = None,
               device: Union[str, torch.device] = "cuda",
               handler: Optional[ImageRegionHandler] = None):
    """The aiohttp application serving the render routes.  ``handler``
    overrides the one built from ``data_dir``/``lut_root``/``device``."""
    from aiohttp import web

    handler = handler or build_handler(data_dir, lut_root, device)

    def status_of(e: Exception) -> web.Response:
        # The reference's empty 404/500 bodies
        # (ImageRegionMicroserviceVerticle.java:314-323); never a traceback.
        if isinstance(e, BadRequestError):
            return web.Response(status=400, text=str(e))
        if isinstance(e, (NotFoundError, FileNotFoundError)):
            return web.Response(status=404)
        log.exception("render failed", exc_info=e)
        return web.Response(status=500)

    async def render_image_region(request: web.Request) -> web.Response:
        params = dict(request.query)
        params.update(request.match_info)
        params.pop("tail", None)
        try:
            ctx = ImageRegionCtx.from_params(params)
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

    app = web.Application()
    for prefix in ("webgateway", "webclient"):
        for route in ("render_image_region", "render_image"):
            base = f"/{prefix}/{route}/{{imageId}}/{{theZ}}/{{theT}}"
            app.router.add_get(base, render_image_region)
            app.router.add_get(base + "/{tail:.*}", render_image_region)
    app.router.add_get("/healthz", healthz)
    app.router.add_route("OPTIONS", "/{tail:.*}", details)
    return app
