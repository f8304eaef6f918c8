"""The HTTP service: the render routes with the JAX default app's front.

Routes (the reference's, ``ImageRegionMicroserviceVerticle.java:214-231``;
trailing segments are tolerated as its ``:theT*`` patterns are):

  GET|HEAD /webgateway/render_image_region/{imageId}/{theZ}/{theT}[/...]
  GET|HEAD /webgateway/render_image/{imageId}/{theZ}/{theT}[/...]
  (the same two under /webclient)
  GET /metrics       Prometheus text exposition
  GET /healthz       liveness
  OPTIONS /          the feature document

Around the render path, as the JAX default app (``create_app(AppConfig())``
there) has it:

* **Conditional HTTP** (``server.httpcache``): every 200 carries an ETag
  from the render identity and the epoch, ``Cache-Control`` and ``Vary`` by
  whether the image is readable anonymously, and ``Last-Modified``.  A
  matching ``If-None-Match``, or a fresh ``If-Modified-Since`` alone, gets
  a 304 and a HEAD gets the headers, before single-flight, admission or any
  render (:func:`conditional_answer` decides).  No error carries cache
  headers.
* **Request traces** (``utils.telemetry``): each render request opens a
  trace and its deadline scope; its duration and status feed
  ``imageregion_request_duration_ms`` and ``imageregion_requests_total``.
* **Admission** (503 + ``Retry-After`` past ``admission-max-queue`` renders
  in flight, or when the estimated wait passes the deadline) and the
  **watchdog** over the batcher's lanes.
* **Status mapping** (``server.errors``).

:class:`Front` holds all of it without aiohttp, so a caller can drive the
route without a socket; :func:`create_app` puts it behind aiohttp, which is
imported there.  Left out: the chunked first-tile-out response body of the
JAX app (``wire.streaming``): the port answers with the same bytes in one
body (ROADMAP Queue 1).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Mapping, Optional, Union

import torch

from .. import __version__, codecs
from ..io.devicecache import DeviceRawCache
from ..io.service import PixelsService
from ..ops.lut import LutProvider
from ..ops.render import resolve_device
from ..services.metadata import LocalMetadataService
from ..utils import faultinject, telemetry
from ..utils.stopwatch import span_lines
from ..utils.transient import DeadlineExceededError, deadline_scope
from . import httpcache
from .admission import AdmissionController
from .batcher import BatchingRenderer
from .config import AppConfig
from .ctx import ImageRegionCtx
from .errors import BadRequestError, NotFoundError, OverloadedError
from .handler import (JPEG_HOST_MAX_PX, ImageRegionHandler,
                      ImageRegionServices, Renderer)
from .singleflight import SingleFlight
from .watchdog import Watchdog, build_watchdog

log = logging.getLogger("omero_ms_image_region_tpu_torch.server")

PROVIDER = "ImageRegionMicroservice"
FEATURES = ["flip", "png-tiles"]
ROUTES = ("render_image_region", "render_image")


def build_services(config: AppConfig,
                   device: Union[str, torch.device] = "cuda"
                   ) -> ImageRegionServices:
    """The render stack a config describes (the JAX ``build_services``):
    the batching renderer (or, with ``batcher.enabled`` off, the direct
    :class:`Renderer`), the device raw cache, single-flight and admission,
    each as its section says.  Installs the fault injector when the config
    gives it a seed."""
    if config.fault_injection.seed is not None:
        faultinject.install(config.fault_injection)
    device = resolve_device(device)
    b = config.batcher
    renderer = (BatchingRenderer(device, max_batch=b.max_batch,
                                 linger_ms=b.linger_ms,
                                 pipeline_depth=b.pipeline_depth,
                                 device_lanes=b.device_lanes)
                if b.enabled else Renderer(device))
    rc = config.raw_cache
    ft = config.fault_tolerance
    return ImageRegionServices(
        pixels_service=PixelsService(config.data_dir),
        metadata=LocalMetadataService(config.data_dir),
        renderer=renderer,
        lut_provider=LutProvider(config.lut_root),
        max_tile_length=config.max_tile_length,
        jpeg_host_max_px=config.renderer.cpu_fallback_max_px,
        raw_cache=(DeviceRawCache(rc.max_bytes, device=device,
                                  digest_index=rc.digest_dedup)
                   if rc.enabled else None),
        single_flight=SingleFlight() if config.single_flight else None,
        admission=(AdmissionController(ft.admission_max_queue,
                                       renderer=renderer,
                                       retry_after_s=ft.shed_retry_after_s)
                   if ft.admission_max_queue > 0 else None),
    )


def build_handler(data_dir: str, lut_root: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda",
                  jpeg_host_max_px: int = JPEG_HOST_MAX_PX,
                  batcher: bool = True) -> ImageRegionHandler:
    """The handler over a data directory of chunked pyramids, in the JAX
    app's default posture: the batching renderer (max_batch 8, linger
    2 ms, pipeline depth 4, 2 device lanes), the device raw cache (2 GiB,
    digest dedup off), single-flight and admission (512).

    ``batcher=False`` builds the reference the tests hold the default
    against: the direct :class:`Renderer` (one B=1 launch of each kernel
    per request), with no raw cache, single-flight or admission."""
    config = AppConfig(data_dir=data_dir, lut_root=lut_root)
    config.renderer.cpu_fallback_max_px = jpeg_host_max_px
    if not batcher:
        config.batcher.enabled = config.raw_cache.enabled = False
        config.single_flight = False
        config.fault_tolerance.admission_max_queue = 0
    return ImageRegionHandler(build_services(config, device))


def conditional_answer(headers: Mapping[str, str], method: str,
                       etag: Optional[str],
                       mtime: Optional[float]) -> Optional[int]:
    """The renderless answer to a request, for a caller that may read the
    image: 304 for a matching ``If-None-Match``, or for an
    ``If-Modified-Since`` alone against a fresh ``mtime`` (the ETag wins
    when both are sent, RFC 9110); 200 headers-only for a HEAD; None when
    the request must be rendered.  Counts the conditional arrivals."""
    inm = headers.get("If-None-Match")
    ims = headers.get("If-Modified-Since")
    if etag is not None and inm:
        telemetry.HTTPCACHE.count_etag_request()
        if httpcache.if_none_match_matches(inm, etag):
            return 304
    elif not inm and mtime is not None and ims:
        telemetry.HTTPCACHE.count_ims_request()
        if httpcache.not_modified_since(ims, mtime):
            return 304
    return 200 if method == "HEAD" else None


@dataclass
class Answer:
    """An HTTP answer: status, headers (``Content-Type`` included) and
    body."""

    status: int
    headers: dict = field(default_factory=dict)
    body: bytes = b""


def _json(status: int, doc: dict, **headers) -> Answer:
    return Answer(status, dict(headers, **{
        "Content-Type": "application/json; charset=utf-8"}),
                  json.dumps(doc).encode())


class Front:
    """The default app's render route without a socket: session, header
    layer, conditional answers, the handler, status mapping and request
    accounting."""

    def __init__(self, config: AppConfig, handler: ImageRegionHandler):
        self.config = config
        self.handler = handler
        hc = config.http_cache
        if hc.enabled and hc.epoch == httpcache.EPOCH_AUTO:
            # Derived once at startup from the data tree's source stamps.
            hc.epoch = httpcache.derive_epoch(config.data_dir)
            if hc.epoch == "0":
                log.warning("http-cache.epoch: auto derived '0' (no "
                            "ingest stamps under %r)", config.data_dir)
        self.session_required = bool(config.session_store_required)

    def session_key(self, cookies: Mapping[str, str]) -> Optional[str]:
        """The static store: the session cookie's value is the key."""
        if self.config.session_store_type != "static":
            return None
        return cookies.get(self.config.session_cookie_name) or None

    def status_of(self, e: Exception) -> Answer:
        """The reference's empty 404/500 bodies
        (``ImageRegionMicroserviceVerticle.java:314-323``) and the JAX
        app's fault-tolerance statuses; never a traceback."""
        if isinstance(e, BadRequestError):
            return Answer(400, {"Content-Type": "text/plain; charset=utf-8"},
                          str(e).encode())
        if isinstance(e, (NotFoundError, FileNotFoundError)):
            return Answer(404)
        if isinstance(e, OverloadedError):
            return _json(503, {"error": str(e)}, **{
                "Retry-After": str(max(1, round(e.retry_after_s)))})
        if isinstance(e, ConnectionError):
            # The watchdog escalated a stuck lane: a 503 the client
            # retries through, not a server bug.
            telemetry.RESILIENCE.count_shed("sidecar-unreachable")
            retry = max(1, round(
                self.config.fault_tolerance.shed_retry_after_s))
            return _json(503, {"error": "render backend unreachable"},
                         **{"Retry-After": str(retry)})
        if isinstance(e, DeadlineExceededError):
            return _json(504, {"error": str(e)})
        log.exception("render failed", exc_info=e)
        return Answer(500)

    async def _acl_gated(self, image_id: int) -> bool:
        """Is the image private for edge caches (not readable
        anonymously)?  Errs toward private."""
        if not self.config.http_cache.vary_acl:
            return True
        try:
            return not await self.handler.can_read(image_id, None)
        except Exception:
            return True

    async def cache_headers(self, headers: dict,
                            ctx: ImageRegionCtx) -> Optional[str]:
        """Stamp ETag, Cache-Control and Vary onto ``headers``; return the
        ETag (None with conditional HTTP off, when only the legacy
        ``cache-control-header`` applies)."""
        hc, legacy = self.config.http_cache, self.config.cache_control_header
        if not hc.enabled:
            if legacy:
                headers["Cache-Control"] = legacy
            return None
        etag = httpcache.etag_for(ctx.cache_key, hc.epoch)
        headers["ETag"] = etag
        cc, vary = httpcache.cache_headers(
            hc.max_age_s, await self._acl_gated(ctx.image_id))
        headers["Cache-Control"] = legacy or cc
        if vary:
            headers["Vary"] = vary
        return etag

    async def source_mtime(self, image_id: int) -> Optional[float]:
        """The image's source mtime for ``Last-Modified`` (the memo's
        inline hit, else one thread hop)."""
        if not self.config.http_cache.enabled:
            return None
        metadata = self.handler.s.metadata
        hit, value = metadata.source_mtime_cached(image_id)
        if hit:
            return value
        try:
            return await asyncio.to_thread(metadata.source_mtime, image_id)
        except Exception:
            return None

    async def render(self, method: str, params: dict,
                     headers: Mapping[str, str],
                     cookies: Mapping[str, str]) -> Answer:
        """One ``render_image_region`` / ``render_image`` request."""
        session = self.session_key(cookies)
        if session is None and self.session_required:
            return Answer(403)
        try:
            ctx = ImageRegionCtx.from_params(params, session)
        except BadRequestError as e:
            return self.status_of(e)
        out = {"Content-Type": codecs.CONTENT_TYPES.get(
            ctx.format, "application/octet-stream")}
        etag = await self.cache_headers(out, ctx)
        mtime = httpcache.last_modified_basis(
            await self.source_mtime(ctx.image_id),
            self.config.http_cache.epoch)
        if mtime is not None:
            out["Last-Modified"] = httpcache.http_date(mtime)
        status = conditional_answer(headers, method, etag, mtime)
        if status is not None:
            try:
                readable = await self.handler.can_read(ctx.image_id,
                                                       ctx.omero_session_key)
            except Exception:
                readable = False
            if readable:
                if status == 304:
                    telemetry.HTTPCACHE.count_not_modified()
                else:
                    telemetry.HTTPCACHE.count_head()
                return Answer(status, out)
        try:
            body = await self.handler.render_image_region(ctx)
        except Exception as e:
            return self.status_of(e)
        return Answer(200, out, body)

    async def observed(self, route: str, method: str, params: dict,
                       headers: Mapping[str, str],
                       cookies: Mapping[str, str]) -> Answer:
        """:meth:`render` in a request trace and its deadline scope; its
        duration and status feed the request series.  A cancelled request
        (the client went away) is counted as 499."""
        trace_id = telemetry.new_trace_id()
        t0 = time.perf_counter()
        try:
            with telemetry.trace_scope(trace_id, route), deadline_scope(
                    self.config.fault_tolerance.request_deadline_ms):
                answer = await self.render(method, params, headers, cookies)
        except BaseException:
            telemetry.TRACES.finish(trace_id)
            telemetry.count_request(route, 499)
            raise
        telemetry.TRACES.finish(trace_id)
        telemetry.REQUEST_HIST.observe(
            route, (time.perf_counter() - t0) * 1000.0)
        telemetry.count_request(route, answer.status)
        return answer

    def metrics_text(self) -> str:
        """The ``/metrics`` body (Prometheus text exposition)."""
        return telemetry.finalize_exposition(
            telemetry.request_metric_lines() + span_lines()
            + telemetry.resilience_metric_lines()
            + telemetry.device_metric_lines(self.handler.s))


def configure_logging(config: AppConfig) -> None:
    """Console always; a time-rolling file appender when
    ``logging.file`` is set."""
    import logging.handlers
    import os

    level = getattr(logging, config.logging.level.upper(), logging.INFO)
    fmt = logging.Formatter("%(asctime)s [%(threadName)s] %(levelname)-5s "
                            "%(name)s - %(message)s")
    root = logging.getLogger()
    root.setLevel(level)
    handlers = [logging.StreamHandler()]
    if config.logging.file:
        os.makedirs(os.path.dirname(config.logging.file) or ".",
                    exist_ok=True)
        handlers.append(logging.handlers.TimedRotatingFileHandler(
            config.logging.file, when=config.logging.when,
            backupCount=config.logging.backup_count))
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)


def create_app(config: Optional[AppConfig] = None,
               device: Union[str, torch.device] = "cuda",
               handler: Optional[ImageRegionHandler] = None):
    """The aiohttp application a config describes (default: the JAX
    defaults, ``AppConfig()``).  ``handler`` overrides the one built from
    the config (the test seam).  Startup sets the executor size
    (``worker_pool_size``) and starts the watchdog; cleanup stops it and
    closes the handler's renderer."""
    import concurrent.futures as cf
    import os

    from aiohttp import web

    config = config or AppConfig()
    for name in config.unserved:
        log.warning("%s is switched on, but the port has no byte caches "
                    "yet: it serves every request by rendering", name)
    handler = handler or ImageRegionHandler(build_services(config, device))
    front = Front(config, handler)
    watchdog: Optional[Watchdog] = None
    if config.watchdog.enabled:
        watchdog = build_watchdog(
            config.watchdog, renderer=handler.s.renderer,
            escalate_cb=lambda e: log.error(
                "watchdog escalation: %s on %s", e.get("action"),
                e.get("target")))

    def to_response(answer: Answer) -> web.Response:
        return web.Response(status=answer.status, headers=answer.headers,
                            body=answer.body or None)

    def route_handler(route: str):
        async def serve(request: web.Request) -> web.Response:
            params = dict(request.query)
            params.update(request.match_info)
            # The tail never reaches the params: /7/0/0 and /7/0/0/ share
            # a cache key and an ETag.
            params.pop("tail", None)
            return to_response(await front.observed(
                route, request.method, params, request.headers,
                request.cookies))
        return serve

    async def metrics(request: web.Request) -> web.Response:
        return web.Response(text=front.metrics_text(),
                            content_type="text/plain")

    async def details(request: web.Request) -> web.Response:
        doc = {"provider": PROVIDER, "version": __version__,
               "features": FEATURES,
               "options": {"maxTileLength": handler.s.max_tile_length}}
        if config.cache_control_header:
            doc["options"]["cacheControl"] = config.cache_control_header
        return web.json_response(doc)

    async def healthz(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    tasks: list = []

    async def on_startup(app: web.Application) -> None:
        workers = config.worker_pool_size or 2 * (os.cpu_count() or 4)
        asyncio.get_running_loop().set_default_executor(
            cf.ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="render-worker"))
        if watchdog is not None and watchdog._targets:
            tasks.append(asyncio.create_task(watchdog.run(),
                                             name="watchdog"))

    async def on_cleanup(app: web.Application) -> None:
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await handler.s.renderer.close()

    app = web.Application()
    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    for prefix in ("webgateway", "webclient"):
        for route in ROUTES:
            base = f"/{prefix}/{route}/{{imageId}}/{{theZ}}/{{theT}}"
            serve = route_handler(route)
            app.router.add_get(base, serve)          # GET and HEAD
            app.router.add_get(base + "/{tail:.*}", serve)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/healthz", healthz)
    app.router.add_route("OPTIONS", "/{tail:.*}", details)
    return app


def run_app(app, config: AppConfig) -> None:
    """Serve on ``config.port`` with the config's HTTP parse limits (the
    reference's ``max-initial-line-length`` / ``max-header-size``, as
    aiohttp's ``max_line_size`` / ``max_field_size`` / ``max_headers``)
    until SIGINT or SIGTERM."""
    import signal

    from aiohttp import web

    async def serve() -> None:
        runner = web.AppRunner(
            app, max_line_size=config.http.max_initial_line_length,
            max_field_size=config.http.max_header_size,
            max_headers=config.http.max_headers)
        await runner.setup()
        await web.TCPSite(runner, port=config.port).start()
        log.info("serving on :%d", config.port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        try:
            await stop.wait()
        finally:
            await runner.cleanup()

    asyncio.run(serve())
