"""The HTTP service: the JAX default app's routes and its front.

Routes (the reference's, ``ImageRegionMicroserviceVerticle.java:214-231``;
trailing segments are tolerated as its ``:theT*`` patterns are):

  GET|HEAD /webgateway/render_image_region/{imageId}/{theZ}/{theT}[/...]
  GET|HEAD /webgateway/render_image/{imageId}/{theZ}/{theT}[/...]
  (the same two under /webclient)
  GET|HEAD /webgateway/render_shape_mask/{shapeId}[/...]
  GET|HEAD /webgateway/render_overlay/{imageId}/{theZ}/{theT}[/...]
      ?shapes=<id,id,...>[&color=] : the region as PNG with the masks
      blended in request order (404 with ``workloads.overlay-enabled``
      off)
  GET /webgateway/render_animation/{imageId}/{theZ}/{theT}[/...]
      ?axis=z|t&frames=N : N frames from the URL's theZ or theT, streamed
      as ``FRME`` + u32be length + frame records (404 with
      ``workloads.animation-enabled`` off)
  POST /pyramid {"imageId": N} | {"path": dir}
      queue a background build of an unpyramided image's levels
      (``server.jobs``; K9 on the card), 202 + the job document; the same
      404 and 400s as the JAX app (404 with ``pyramid.enabled`` off)
  GET /pyramid/{jobId}  the job document
  GET /metrics       Prometheus text exposition; with ``Accept:
                     application/openmetrics-text`` the OpenMetrics one,
                     whose latency buckets carry trace-id exemplars
  GET /healthz       liveness
  GET /readyz        readiness: 200 ``{"status": "ready", "checks":
                     {"prewarm": "complete", "queue": "ok", "sentinel":
                     "ok"}}``, or 503 ``"degraded"`` while the startup
                     prewarm runs or failed, or past
                     ``telemetry.ready-max-queue-depth`` queued tiles
                     (:meth:`Front.ready`)
  GET /debug/warmstate       the warm-state document (``?snapshot=1``)
  GET /debug/flightrecorder  the flight recorder's ring (``?dump=1``)
  GET /debug/costs           the top-K expensive requests, shape costs
  GET /debug/decisions       the decision ledger
  GET /debug/exemplars       the latency buckets' trace ids
  GET /debug/sentinel        the perf sentinel's view
  GET /debug/profile?ms=N    a ``torch.profiler`` capture (Chrome trace)
  GET /debug/explain?path=U  the dry-run explain document of a render URL
  GET|POST /admin/drain[?member=mN]  the fleet's drain states; POST drains
                     the member (400 for an unknown member or without a
                     fleet, 409 for the last routable one)
  POST /admin/undrain?member=mN      rejoins a drained member
  GET /admin/autoscaler  the autoscaler's status (``autoscaler.enabled``
                     with a fleet), else JAX's 400 body
  GET /admin/federation  the federation's status (``?agree=1`` runs a
                     non-strict agreement round first), else JAX's 400
                     body
  OPTIONS /          the feature document

Around the render path, as the JAX default app (``create_app(AppConfig())``
there) has it:

* **Conditional HTTP** (``server.httpcache``): every image, mask and
  overlay 200 carries an ETag from the render identity and the epoch, and
  ``Cache-Control`` and ``Vary`` by whether the object is readable
  anonymously; an image also ``Last-Modified`` (masks have no source
  stamp; an overlay's identity folds its shapes and colour).  A
  matching ``If-None-Match``, or a fresh ``If-Modified-Since`` alone, gets
  a 304 and a HEAD gets the headers, before single-flight, admission or any
  render (:func:`conditional_answer` decides).  No error carries cache
  headers.
* **Request traces** (``utils.telemetry``): each render request opens a
  trace and its deadline scope; its duration and status feed
  ``imageregion_request_duration_ms`` and ``imageregion_requests_total``,
  its cost ledger the ``imageregion_request_cost_*`` histograms and the
  top-K of expensive requests, and its provenance record
  (``utils.provenance``: 304, byte cache, warm raw cache or cold render,
  coalesced) the ``imageregion_provenance_*`` counters and, under
  ``telemetry.provenance-header``, the ``X-Image-Region-Provenance``
  header of a success.  With ``telemetry.access-log`` (on by default)
  each traced request writes one JSON line to the logger
  ``omero_ms_image_region_tpu_torch.access``: ``ts``, ``trace``,
  ``route``, ``status``, ``bytes``, ``ms``, ``queue_ms``, ``render_ms``
  (the render's await less its queue wait), ``encode_ms``, ``cache``,
  ``cost`` and, for a success, ``prov``, as the JAX app writes them.
* **Readiness** (``server.prewarm``): with ``renderer.prewarm`` the
  kernels are built and launched at every batch size on a background
  thread at startup, and ``/readyz`` answers 503 ``pending`` until they
  are, and 503 with the reason if that failed.  With persistence on it
  also carries the boot rehydrate's state (``rehydrate``: ``running N/M``
  ... ``done N/M``), never a reason to be unready; so are its ``slo``,
  ``sentinel``, ``pressure`` and, with a fleet, ``fleet`` and ``drain``
  annotations (``drain.fail-readyz`` makes an operator drain a 503).
* **Forensics and overload** (:meth:`Front._forensics`): the SLO engine
  (``slo``; a breach dumps the flight recorder), the decision ledger
  (``decisions``), the perf sentinel (``sentinel``, on by default: each
  success's latency sketched by route and size, drift confirmed over
  ticks, an incident bundle with a ``torch.profiler`` trace in
  ``sentinel.bundle-dir``) and the pressure governor (``pressure``, off by
  default: the brownout ladder of ``server.pressure``).  The two tick
  loops run as tasks beside the watchdog's.  Each success's trace id and
  provenance tier become its latency bucket's exemplar; past
  ``telemetry.slow-request-ms`` a request's waterfall is written to
  ``telemetry.slow-request-dir``.
* **Warm restarts** (``persistence.enabled``, off by default): the disk
  byte tier in each named cache's chain (``services.diskcache``), the
  build store that keeps the nvcc and g++ libraries across deploys
  (``server.execcache``), and the warm-state manifest, written every
  ``snapshot-interval-s`` and on SIGTERM and replayed on boot
  (``services.warmstate``).  ``GET /debug/warmstate`` reports it
  (``?snapshot=1`` writes the manifest now).
* **The flight recorder** (``utils.telemetry.FLIGHT``, sized by
  ``telemetry.flight-recorder-events``): ``GET /debug/flightrecorder``
  serves the ring, ``?dump=1`` also writes it to
  ``telemetry.flight-recorder-dir``.  On SIGTERM or SIGINT
  :func:`run_app` records the signal and runs the shutdown chain
  (``server.shutdown``: snapshot, build-store drain, flight dump) before
  the services close.
* **Sessions** (``services.sessions``): the session cookie resolves to
  the OMERO session key through the configured store
  (:func:`make_session_store`: static, the Redis or the Postgres
  ``django_session`` store); with enforcement on (:func:`session_required`:
  the default for redis and postgres) a cookie that does not resolve gets
  a 403 before anything else runs.
* **Metadata and ACL**: the data directory's (``services.metadata``), or,
  with ``metadata-service.type: postgres``, the OMERO database's
  (``services.db_metadata``), connected at startup from the DSN (or built
  on the ``db`` connection given to :func:`create_app`), with the image
  pixels then opened from ``omero.data.dir`` when the data directory lacks
  them.
* **Admission** (503 + ``Retry-After`` past ``admission-max-queue`` renders
  in flight, or when the estimated wait passes the deadline; an overlay's
  base and each animation frame are renders of the image route; a mask
  has no global admission leg in the JAX app either), with
  ``sessions.enabled`` the per-session fairness tokens (the image route's
  and the mask route's, 503 with reason ``fairness``), and the
  **watchdog** over the batcher's lanes.
* **Prefetch** (``raw-cache.prefetch``, on by default): the predicted next
  tiles of each GET staged into the raw cache (``services.prefetch``),
  along each session's pan with ``sessions.enabled``.
* **Byte caches** (``services.cache``): the image-region, pixels-metadata
  and shape-mask caches each config block switches on, a native LRU in
  front of the shared Redis tier of ``redis-cache.uri`` (without the
  ``redis`` package: the LRU alone, with a warning), and the canRead memo
  sharing its answers through the same Redis client.  A mask GET asks the
  shape-mask cache before its session's fairness token, as in the JAX app.
* **The JPEG wire engine** (``renderer.jpeg-engine``): ``sparse`` or
  ``huffman`` for every group; ``auto`` probes the device-to-host rate at
  startup (``utils.linkprobe``) and, in the batched posture, keeps the
  choice live (``utils.adaptive``, fed by the wire fetches).
* **Status mapping** (``server.errors``).
* **Chunked responses** (``wire.streaming``, on by default, as in the JAX
  app, ``:1162-1238``): a render 200 leaves as an HTTP chunked response.
  Its first chunk is awaited before the headers, so a failure before the
  body keeps its status; the ``http.firstByte`` span ends when the first
  chunk is written.  ``wire.streaming: false`` gives the one body with a
  ``Content-Length``.  The bytes are the same either way.
* **The frontend role** (``sidecar.role: frontend`` with ``sidecar.socket``;
  JAX ``:409-566``): the app builds no device services and never touches
  the card.  Renders and masks go over the sidecar wire
  (``server.sidecar``: the breaker and op-aware retries of
  ``fault-tolerance``, the chunk frames forwarded as they arrive), and with
  ``fault-tolerance.degraded-mode`` a dead sidecar's renders come from the
  frontend's CPU (``server.degraded``), counted and marked ``degraded``.
  As in the JAX frontend: a 304 answers on the ETag alone, a HEAD runs the
  request, there is no ``Last-Modified``, the overlay, animation and
  pyramid routes answer 404, ``/readyz`` pings the sidecar, ``/metrics``
  and ``/debug/flightrecorder`` merge the sidecar's, ``/debug/sentinel``
  its view, and ``/debug/profile``, ``/debug/warmstate`` and the explain
  plane's residency are the sidecar's.
* **The fleet** (``fleet.enabled``; ``parallel.fleet``, JAX ``:452-690``):
  in the combined role, ``fleet.members`` in-process members (member 0 the
  base stack, the others each with its own renderer and raw cache on the
  app's card) behind a ``FleetRouter``; a ``frontend`` with
  ``fleet.sockets`` routes over one sidecar per address.  Single-flight
  and admission move above the router (``FleetImageHandler``), the
  prefetcher stages into the owning member's shard, the watchdog watches
  every member's batcher or wire, ``/metrics`` adds the fleet, hot-key and
  drain families, ``/readyz`` the members' states, and the mask route asks
  the mask's ring authority's byte tier before a render (remote members
  only).  A frontend fleet's ``/debug/flightrecorder`` and
  ``/debug/decisions`` merge every member's ring (``ring`` and ``ledger``,
  by time, each event stamped with its member and, in a federation, its
  host; ``members`` the raw rings); its other ``/debug/*`` ride member 0's
  sidecar.
* **The federation** (``federation.enabled``; ``parallel.federation``, JAX
  ``:576-670``; :func:`build_federated_fleet`): the combined role builds
  its members from the manifest (this host's in-process, each pinned to
  its share of the CUDA devices; the others ``RemoteMember`` handles over
  their sidecar addresses) behind a router seeded by the manifest, with
  the cross-host drain handoff, the quorum tracker (``federation.quorum``),
  the roll hook (an epoch commit swaps the ring) and the prefetcher's
  remote seam.  At startup the app runs one strict agreement round (a
  split brain refuses to start), then the gossip task; at shutdown it
  uninstalls the manifest.  ``/readyz`` carries the ``federation``
  annotation and ``GET /admin/federation`` the status.
* **The autoscaler** (``autoscaler.enabled`` with a fleet;
  ``server.autoscaler``, JAX ``:812-870``; :meth:`Front._elastic`): a tick
  task that parks members by ``autoscale`` drains and rejoins them by
  undrains, ``GET /admin/autoscaler`` and ``/readyz``'s ``autoscaler``
  annotation; with ``autoscaler.unit-config`` a ``fleet.sockets`` frontend
  spawns its members' sidecars at startup, before ``/readyz`` passes, and
  stops them at cleanup.
* **Mesh serving** (``parallel.enabled``; ``parallel.serve``, JAX
  ``:170-233``): :func:`build_mesh_renderer` joins the process group of
  the ``parallel`` section (``parallel.cluster``: one process per GPU,
  rank 0 the leader, the others ``--role pod-worker``), builds the global
  ``(data, chan)`` mesh and serves every group through a
  ``MeshRenderer`` (K12a, K12b, then K3 and K4a or K5); no startup
  prewarm for it, as in JAX.  The build store keeps serving K12's
  library: JAX keeps its mesh programs out of its executable cache
  because serialized XLA programs are bound to a topology, and the
  port's libraries are not.

:class:`Front` holds all of it without aiohttp, so a caller can drive the
route without a socket; :func:`create_app` puts it behind aiohttp, which is
imported there.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable, Mapping, Optional, \
    Tuple, Union

import torch

from .. import __version__, codecs
from ..io.devicecache import DeviceRawCache
from ..io.service import PixelsService
from ..ops.jpegenc import set_fetch_observer
from ..ops.lut import LutProvider
from ..ops.render import resolve_device
from ..parallel.fleet import (FleetImageHandler, FleetRouter,
                              RemoteMember, build_local_members)
from ..services.cache import Caches
from ..services.db_metadata import (DbMetadataService,
                                    PostgresMetadataService)
from ..services.metadata import CanReadMemo, LocalMetadataService
from ..services.prefetch import TilePrefetcher
from ..services.sessions import (DjangoPostgresSessionStore,
                                 DjangoRedisSessionStore, SessionStore,
                                 StaticSessionStore, resolve_session_key)
from ..services.viewport import ViewportTracker
from ..services.warmstate import WarmStateManager
from ..utils import decisions, faultinject, linkprobe, provenance, telemetry
from ..utils.adaptive import AdaptiveEngine
from ..utils.stopwatch import span_lines
from ..utils.transient import DeadlineExceededError, deadline_scope
from . import execcache, explain, httpcache
from . import pressure as pressure_mod
from . import sentinel as sentinel_mod
from .admission import AdmissionController, SessionTokenBuckets
from .batcher import BatchingRenderer
from .config import AppConfig
from .ctx import ImageRegionCtx, ShapeMaskCtx
from .errors import BadRequestError, NotFoundError, OverloadedError
from .handler import (JPEG_HOST_MAX_PX, ImageRegionHandler,
                      ImageRegionServices, Renderer, ShapeMaskHandler,
                      WorkloadsHandler)
from .jobs import PyramidJobManager
from .singleflight import SingleFlight
from .watchdog import Watchdog, build_watchdog

log = logging.getLogger("omero_ms_image_region_tpu_torch.server")
access_log = logging.getLogger("omero_ms_image_region_tpu_torch.access")

PROVIDER = "ImageRegionMicroservice"
FEATURES = ["flip", "mask-color", "png-tiles"]
ROUTES = ("render_image_region", "render_image")
ANIMATION_CONTENT_TYPE = "application/x-image-region-animation"


def session_required(config: AppConfig) -> bool:
    """Is a resolved session required?  ``session-store.required`` when
    set, else on for the redis and postgres stores (the reference's session
    handler is mandatory, ``ImageRegionMicroserviceVerticle.java:199-212``)
    and off for a static store or none."""
    if config.session_store_required is not None:
        return config.session_store_required
    return config.session_store_type in ("redis", "postgres")


def make_session_store(config: AppConfig,
                       db=None) -> Optional[SessionStore]:
    """The session store the config names, as the JAX app builds it: a
    store that cannot be built (no uri, no driver) refuses the start with
    a ``ValueError`` when sessions are required, else logs a warning and
    serves without sessions; an unknown type is a ``ValueError``.  ``db``
    (an open ``AsyncDb``) carries the postgres store in place of a
    connection from the uri."""
    required = session_required(config)
    kind = config.session_store_type

    def unavailable(msg: str) -> None:
        if required:
            raise ValueError(f"session enforcement is on but {msg}")
        log.warning("%s; sessions disabled", msg)

    if kind == "static":
        return StaticSessionStore(accept_all=True)
    if kind == "redis":
        if not config.session_store_uri:
            unavailable("session-store.type is 'redis' with no uri")
            return None
        try:
            return DjangoRedisSessionStore(config.session_store_uri)
        except ImportError:
            unavailable("the redis package is unavailable")
            return None
    if kind == "postgres":
        if db is not None:
            return DjangoPostgresSessionStore.on_db(db)
        if not config.session_store_uri:
            unavailable("session-store.type is 'postgres' with no uri")
            return None
        try:
            return DjangoPostgresSessionStore(config.session_store_uri)
        except ImportError:
            unavailable("no async postgres driver (asyncpg/psycopg) "
                        "is available")
            return None
    if kind is not None:
        raise ValueError(f"invalid session-store.type {kind!r} (expected "
                         f"redis | postgres | static)")
    if required:
        raise ValueError("session-store.required is true but no "
                         "session-store.type is configured")
    return None


def build_services(config: AppConfig,
                   device: Union[str, torch.device] = "cuda",
                   db=None) -> ImageRegionServices:
    """The render stack a config describes (the JAX ``build_services``):
    the batching renderer with its wire engine (or, with
    ``batcher.enabled`` off, the direct :class:`Renderer`), the device raw
    cache and its prefetcher, single-flight, admission (with the session
    buckets when ``sessions.enabled``), the byte caches and the canRead
    memo on their Redis tier, each as its section says.  With
    ``persistence.enabled``: the disk byte tier under ``<dir>/bytecache``,
    the build store under ``<dir>/executables`` (handed to both build
    helpers, and kept as the renderer's ``exec_cache``) and the
    warm-state manager, whose rehydrate starts here.
    With ``metadata-service.type: postgres`` and an open ``db``
    (``AsyncDb``) the metadata service is the OMERO database's; without
    ``db`` the app connects it at startup.  Installs the fault injector
    when the config gives it a seed."""
    if config.fault_injection.seed is not None:
        faultinject.install(config.fault_injection)
    telemetry.FLIGHT.configure(config.telemetry.flight_recorder_events)
    device = resolve_device(device)
    persistence = config.persistence
    store = None
    if persistence.enabled:
        if not config.caches.disk_dir:
            # The durable byte tier, between memory and Redis in each
            # named cache's chain.
            config.caches.disk_dir = os.path.join(persistence.dir,
                                                  "bytecache")
            config.caches.disk_max_bytes = persistence.disk_cache_max_bytes
        if persistence.executables:
            # Before anything builds: the native LRU tier below, the
            # prewarm and the first requests all load through it.
            store = execcache.ExecutableCache(
                os.path.join(persistence.dir, "executables"), device)
            execcache.install(store)
    b = config.batcher
    engine = config.renderer.jpeg_engine
    if config.parallel.enabled:
        renderer = build_mesh_renderer(config, device)
        # The raw cache and the prefetcher stage onto the leader's GPU.
        device = renderer.device
    elif b.enabled:
        controller = None
        if engine == "auto":
            # The startup probe picks the opening engine; the controller
            # keeps the choice live from the wire fetches (EWMA,
            # hysteresis, a probe again after idle).
            try:
                rate = linkprobe.measure_fetch_mb_s(device=device)
            except Exception:
                rate = None
            controller = AdaptiveEngine(
                initial_rate_mb_s=rate,
                probe=lambda: linkprobe.measure_fetch_mb_s(
                    nbytes=1 << 20, repeats=2, device=device))
            set_fetch_observer(controller.observe_fetch)
            engine = controller.engine
            log.info("adaptive jpeg engine enabled (opening: %s)", engine)
        renderer = BatchingRenderer(device, max_batch=b.max_batch,
                                    linger_ms=b.linger_ms,
                                    pipeline_depth=b.pipeline_depth,
                                    device_lanes=b.device_lanes,
                                    jpeg_engine=engine,
                                    engine_controller=controller,
                                    max_batch_limit=b.max_batch_limit,
                                    target_inflight=b.target_inflight)
        # First-tile-out settlement rides the streaming knob: off, the
        # batcher settles a group's requests at its barrier.
        renderer.first_tile_out = config.wire.streaming
    else:
        if engine == "auto":
            engine = linkprobe.resolve_auto_engine(device)
        renderer = Renderer(device, jpeg_engine=engine)
    # The build store also keeps the mesh kernels' library: JAX keeps its
    # mesh programs out of its executable cache because they are bound to
    # a topology, and a K12 library is not.
    renderer.exec_cache = store
    if (config.renderer.prewarm and b.enabled
            and not config.parallel.enabled):
        # Not the mesh renderer, as in JAX: its first groups build and
        # launch K12.
        start_prewarm(config, renderer, device)
    rc, ft, se = config.raw_cache, config.fault_tolerance, config.sessions
    raw_cache = (DeviceRawCache(rc.max_bytes, device=device,
                                digest_index=rc.digest_dedup)
                 if rc.enabled else None)
    buckets = session_buckets(config)
    prefetcher = None
    if raw_cache is not None and rc.prefetch:
        # The viewport model needs sessions: without them every request
        # is anonymous, and one shared trajectory of unrelated viewers
        # would predict nothing useful (the JAX app's gate).
        prefetcher = TilePrefetcher(
            raw_cache, lookahead=se.prefetch_lookahead,
            viewport=(ViewportTracker(max_sessions=se.max_tracked)
                      if se.enabled else None))
    metadata = (DbMetadataService(db)
                if db is not None and config.metadata_backend == "postgres"
                else LocalMetadataService(config.data_dir))
    caches = Caches.from_config(config.caches)
    if config.caches.redis_uri and caches.redis is None:
        log.warning("redis package unavailable; redis cache tier and "
                    "shared canRead memo disabled")
    services = ImageRegionServices(
        pixels_service=PixelsService(config.data_dir,
                                     repo_root=config.omero_data_dir),
        metadata=metadata,
        renderer=renderer,
        lut_provider=LutProvider(config.lut_root),
        max_tile_length=config.max_tile_length,
        jpeg_host_max_px=config.renderer.cpu_fallback_max_px,
        raw_cache=raw_cache,
        single_flight=SingleFlight() if config.single_flight else None,
        admission=(AdmissionController(ft.admission_max_queue,
                                       renderer=renderer,
                                       retry_after_s=ft.shed_retry_after_s,
                                       session_buckets=buckets)
                   if ft.admission_max_queue > 0 else None),
        prefetcher=prefetcher,
        caches=caches,
        # The memo's shared tier plays the reference's Hazelcast map
        # across instances, on the caches' one Redis client
        # (ImageRegionVerticle.java:107-111).
        can_read_memo=CanReadMemo(shared=caches.redis),
    )
    if persistence.enabled:
        services.warmstate = WarmStateManager(
            persistence.dir, services,
            snapshot_interval_s=persistence.snapshot_interval_s,
            snapshot_top_k=persistence.snapshot_top_k,
            max_plane_entries=persistence.max_plane_entries,
            rehydrate_concurrency=persistence.rehydrate_concurrency)
        services.warmstate.start(rehydrate=persistence.rehydrate)
    return services


def build_mesh_renderer(config: AppConfig,
                        device: Union[str, torch.device] = "cuda"):
    """The mesh posture's renderer (JAX ``create_app`` ``:170-233``): join
    the process group of ``parallel`` (``parallel.cluster``), disarm
    fault injection on a pod, refuse a process other than rank 0 (the
    others run ``--role pod-worker``), build the global mesh and, under
    ``jpeg-engine: auto``, resolve the opening engine with the pod (every
    rank joins the probe's all-gather) and keep it live with an
    ``AdaptiveEngine`` fed by the wire fetches."""
    from ..parallel import cluster
    from ..parallel.serve import MeshRenderer

    p, b = config.parallel, config.batcher
    cluster.initialize(p.coordinator_address, p.num_processes,
                       p.process_id, device=device)
    if cluster.world_size() > 1:
        if faultinject.active() is not None:
            # Chaos on one rank would stall or fail its lockstep sequence
            # only; the config refuses a seed with an explicit pod, this
            # disarms a pod joined from the environment.
            log.warning("multi-process pod: disarming fault injection "
                        "(it would break the pod's lockstep)")
            faultinject.uninstall()
        if cluster.rank() != 0:
            raise ValueError(
                "mesh-serving leader must be process 0 of the pod; run "
                "the other processes with --role pod-worker")
    mesh = cluster.global_mesh(chan_parallel=p.chan_parallel,
                               n_devices=p.n_devices, device=device)
    engine = config.renderer.jpeg_engine
    controller = None
    if engine == "auto":
        engine = linkprobe.resolve_auto_engine(mesh.device)
        controller = AdaptiveEngine(initial_engine=engine)
        set_fetch_observer(controller.observe_fetch)
    log.info("mesh serving enabled: %s on %s (jpeg engine %s%s)",
             mesh.shape, mesh.device, engine,
             ", live" if controller is not None else "")
    renderer = MeshRenderer(mesh, max_batch=b.max_batch,
                            max_batch_limit=b.max_batch_limit,
                            linger_ms=b.linger_ms, jpeg_engine=engine,
                            pipeline_depth=b.pipeline_depth,
                            engine_controller=controller,
                            device_lanes=b.device_lanes)
    renderer.first_tile_out = config.wire.streaming
    return renderer


def session_buckets(config: AppConfig) -> Optional[SessionTokenBuckets]:
    """The per-session fairness buckets of ``sessions.enabled`` (None
    without), the ``qos`` bulk cost included."""
    se = config.sessions
    if not se.enabled:
        return None
    return SessionTokenBuckets(
        se.bucket_refill_per_s, se.bucket_burst,
        max_sessions=se.max_tracked,
        bulk_cost=(config.qos.bulk_cost if config.qos.enabled else 1.0))


def fleet_router(config: AppConfig, members: list,
                 manifest=None) -> FleetRouter:
    """The ``FleetRouter`` over ``members`` that the config's ``fleet``,
    ``qos``, ``http-cache`` and ``hotkey`` sections describe; with a
    federation's ``manifest``, its ring seed and replicas and the
    cross-host drain handoff."""
    hc = config.http_cache
    return FleetRouter(
        members, lane_width=config.fleet.lane_width,
        steal_min_backlog=config.fleet.steal_min_backlog,
        hash_replicas=(manifest.replicas if manifest is not None
                       else config.fleet.hash_replicas),
        failover=config.fleet.failover,
        qos_weight=(config.qos.interactive_weight if config.qos.enabled
                    else 0),
        peer_fetch=hc.enabled and hc.peer_fetch,
        peer_timeout_s=hc.peer_timeout_ms / 1000.0,
        ring_seed=manifest.ring_seed if manifest is not None else "",
        wire_handoff=manifest is not None,
        hotkey=config.hotkey)


def fleet_admission(config: AppConfig,
                    router: FleetRouter) -> Optional[AdmissionController]:
    """Fleet-wide admission over the router's depth and lanes (None with
    ``admission-max-queue`` 0)."""
    ft = config.fault_tolerance
    if ft.admission_max_queue <= 0:
        return None
    return AdmissionController(ft.admission_max_queue, renderer=router,
                               retry_after_s=ft.shed_retry_after_s,
                               session_buckets=session_buckets(config))


def build_local_fleet(config: AppConfig,
                      services: ImageRegionServices) -> FleetImageHandler:
    """The combined role's in-process fleet over ``services`` (JAX
    ``create_app`` ``:576-689``): ``fleet.members`` members
    (``parallel.fleet.build_local_members``) behind the router;
    single-flight and admission move from the services above it, and the
    shared prefetcher stages each prediction into the owning member's raw
    cache and a hot route's local replicas'."""
    members = build_local_members(config, services, config.fleet.members)
    return _fleet_handler(config, services, members,
                          fleet_router(config, members))


def _fleet_handler(config: AppConfig, services: ImageRegionServices,
                   members: list, router: FleetRouter) -> FleetImageHandler:
    """Single-flight and admission above ``router``, and the shared
    prefetcher's seams into its members' raw caches."""
    single_flight = services.single_flight
    services.single_flight = None
    services.admission = None
    prefetcher = services.prefetcher
    if prefetcher is not None:
        prefetcher.cache_for_route = router.cache_for_route
        prefetcher.replica_caches = router.local_replica_caches
        for member in members:
            if getattr(member, "services", None) not in (None, services):
                member.services.prefetcher = prefetcher
    return FleetImageHandler(router, single_flight=single_flight,
                             admission=fleet_admission(config, router),
                             base_services=services)


def build_federated_fleet(config: AppConfig, services: ImageRegionServices):
    """The combined role's federated fleet (JAX ``create_app``
    ``:576-670``): the manifest installed as this process's, its members
    (``parallel.federation.build_federated_members``: this host's
    in-process, the others over their sidecar addresses) behind a router
    seeded by it with the cross-host drain handoff, the quorum tracker
    with ``federation.quorum``, the roll hook (an epoch commit swaps the
    router's ring) and the prefetcher's remote seam.  Returns the handler
    and the ``FederationCoordinator``."""
    from ..parallel import federation

    fed = config.federation
    manifest = federation.FleetManifest.from_config(fed)
    federation.install(manifest, self_host=fed.host)
    members = federation.build_federated_members(
        config, services, manifest,
        lambda address: sidecar_client(config, address), fed.host)
    router = fleet_router(config, members, manifest)
    if fed.quorum:
        federation.install_quorum(federation.QuorumTracker(
            manifest, self_host=fed.host,
            suspect_after_s=fed.suspect_after_s))
    # The one instant a live ring changes: an epoch's commit.
    federation.set_roll_hook(router.apply_manifest)
    coordinator = federation.FederationCoordinator(
        manifest, fed.host, router,
        gossip_interval_s=fed.gossip_interval_s)
    handler = _fleet_handler(config, services, members, router)
    if services.prefetcher is not None:
        services.prefetcher.remote_prestage = \
            router.remote_prestage_for_route
    return handler, coordinator


def start_prewarm(config: AppConfig, renderer: BatchingRenderer,
                  device: torch.device) -> None:
    """Run ``server.prewarm.prewarm_renderer`` over
    ``renderer.prewarm`` on a background thread, with
    ``telemetry.READINESS.prewarm_pending`` set until it ends (both wire
    engines under ``jpeg-engine: auto``: the controller may switch).  A
    malformed spec raises here, failing the boot, as in the JAX app."""
    from .prewarm import parse_spec, prewarm_renderer

    for spec in config.renderer.prewarm:
        parse_spec(spec)
    engines = (("sparse", "huffman") if renderer.engine_controller
               is not None else (renderer.jpeg_engine,))
    telemetry.READINESS.prewarm_failed = None
    telemetry.READINESS.prewarm_pending = True
    threading.Thread(
        target=prewarm_renderer,
        args=(list(config.renderer.prewarm), engines, renderer.max_batch,
              renderer.buckets, device),
        kwargs={"cpu_fallback_max_px": config.renderer.cpu_fallback_max_px},
        name="prewarm", daemon=True).start()


def build_handler(data_dir: str, lut_root: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda",
                  jpeg_host_max_px: int = JPEG_HOST_MAX_PX,
                  batcher: bool = True,
                  prefetch: bool = True) -> ImageRegionHandler:
    """The handler over a data directory of chunked pyramids, in the JAX
    app's default posture: the batching renderer (max_batch 8, linger
    2 ms, pipeline depth 4, 2 device lanes), the device raw cache (2 GiB,
    digest dedup off) and its prefetcher (``prefetch=False``: none),
    single-flight and admission (512).

    ``batcher=False`` builds the reference the tests hold the default
    against: the direct :class:`Renderer` (one B=1 launch of each kernel
    per request), with no raw cache, prefetcher, single-flight or
    admission."""
    config = AppConfig(data_dir=data_dir, lut_root=lut_root)
    config.renderer.cpu_fallback_max_px = jpeg_host_max_px
    config.raw_cache.prefetch = prefetch
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
    # A streamed body (an animation's frame records), written after the
    # headers; ``body`` is then empty.
    stream: Optional[AsyncIterator[bytes]] = None
    # The request ctx that carries the provenance marks (None before a
    # request parses).
    prov_ctx: object = None


def _json(status: int, doc: dict, **headers) -> Answer:
    return Answer(status, dict(headers, **{
        "Content-Type": "application/json; charset=utf-8"}),
                  json.dumps(doc).encode())


class Front:
    """The default app's routes without a socket: session, header layer,
    conditional answers, the handlers, status mapping and request
    accounting.

    A frontend (proxy mode) passes the ``server.sidecar`` handlers, the
    mask one as ``mask_handler``, and its ``client``: it then has no
    services (:attr:`services` None).  A fleet's handler
    (``parallel.fleet.FleetImageHandler``) brings its :attr:`router`; a
    frontend fleet's ``client`` is member 0's.  A federated fleet brings its
    ``federation`` (``parallel.federation.FederationCoordinator``)."""

    def __init__(self, config: AppConfig, handler, db=None,
                 mask_handler=None, client=None, federation=None):
        self.config = config
        self.handler = handler
        self.client = client
        self.federation = federation
        self.router: Optional[FleetRouter] = getattr(handler, "router",
                                                     None)
        self.services: Optional[ImageRegionServices] = getattr(
            handler, "s", None)
        self.session_store = make_session_store(config, db)
        wl = config.workloads
        self.workloads: Optional[WorkloadsHandler] = None
        if self.services is not None:
            self.mask_handler = ShapeMaskHandler(self.services,
                                                 wl.device_masks)
            self.workloads = WorkloadsHandler(handler, self.mask_handler,
                                              wl.animation_max_frames)
        else:
            self.mask_handler = mask_handler
        hc = config.http_cache
        if hc.enabled and hc.epoch == httpcache.EPOCH_AUTO:
            # Derived once at startup from the data tree's source stamps.
            hc.epoch = httpcache.derive_epoch(config.data_dir)
            if hc.epoch == "0" and self.services is None:
                # A frontend is where the ETags are made: an epoch that
                # never moves would keep edge caches confirming stale
                # renders.
                raise ValueError(
                    "http-cache.epoch: auto found no ingest stamps under "
                    f"data-dir {config.data_dir!r}; a frontend has no "
                    "source tree of its own: set an explicit epoch (or "
                    "mount the data tree)")
            if hc.epoch == "0":
                log.warning("http-cache.epoch: auto derived '0' (no "
                            "ingest stamps under %r)", config.data_dir)
        self.session_required = session_required(config)
        py = config.pyramid
        self.jobs: Optional[PyramidJobManager] = (PyramidJobManager(
            pixels_service=self.services.pixels_service,
            chunk=(py.chunk, py.chunk), min_level_size=py.min_level_size,
            compressor=None if py.compressor == "none" else py.compressor,
            device=self.services.renderer.device,
            defer_poll_s=py.defer_poll_s)
            if py.enabled and self.services is not None else None)
        self._forensics()
        self._elastic()

    def _forensics(self) -> None:
        """The JAX app's forensics and overload layer: the SLO engine
        (a breach dumps the flight recorder), the decision ledger, the
        pressure governor (``pressure.enabled``) and the perf sentinel
        (``sentinel.enabled``, on by default), each installed
        process-global as in JAX; their tick loops are
        :meth:`background`'s."""
        config = self.config
        tel = config.telemetry

        def on_slo_breach(objective: str, fast: float, slow: float) -> None:
            telemetry.FLIGHT.record("slo.breach", objective=objective,
                                    fast=round(fast, 2), slow=round(slow, 2))
            path = telemetry.FLIGHT.dump(tel.flight_recorder_dir,
                                         f"slo-{objective}")
            log.warning("SLO breach on %s (burn %.1f fast / %.1f slow); "
                        "flight recorder dumped to %s", objective, fast,
                        slow, path)

        slo = config.slo
        telemetry.SLO.configure(
            availability_target=slo.availability_target,
            latency_ms=slo.latency_ms, latency_target=slo.latency_target,
            fast_window_s=slo.fast_window_s,
            slow_window_s=slo.slow_window_s,
            breach_burn_rate=slo.breach_burn_rate, on_breach=on_slo_breach)
        decisions.LEDGER.configure(
            ring_size=config.decisions.ring_size,
            spool_dir=config.decisions.spool_dir or None,
            outcome_horizon_ticks=config.decisions.outcome_horizon_ticks)
        services = self.services
        self.governor: Optional[pressure_mod.PressureGovernor] = None
        if config.pressure.enabled:
            pressure_mod.apply_cgroup_rss_defaults(config.pressure)
            ref: list = []
            self.governor = pressure_mod.PressureGovernor(
                config.pressure,
                pressure_mod.build_actuators(config.pressure,
                                             services=services,
                                             router=self.router),
                pressure_mod.build_sources(services=services,
                                           governor_ref=ref,
                                           router=self.router))
            ref.append(self.governor)
            pressure_mod.install(self.governor)
        self.sentinel: Optional[sentinel_mod.SentinelEngine] = None
        if config.sentinel.enabled:
            member = config.federation.host or "local"
            self.sentinel = sentinel_mod.engine_from_config(
                config.sentinel, member=member,
                flight_fn=lambda: {"member": member,
                                   "fleet_members": self.member_names(),
                                   "events": telemetry.FLIGHT.snapshot()})
            sentinel_mod.install(self.sentinel)

    def _elastic(self) -> None:
        """The JAX app's elastic autoscaler (``server.autoscaler``, JAX
        ``:812-870``), with ``autoscaler.enabled`` and a fleet: drains with
        the ``autoscale`` intent and the ``drain`` section's handoff,
        undrains with pre-stage-back, the pressure governor's level as a
        signal.  With ``lane-capacity-tps`` and sessions on, the predicted
        demand is the viewport-tracked sessions x ``session-tps``, scaled
        by a diurnal fit over the finished requests
        (``services.loadmodel.DiurnalEstimator``, fed by :meth:`finish`)
        when ``diurnal-period-s`` > 0.  With ``unit-config`` in a
        ``fleet.sockets`` frontend, each member's sidecar is a unit
        (``server.sidecar.SidecarUnitLifecycle``) the app starts at startup
        and the autoscaler stops and restarts."""
        config = self.config
        au = config.autoscaler
        self.autoscaler = self.diurnal = self.unit_lifecycle = None
        if not au.enabled or self.router is None:
            return
        from .autoscaler import Autoscaler

        demand_source = None
        if au.lane_capacity_tps > 0 and config.sessions.enabled:
            if au.diurnal_period_s > 0:
                from ..services.loadmodel import DiurnalEstimator
                self.diurnal = DiurnalEstimator(period_s=au.diurnal_period_s)

            def demand_source() -> float:
                demand = telemetry.SESSIONS.tracked * au.session_tps
                if self.diurnal is not None:
                    demand *= self.diurnal.multiplier(
                        horizon_s=au.diurnal_horizon_s)
                return demand
        if au.unit_config and self.services is None:
            from .sidecar import SidecarUnitLifecycle
            self.unit_lifecycle = SidecarUnitLifecycle.for_config(
                au.unit_config, dict(zip(self.router.order,
                                         config.fleet.sockets)))
        dr = config.drain
        self.autoscaler = Autoscaler(
            au, self.router, governor=self.governor,
            demand_source=demand_source, lifecycle=self.unit_lifecycle,
            drain_kwargs={"prestage": dr.prestage,
                          "max_planes": dr.prestage_max_planes,
                          "settle_timeout_s": dr.settle_timeout_s})

    def admission(self):
        """The admission controller: a fleet's, above its router, else the
        services' (None without)."""
        admission = getattr(self.handler, "admission", None)
        if admission is None:
            admission = getattr(self.services, "admission", None)
        return admission

    def member_names(self) -> list:
        """The fleet's member names ([] without a fleet)."""
        return list(self.router.order) if self.router is not None else []

    def clients(self) -> list:
        """The sidecar clients this front holds: each member's in a
        frontend fleet, each remote member's in a federated one, else the
        one sidecar's, else none."""
        if self.router is not None and (self.services is None
                                        or self.federation is not None):
            return [m.client for m in self.router.members.values()
                    if getattr(m, "remote", False)]
        return [self.client] if self.client is not None else []

    def background(self) -> list:
        """The tick loops to run as tasks while the app serves: the
        pressure governor's, the sentinel's and the autoscaler's."""
        loops = []
        if self.governor is not None:
            loops.append(("pressure-governor", self.governor.run))
        if self.sentinel is not None:
            loops.append(("perf-sentinel", self.sentinel.run))
        if self.autoscaler is not None:
            loops.append(("autoscaler", self.autoscaler.run))
        return loops

    def close(self) -> None:
        """Uninstall this app's governor and sentinel (its tasks are
        cancelled by their owner)."""
        if self.governor is not None \
                and pressure_mod.active() is self.governor:
            pressure_mod.uninstall()
        if self.sentinel is not None:
            self.sentinel.close()
            if sentinel_mod.active() is self.sentinel:
                sentinel_mod.uninstall()

    async def session_key(self, cookies: Mapping[str, str]
                          ) -> Optional[str]:
        """The OMERO session key the session cookie resolves to (None when
        it does not, or without a store)."""
        return await resolve_session_key(self.session_store, cookies,
                                         self.config.session_cookie_name)

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

    async def can_read(self, object_type: str, object_id: int,
                       session_key: Optional[str]) -> bool:
        """The read ACL of an ``Image`` or a ``Mask``; False on error.  A
        frontend cannot check and says True: its 304 rests on the ETag,
        which derives from the URL and the epoch, never from pixels (the
        sidecar's ACL still gates every byte)."""
        if self.services is None:
            return True
        try:
            if object_type == "Mask":
                return await self.mask_handler.can_read(object_id,
                                                        session_key)
            return await self.handler.can_read(object_id, session_key)
        except Exception:
            return False

    async def _acl_gated(self, object_type: str, object_id: int) -> bool:
        """Is the object private for edge caches (not readable
        anonymously)?  Errs toward private."""
        if not self.config.http_cache.vary_acl:
            return True
        if self.services is None:
            # A frontend cannot probe: enforced sessions make everything
            # private.
            return self.session_required
        return not await self.can_read(object_type, object_id, None)

    async def cache_headers(self, headers: dict, identity: str,
                            object_type: str,
                            object_id: int) -> Optional[str]:
        """Stamp ETag, Cache-Control and Vary onto ``headers``; return the
        ETag (None with conditional HTTP off, when only the legacy
        ``cache-control-header`` applies)."""
        hc, legacy = self.config.http_cache, self.config.cache_control_header
        if not hc.enabled:
            if legacy:
                headers["Cache-Control"] = legacy
            return None
        etag = httpcache.etag_for(identity, hc.epoch)
        headers["ETag"] = etag
        cc, vary = httpcache.cache_headers(
            hc.max_age_s, await self._acl_gated(object_type, object_id))
        headers["Cache-Control"] = legacy or cc
        if vary:
            headers["Vary"] = vary
        return etag

    async def source_mtime(self, image_id: int) -> Optional[float]:
        """The image's source mtime for ``Last-Modified`` (the memo's
        inline hit, else one thread hop)."""
        if not self.config.http_cache.enabled or self.services is None:
            return None
        metadata = self.services.metadata
        if not hasattr(metadata, "source_mtime"):
            return None          # the OMERO database has no source stamp
        hit, value = metadata.source_mtime_cached(image_id)
        if hit:
            return value
        try:
            return await asyncio.to_thread(metadata.source_mtime, image_id)
        except Exception:
            return None

    def stamp_provenance(self, ctx, headers: dict) -> None:
        """The ``X-Image-Region-Provenance`` header of a success, under
        ``telemetry.provenance-header``."""
        if not self.config.telemetry.provenance_header or ctx is None:
            return
        value = provenance.header_value(provenance.assemble(
            ctx, 200, telemetry.current_trace_id()))
        if value:
            headers["X-Image-Region-Provenance"] = value

    async def answer(self, method: str, headers: Mapping[str, str],
                     out: dict, identity: str, object_type: str,
                     object_id: int, session_key: Optional[str],
                     produce: Callable[[], Awaitable[bytes]],
                     mtime: Optional[float] = None, ctx=None,
                     stream: Optional[Callable[[], AsyncIterator[bytes]]]
                     = None) -> Answer:
        """The header layer around one render: ETag, Cache-Control and
        Vary from ``identity`` (and ``Last-Modified`` from ``mtime``);
        the 304 or headers-only answer (:func:`conditional_answer`) for a
        caller that may read the object, in the ``304`` provenance tier;
        else ``produce()``'s body, an unreadable object getting its 404
        there.  With ``stream`` (the chunked response), the body is its
        chunks: the first awaited here, so its failure keeps its status.
        ``ctx`` carries the provenance marks."""
        etag = await self.cache_headers(out, identity, object_type,
                                        object_id)
        if mtime is not None:
            out["Last-Modified"] = httpcache.http_date(mtime)
        status = conditional_answer(headers, method, etag, mtime)
        if status == 200 and self.services is None:
            # A frontend cannot tell a deleted image from a readable one:
            # its HEAD runs the request (aiohttp drops the body).
            status = None
        if status is not None and await self.can_read(
                object_type, object_id, session_key):
            if status == 304:
                telemetry.HTTPCACHE.count_not_modified()
            else:
                telemetry.HTTPCACHE.count_head()
            if ctx is not None:
                provenance.mark(ctx, tier="304")
            self.stamp_provenance(ctx, out)
            return Answer(status, out, prov_ctx=ctx)
        if stream is not None:
            return await self._streamed(out, ctx, stream())
        try:
            body = await produce()
        except Exception as e:
            answer = self.status_of(e)
            answer.prov_ctx = ctx
            return answer
        self._strip_if_capped(ctx, out)
        self.stamp_provenance(ctx, out)
        return Answer(200, out, body, prov_ctx=ctx)

    @staticmethod
    def _strip_if_capped(ctx, out: dict) -> None:
        """Capped bytes are never edge-cached under the full-quality
        identity: no ETag, no Vary, no-store."""
        if getattr(ctx, "_pressure_quality_capped", False):
            out.pop("ETag", None)
            out.pop("Vary", None)
            out["Cache-Control"] = "no-store"

    async def _streamed(self, out: dict, ctx,
                        chunks: AsyncIterator[bytes]) -> Answer:
        """A chunked 200 of ``chunks`` (JAX ``:1162-1238``): the first
        chunk awaited before the headers; ``http.firstByte`` from the
        request's start to the first chunk's write."""
        trace_id = telemetry.current_trace_id()
        t_req = (telemetry.TRACES.get_or_create(trace_id).t0
                 if trace_id else None)
        try:
            first = await chunks.__anext__()
        except StopAsyncIteration:
            first = b""
        except Exception as e:
            await chunks.aclose()
            answer = self.status_of(e)
            answer.prov_ctx = ctx
            return answer
        # In one process the whole body is settled before its first chunk,
        # so the cap and the marks are known here; a frontend learns the
        # sidecar's marks from the fin frame, after the headers left, and
        # sends no provenance header rather than half a record (its access
        # line and counters, made at the end, are whole).
        self._strip_if_capped(ctx, out)
        if self.services is not None:
            self.stamp_provenance(ctx, out)

        async def body() -> AsyncIterator[bytes]:
            try:
                if first:
                    yield first
                if t_req is not None:
                    telemetry.record_span(
                        "http.firstByte", t_req,
                        (time.perf_counter() - t_req) * 1000.0)
                async for chunk in chunks:
                    yield chunk
            finally:
                await chunks.aclose()
        return Answer(200, out, stream=body(), prov_ctx=ctx)

    async def _session(self, cookies: Mapping[str, str]):
        """(session key, None), or (None, the 403) when a session is
        required and there is none."""
        session = await self.session_key(cookies)
        if session is None and self.session_required:
            return None, Answer(403)
        return session, None

    async def render(self, method: str, params: dict,
                     headers: Mapping[str, str],
                     cookies: Mapping[str, str]) -> Answer:
        """One ``render_image_region`` / ``render_image`` request."""
        session, refused = await self._session(cookies)
        if refused is not None:
            return refused
        try:
            ctx = ImageRegionCtx.from_params(params, session)
        except BadRequestError as e:
            return self.status_of(e)
        out = {"Content-Type": codecs.CONTENT_TYPES.get(
            ctx.format, "application/octet-stream")}
        mtime = httpcache.last_modified_basis(
            await self.source_mtime(ctx.image_id),
            self.config.http_cache.epoch)
        stream = None
        if self.config.wire.streaming:
            stream = lambda: self.handler.render_image_region_stream(  # noqa
                ctx)
        return await self.answer(
            method, headers, out, ctx.cache_key, "Image", ctx.image_id,
            ctx.omero_session_key,
            lambda: self.handler.render_image_region(ctx), mtime, ctx=ctx,
            stream=stream)

    async def render_mask(self, method: str, params: dict,
                          headers: Mapping[str, str],
                          cookies: Mapping[str, str]) -> Answer:
        """One ``render_shape_mask`` request.  The ETag identity is the
        reference's mask cache key with the flips folded in (they change
        the bytes); a mask has no ``Last-Modified``."""
        session, refused = await self._session(cookies)
        if refused is not None:
            return refused
        try:
            ctx = ShapeMaskCtx.from_params(params, session)
        except BadRequestError as e:
            return self.status_of(e)
        identity = (f"{ctx.cache_key()}:f{int(ctx.flip_horizontal)}"
                    f"{int(ctx.flip_vertical)}")

        router = self.router

        async def produce() -> bytes:
            s = self.services
            if s is None:
                # A frontend: the sidecar's caches and admission; a fleet
                # asks the mask's ring authority first and writes a render
                # back to it.
                if router is not None:
                    try:
                        peer = await router.fetch_peer_mask(ctx)
                    except Exception:
                        peer = None
                    if peer is not None:
                        return peer
                body = await self.mask_handler.render_shape_mask(ctx)
                if router is not None:
                    router.put_peer_mask(ctx, body)
                return body
            # After the renderless answers, as in the JAX app: the session
            # stays live in the viewport model (no pan vote), and the mask
            # draws its session's fairness token (kept on a 404 or 400,
            # so scraping missing ids is metered too).
            tracker = getattr(s.prefetcher, "viewport", None)
            if tracker is not None and ctx.omero_session_key:
                tracker.observe_activity(ctx.omero_session_key)
            # A byte-cache hit (its ACL checked) costs no token.
            cached = await self.mask_handler.cached_shape_mask(ctx)
            if cached is not None:
                return cached
            admission = self.admission()
            if admission is not None:
                admission.admit_session(ctx)
            return await self.mask_handler.render_shape_mask(ctx)
        return await self.answer(
            method, headers, {"Content-Type": "image/png"}, identity,
            "Mask", ctx.shape_id, ctx.omero_session_key, produce, ctx=ctx)

    async def render_overlay(self, method: str, params: dict,
                             headers: Mapping[str, str],
                             cookies: Mapping[str, str]) -> Answer:
        """One ``render_overlay`` request: ``shapes=<id,id,...>`` (request
        order is paint order), ``color=`` overrides the fills, the base
        is forced to PNG.  The ETag identity folds the base's cache key
        with the shapes and the colour."""
        if self.workloads is None \
                or not self.config.workloads.overlay_enabled:
            return Answer(404)
        params = dict(params)
        shapes_raw = params.pop("shapes", "")
        color = params.pop("color", None)
        params["format"] = "png"
        try:
            shape_ids = [int(v) for v in shapes_raw.split(",") if v]
        except ValueError:
            return self.status_of(BadRequestError(
                f"Incorrect format for shapes '{shapes_raw}'"))
        if not shape_ids:
            return self.status_of(BadRequestError(
                "overlay needs ?shapes=<id,id,...>"))
        session, refused = await self._session(cookies)
        if refused is not None:
            return refused
        try:
            ctx = ImageRegionCtx.from_params(params, session)
        except BadRequestError as e:
            return self.status_of(e)
        identity = (f"{ctx.cache_key}:ov:"
                    + ",".join(str(v) for v in shape_ids)
                    + f":{color or ''}")
        return await self.answer(
            method, headers, {"Content-Type": "image/png"}, identity,
            "Image", ctx.image_id, ctx.omero_session_key,
            lambda: self.workloads.render_overlay(ctx, shape_ids,
                                                  color=color), ctx=ctx)

    async def render_animation(self, method: str, params: dict,
                               headers: Mapping[str, str],
                               cookies: Mapping[str, str]) -> Answer:
        """One ``render_animation`` request: ``axis=z|t`` (default t) and
        ``frames=N`` (default 2) frames from the URL's theZ or theT, each
        a request of the plain route with that coordinate.  The first
        frame is awaited before the headers, so a failure before the body
        keeps its status; the rest follow as :attr:`Answer.stream`.  Never
        edge-cached."""
        if self.workloads is None \
                or not self.config.workloads.animation_enabled:
            return Answer(404)
        params = dict(params)
        axis = (params.pop("axis", "t") or "t").lower()
        if axis not in ("z", "t"):
            return self.status_of(BadRequestError(
                f"Incorrect format for axis '{axis}'"))
        frames_raw = params.pop("frames", "2")
        try:
            n_frames = int(frames_raw)
        except ValueError:
            return self.status_of(BadRequestError(
                f"Incorrect format for frames '{frames_raw}'"))
        if n_frames < 1:
            return self.status_of(BadRequestError("frames must be >= 1"))
        axis_key = "theZ" if axis == "z" else "theT"
        session, refused = await self._session(cookies)
        if refused is not None:
            return refused
        start = int(params.get(axis_key) or 0)
        try:
            frame_ctxs = [ImageRegionCtx.from_params(
                dict(params, **{axis_key: str(start + i)}), session)
                for i in range(n_frames)]
        except BadRequestError as e:
            return self.status_of(e)
        out = {"Content-Type": ANIMATION_CONTENT_TYPE,
               "Cache-Control": "no-store"}
        frames = self.workloads.render_animation_stream(frame_ctxs)
        try:
            first = await frames.__anext__()
        except StopAsyncIteration:
            first = b""
        except Exception as e:
            await frames.aclose()
            answer = self.status_of(e)
            answer.prov_ctx = frame_ctxs[0]
            return answer

        async def stream() -> AsyncIterator[bytes]:
            try:
                if first:
                    yield first
                async for record in frames:
                    yield record
            finally:
                await frames.aclose()
        return Answer(200, out, stream=stream(), prov_ctx=frame_ctxs[0])

    async def pyramid_submit(self, body: bytes) -> Answer:
        """``POST /pyramid`` with ``{"imageId": N}`` (or ``{"path":
        dir}``): queue a build (idempotent: an unfinished job for the same
        destination is returned as-is); 202 and the job document."""
        if self.jobs is None:
            return Answer(404)
        text = {"Content-Type": "text/plain; charset=utf-8"}
        try:
            doc = json.loads(body.decode("utf-8"))
        except Exception:
            return Answer(400, text, b"body must be JSON")
        if not isinstance(doc, dict) \
                or (doc.get("imageId") is None and not doc.get("path")):
            return Answer(400, text,
                          b'body needs {"imageId": N} or {"path": dir}')
        try:
            if doc.get("imageId") is not None:
                job = self.jobs.submit_image(int(doc["imageId"]))
            else:
                job = self.jobs.submit(str(doc["path"]))
        except FileNotFoundError:
            return Answer(404)
        except (ValueError, TypeError) as e:
            return Answer(400, text, str(e).encode())
        return _json(202, job.to_doc())

    def pyramid_status(self, job_id: str) -> Answer:
        """``GET /pyramid/{jobId}``: the job document, or 404."""
        job = self.jobs.get(job_id) if self.jobs is not None else None
        return Answer(404) if job is None else _json(200, job.to_doc())

    def _route(self, route: str):
        return {"render_shape_mask": self.render_mask,
                "render_overlay": self.render_overlay,
                "render_animation": self.render_animation}.get(
                    route, self.render)

    async def observed(self, route: str, method: str, params: dict,
                       headers: Mapping[str, str],
                       cookies: Mapping[str, str],
                       send: Optional[Callable[[Answer], Awaitable[None]]]
                       = None,
                       call: Optional[Callable[[], Awaitable[Answer]]]
                       = None) -> Answer:
        """The route's request in a request trace and its deadline scope;
        its duration and status feed the request series.  ``call``
        answers in place of the route's handler (a route that is not a
        render, ``pyramid_submit``).  A streamed answer is handed to
        ``send`` inside the scope (which writes it), or, with no ``send``,
        read into :attr:`Answer.body`.  A cancelled request (the client
        went away) is counted as 499.  The finished request is accounted
        by :meth:`finish`."""
        trace_id = telemetry.new_trace_id()
        t0 = time.perf_counter()
        streamed = [0]
        try:
            with telemetry.trace_scope(trace_id, route), deadline_scope(
                    self.config.fault_tolerance.request_deadline_ms):
                answer = await (call() if call is not None else
                                self._route(route)(method, params, headers,
                                                   cookies))
                if answer.stream is not None:
                    if send is not None:
                        answer.stream = _counted(answer.stream, streamed)
                        await send(answer)
                    else:
                        answer.body = b"".join(
                            [chunk async for chunk in answer.stream])
                        answer.stream = None
        except BaseException:
            telemetry.TRACES.finish(trace_id)
            telemetry.count_request(route, 499)
            raise
        trace = telemetry.TRACES.finish(trace_id)
        self.finish(route, answer.status, len(answer.body) + streamed[0],
                    (time.perf_counter() - t0) * 1000.0, trace,
                    answer.prov_ctx)
        return answer

    def finish(self, route: str, status: int, nbytes: int,
               total_ms: float, trace: Optional[telemetry.Trace],
               prov_ctx=None) -> None:
        """A finished request's accounting, as the JAX app's
        ``_finish_request`` does it: the request histogram (a success's
        bucket exemplar: its trace id and provenance tier) and totals; the
        SLO windows; a success's sketch in the perf sentinel; a 5xx's
        ``request.error`` flight event; a success's provenance record into
        the provenance counters; the cost ledger into the cost histograms
        and the top-K; with ``telemetry.access-log``, the JSON access line;
        and past ``telemetry.slow-request-ms``, the waterfall's dump."""
        record = None
        if prov_ctx is not None and status < 400:
            record = provenance.assemble(
                prov_ctx, status,
                trace.trace_id if trace is not None else None)
            telemetry.PROVENANCE.count(record)
        exemplar = None
        if trace is not None and record is not None:
            exemplar = (trace.trace_id, record["tier"])
        telemetry.REQUEST_HIST.observe(route, total_ms, exemplar=exemplar)
        telemetry.count_request(route, status)
        telemetry.SLO.record(status, total_ms)
        engine = sentinel_mod.active()
        if engine is not None and status < 400:
            engine.observe(route, nbytes, total_ms,
                           trace.trace_id if trace is not None else None)
        if self.diurnal is not None:
            # One arrival for the autoscaler's diurnal demand fit.
            self.diurnal.observe()
        if status >= 500:
            telemetry.FLIGHT.record(
                "request.error", route=route, status=status,
                trace=trace.trace_id if trace is not None else None,
                ms=round(total_ms, 1))
        if trace is None:
            return
        ledger, cache_class = telemetry.assemble_ledger(trace, total_ms,
                                                        nbytes)
        telemetry.observe_request_cost(route, ledger)
        telemetry.COST_TOPK.offer({
            "trace": trace.trace_id, "route": route, "status": status,
            "ts": round(trace.wall_ts, 3), "cache": cache_class,
            "total_ms": round(total_ms, 3), "cost": ledger})
        self._slow_trace(trace, total_ms, status, record)
        if not self.config.telemetry.access_log:
            return
        queue_ms = trace.span_ms("batcher.queueWait")
        render_ms = trace.span_ms("Renderer.renderAsPackedInt")
        if render_ms is not None and queue_ms:
            # The render span is the whole await of the batcher, its
            # queue wait included.
            render_ms = max(0.0, render_ms - queue_ms)
        line = {
            "ts": round(trace.wall_ts, 3),
            "trace": trace.trace_id,
            "route": route,
            "status": status,
            "bytes": nbytes,
            "ms": round(total_ms, 3),
            "queue_ms": queue_ms,
            "render_ms": render_ms,
            "encode_ms": trace.span_ms("encodeImage", "jfif.encodeBatch"),
            "cache": cache_class,
            "cost": ledger,
        }
        if record is not None:
            line["prov"] = {k: v for k, v in record.items() if k != "trace"}
        access_log.info("%s", json.dumps(line))

    def _slow_trace(self, trace: telemetry.Trace, total_ms: float,
                    status: int, record: Optional[dict]) -> None:
        tel = self.config.telemetry
        if tel.slow_request_ms <= 0 or total_ms < tel.slow_request_ms:
            return
        path = telemetry.dump_slow_trace(
            trace, total_ms, status, tel.slow_request_dir,
            extra={"prov": record} if record is not None else None)
        if path:
            log.warning("slow request %s (%.0f ms) on %s: waterfall dumped "
                        "to %s", trace.trace_id, total_ms, trace.route, path)

    def ready(self) -> Tuple[bool, dict]:
        """(ok, checks) of ``/readyz``, the JAX app's combined-role
        ``_ready_state``: ``prewarm`` (``pending``, ``complete``, or
        ``failed: <reason>``, which keeps the process unready) and
        ``queue`` (``ok``, or ``depth N over M`` past
        ``telemetry.ready-max-queue-depth`` tiles queued in the batcher).
        With persistence on, ``rehydrate`` carries the boot rehydrate's
        state (``idle``, ``running N/M``, ``done N/M`` or ``aborted N/M``).
        As in the JAX app, ``slo`` (with objectives: their burn),
        ``sentinel`` (``ok`` or ``drifting``) and ``pressure`` (with the
        governor on: ``ok``, or the level and the engaged steps) annotate
        too.  No annotation makes the process unready: a drifting or
        browned-out instance is still serving.  With a fleet the backlog is
        the router's (queued and executing across the members), ``fleet``
        names the members down (or counts them) and ``drain`` the
        draining ones; ``drain.fail-readyz`` makes any drain but an
        autoscaler's a 503."""
        checks: dict = {}
        if self.router is not None:
            depth = self.router.queue_depth()
            self._fleet_note(checks)
        else:
            renderer = self.services.renderer
            depth = (renderer.queue_depth()
                     if hasattr(renderer, "queue_depth") else 0)
        if self.services.warmstate is not None:
            checks["rehydrate"] = telemetry.PERSIST.rehydrate_summary()
        readiness = telemetry.READINESS
        return self._ready_checks(
            checks, readiness.prewarm_failed, readiness.prewarm_pending,
            depth)

    def _fleet_note(self, checks: dict) -> None:
        """The fleet's ``/readyz`` annotations (JAX ``_fleet_note``)."""
        router = self.router
        healthy = router.healthy_members()
        down = [n for n in router.order if n not in healthy]
        checks["fleet"] = (f"members down: {','.join(down)}" if down
                           else f"{len(router.order)} members")
        draining = router.draining_members()
        if draining:
            checks["drain"] = "draining: " + ",".join(
                n + ("(autoscale)" if getattr(router.members[n],
                                              "drain_intent", None)
                     == "autoscale" else "")
                for n in draining)

    async def readiness(self) -> Tuple[bool, dict]:
        """``/readyz``: :meth:`ready`, or in a frontend the same checks
        from the sidecar's ``ping`` (2 s at most), and ``sidecar``: ``ok``
        or ``unreachable`` (unready, unless degraded mode serves:
        ``degraded-mode: active``), and ``breaker: open`` while it is."""
        if self.services is not None:
            return self.ready()
        checks: dict = {}
        breaker = self.client.breaker
        if breaker is not None and breaker.state == breaker.OPEN:
            checks["breaker"] = "open"
        router = self.router
        # A frontend fleet pings every member still marked healthy, at
        # once (JAX ``_ready_state``): one that does not answer is marked
        # down; the prewarm is pending until every answering member's is
        # done, and the backlog is the sum of theirs and the router's.
        probes = ([(m, m.client) for m in router.members.values()
                   if m.healthy] if router is not None
                  else [(None, self.client)])

        async def probe(member, client):
            try:
                status, body = await asyncio.wait_for(
                    client.call("ping", {}), timeout=2.0)
                return status, (json.loads(bytes(body).decode())
                                if status == 200 and body else {})
            except Exception:
                if member is not None:
                    member.mark_down()
                return None, None

        ok = True
        infos = []
        for status, info in await asyncio.gather(
                *(probe(m, c) for m, c in probes)):
            if info is None:
                continue
            if status != 200 or not info.get("ok"):
                ok = False
                checks["sidecar"] = f"status {status}"
            else:
                checks.setdefault("sidecar", "ok")
            infos.append(info)
        if not infos:
            checks["sidecar"] = "unreachable"
            if router is not None:
                self._fleet_note(checks)
            if getattr(self.handler, "fallback", None) is not None:
                # Degraded mode serves: a load balancer keeps routing here.
                checks["degraded-mode"] = "active"
                return True, checks
            return False, checks
        notes = [str(i["rehydrate"]) for i in infos
                 if i.get("rehydrate") is not None]
        if notes:
            checks["rehydrate"] = notes[0]
        depth = sum(int(i.get("queue_depth", 0)) for i in infos)
        if router is not None:
            depth += router.queue_depth()
            self._fleet_note(checks)
        failed = [i.get("prewarm_failed") for i in infos
                  if i.get("prewarm_failed")]
        ready, checks = self._ready_checks(
            checks, failed[0] if failed else None,
            any(bool(i.get("prewarm_pending")) for i in infos), depth)
        return ready and ok and checks["sidecar"] == "ok", checks

    def _ready_checks(self, checks: dict, prewarm_failed, prewarm_pending,
                      depth: int) -> Tuple[bool, dict]:
        ok = True
        if prewarm_failed:
            ok = False
            checks["prewarm"] = f"failed: {prewarm_failed}"
        elif prewarm_pending:
            ok = False
            checks["prewarm"] = "pending"
        else:
            checks["prewarm"] = "complete"
        max_depth = self.config.telemetry.ready_max_queue_depth
        if depth > max_depth:
            ok = False
            checks["queue"] = f"depth {depth} over {max_depth}"
        else:
            checks["queue"] = "ok"
        if telemetry.SLO.enabled:
            checks["slo"] = telemetry.SLO.summary()
        if self.sentinel is not None:
            checks["sentinel"] = ("drifting" if self.sentinel.verdict
                                  == "drifting" else "ok")
        if self.governor is not None:
            checks["pressure"] = self.governor.summary()
        if self.federation is not None:
            # An annotation: a disagreeing peer is loud on
            # /admin/federation; this host still serves its shard.
            checks["federation"] = self.federation.summary()
        router = self.router
        if (self.config.drain.fail_readyz and router is not None
                and [n for n in router.draining_members()
                     if getattr(router.members[n], "drain_intent", None)
                     not in ("autoscale", "gossip")]):
            # An operator drain (or shutdown's quiesce) takes the instance
            # out of rotation; an autoscaler's does not.
            ok = False
        if self.autoscaler is not None:
            # An annotation, never a reason to be unready.
            checks["autoscaler"] = self.autoscaler.summary()
        return ok, checks

    async def sidecar_doc(self, op: str, timeout_s: float = 2.0,
                          **extra) -> Optional[dict]:
        """A frontend's JSON answer of the sidecar's ``op`` (None when it
        does not answer 200 in ``timeout_s``)."""
        try:
            status, body = await asyncio.wait_for(
                self.client.call(op, {}, extra=extra or None), timeout_s)
            return (json.loads(bytes(body).decode())
                    if status == 200 and body else None)
        except Exception:
            return None

    async def warmstate_doc(self, snapshot: bool = False) -> dict:
        """``GET /debug/warmstate``: whether persistence is on, the
        rehydrate's state and the snapshot counts; ``snapshot`` also
        writes the manifest now (``snapshot_path``: its path, or None).
        A frontend relays the sidecar's (``{"error": ...}`` when it does
        not answer)."""
        if self.services is None:
            doc = await self.sidecar_doc(
                "warmstate", 10.0, **({"snapshot": 1} if snapshot else {}))
            return doc if doc is not None else {
                "error": "the sidecar did not answer the warmstate op"}
        warmstate = self.services.warmstate
        doc = {"enabled": warmstate is not None,
               "rehydrate": telemetry.PERSIST.rehydrate_summary(),
               "snapshots": telemetry.PERSIST.snapshots,
               "snapshot_errors": telemetry.PERSIST.snapshot_errors}
        if warmstate is not None and snapshot:
            doc["snapshot_path"] = await asyncio.to_thread(
                warmstate.snapshot_now)
        return doc

    def _remote_fleet(self) -> bool:
        """A frontend fleet: every member is a sidecar."""
        return self.router is not None and self.services is None

    async def member_docs(self, op: str) -> dict:
        """A frontend fleet's members' JSON answers of ``op``, by member
        (None for a member that did not answer in 2 s)."""
        async def fetch(client):
            try:
                status, body = await asyncio.wait_for(
                    client.call(op, {}), 2.0)
                return (json.loads(bytes(body).decode())
                        if status == 200 and body else None)
            except Exception:
                return None

        names = list(self.router.order)
        docs = await asyncio.gather(*(fetch(self.router.members[n].client)
                                      for n in names))
        return dict(zip(names, docs))

    def flight_doc(self, dump: bool = False,
                   sidecar: Optional[dict] = None,
                   members: Optional[dict] = None) -> dict:
        """``GET /debug/flightrecorder``: the ring and its counts; ``dump``
        also writes it to ``telemetry.flight-recorder-dir``
        (``dumped_to``: the file, or None).  A frontend passes its
        sidecar's ring (``sidecar``, JAX ``:1754-1803``); a frontend fleet
        every member's (``members``), merged by time into ``ring``, each
        event stamped with its member (this process's ``frontend``)."""
        flight = telemetry.FLIGHT
        doc = {"events": flight.snapshot(),
               "events_total": flight.events_total,
               "dumps_written": flight.dumps_written}
        if members is not None:
            merged = [dict(e) if "member" in e else dict(e, member="frontend")
                      for e in doc["events"]]
            for name, ring in members.items():
                for event in (ring or {}).get("events", ()):
                    stamped = dict(event)
                    stamped.setdefault("member", name)
                    merged.append(stamped)
            merged.sort(key=lambda e: e.get("ts", 0.0))
            doc["members"] = members
            doc["ring"] = merged
            doc["sidecar"] = next(iter(members.values()), None)
        elif self.services is None:
            doc["sidecar"] = sidecar
        if dump:
            doc["dumped_to"] = flight.dump(
                self.config.telemetry.flight_recorder_dir, "manual")
        return doc

    def metrics_text(self, openmetrics: bool = False,
                     sidecar_lines=None) -> str:
        """The ``/metrics`` body: the Prometheus text exposition, or with
        ``openmetrics`` the strict OpenMetrics one, whose request-duration
        buckets carry their exemplars and which ends ``# EOF``.  A
        frontend has the breaker's gauges and passes its sidecar's series
        (``sidecar_lines``, labelled ``process="sidecar"``; None: the
        sidecar did not answer, a comment says so), JAX ``:1689-1718``."""
        lines = (telemetry.request_metric_lines(exemplars=openmetrics)
                 + span_lines() + telemetry.cost_metric_lines()
                 + telemetry.resilience_metric_lines(
                     breaker=getattr(self.client, "breaker", None))
                 + telemetry.session_metric_lines())
        if self.router is not None:
            lines += telemetry.fleet_metric_lines(
                self.router, single_flight=self.handler.single_flight)
        if self.services is not None:
            lines += telemetry.device_metric_lines(self.services)
        elif sidecar_lines is None:
            lines.append("# sidecar metrics unavailable")
        else:
            lines += sidecar_lines
        text = telemetry.finalize_exposition(lines, openmetrics=openmetrics)
        return text + "# EOF\n" if openmetrics else text

    def costs_doc(self) -> dict:
        """``GET /debug/costs``: the top-K most expensive recent requests
        with their ledgers, and the per-shape device costs."""
        return {"observed": telemetry.COST_TOPK.observed,
                "k": telemetry.COST_TOPK.k,
                "top": telemetry.COST_TOPK.snapshot(),
                "shapes": telemetry.SHAPE_COSTS.snapshot()}

    @staticmethod
    def decisions_doc(members: Optional[dict] = None) -> dict:
        """``GET /debug/decisions``: the decision ledger's ring; a frontend
        fleet passes its members' (``members``, the ``decisions`` op's
        answers), merged by time into ``ledger`` with each record stamped
        with its member and, in a federation, its host (JAX
        ``:1805-1863``)."""
        from ..parallel import federation
        local = decisions.LEDGER.snapshot()
        doc = {"records": local, "status": decisions.LEDGER.status()}
        if members is None:
            doc["ledger"] = local
            return doc
        self_host = federation.self_host()
        manifest = federation.current()
        merged = []
        for rec in local:
            stamped = (dict(rec) if "member" in rec
                       else dict(rec, member="frontend"))
            if self_host:
                stamped.setdefault("host", self_host)
            merged.append(stamped)
        for name, ring in members.items():
            host = manifest.host_of(name) if manifest is not None else ""
            for rec in (ring or {}).get("ring", ()):
                stamped = dict(rec)
                stamped.setdefault("member", name)
                if host:
                    stamped.setdefault("host", host)
                merged.append(stamped)
        merged.sort(key=lambda r: r.get("ts", 0.0))
        doc["members"] = members
        doc["ledger"] = merged
        return doc

    @staticmethod
    def exemplars_doc() -> dict:
        """``GET /debug/exemplars``: each route's latency buckets with the
        last trace id and tier in each (the JSON twin of the OpenMetrics
        exemplars)."""
        return {"request_duration_ms": telemetry.exemplars_snapshot()}

    def sentinel_doc(self, sidecar: Optional[dict] = None) -> dict:
        """``GET /debug/sentinel``: this process's view, live (not the last
        tick's); a frontend passes its sidecar's (``sidecar``, the
        ``sentinel`` op's answer), whose summary joins as member
        ``sidecar``."""
        doc = telemetry.SENTINEL.merged()
        if self.sentinel is not None:
            local = self.sentinel.summary()
            doc["members"][str(local.get("member") or "local")] = {
                "age_s": 0.0, "summary": local}
            if local.get("verdict") == "drifting":
                doc["verdict"] = "drifting"
        summary = (sidecar or {}).get("local") or {}
        if summary:
            doc["members"].setdefault("sidecar", {"age_s": 0.0,
                                                  "summary": summary})
            if summary.get("verdict") == "drifting":
                doc["verdict"] = "drifting"
        doc["drifting_members"] = sorted(
            name for name, row in doc["members"].items()
            if row.get("summary", {}).get("verdict") == "drifting")
        return doc

    async def profile(self, ms_raw: Optional[str]) -> Answer:
        """``GET /debug/profile?ms=N``: a ``torch.profiler`` capture of N ms
        (default 500, clamped to [1, ``telemetry.profile-max-ms``]) on a
        worker thread; 400 on a bad ``ms``, 409 while a capture is live,
        503 when the profiler cannot record (on a card: CUDA activity)."""
        try:
            ms = float(ms_raw if ms_raw is not None else 500.0)
        except ValueError:
            return Answer(400, {"Content-Type": "text/plain; charset=utf-8"},
                          b"ms must be a number")
        ms = max(1.0, min(ms, self.config.telemetry.profile_max_ms))
        if self.services is None:
            # The capture runs in the process that owns the card.
            try:
                resp_header, body = await self.client.call_full(
                    "profile", {}, extra={"ms": ms})
            except Exception as e:
                return self.status_of(e)
            if resp_header["status"] == 200:
                return _json(200, json.loads(bytes(body).decode()))
            return _json(resp_header["status"],
                         {"error": resp_header.get("error", "")})
        try:
            doc = await asyncio.to_thread(
                telemetry.capture_profile,
                self.config.telemetry.profile_dir, ms)
        except telemetry.ProfileInProgressError as e:
            return _json(409, {"error": str(e)})
        except Exception:
            log.exception("profile capture failed")
            return _json(503, {"error": "profiler unavailable"})
        return _json(200, doc)

    async def explain(self, path: Optional[str]) -> Answer:
        """``GET /debug/explain?path=<render URL>``: the dry-run document
        (``server.explain``); 400 without a render URL."""
        if not path:
            return _json(400, {"error": "pass ?path=<render URL> (path + "
                                        "query, server-relative)"})
        try:
            doc = await explain.explain(
                path, self.config, services=self.services,
                admission=self.admission(),
                jobs=self.jobs, proxy_client=self.client,
                federation_coord=self.federation)
        except BadRequestError as e:
            return _json(400, {"error": str(e)})
        except Exception:
            log.exception("explain failed")
            return _json(500, {"error": "explain failed"})
        return _json(200, doc)


    def drain_status(self) -> dict:
        """Each member's health, drain state and intent, queue, in-flight
        renders and resident planes (``GET /admin/drain``)."""
        router = self.router
        return {"members": {
            name: {"healthy": member.healthy,
                   "draining": member.draining,
                   "intent": getattr(member, "drain_intent", None),
                   "depth": router.member_depth(name),
                   "inflight": router.member_inflight(name),
                   "planes": member.resident_planes()}
            for name, member in router.members.items()}}

    def _member_or_error(self, member: Optional[str]) -> Optional[Answer]:
        """The 400 of JAX's drain routes without a fleet or for an unknown
        member; None when ``member`` is the fleet's."""
        if self.router is None:
            return _json(400, {"error": "drains require a fleet topology "
                                        "(fleet.enabled)"})
        if not member or member not in self.router.members:
            return _json(400, {"error": f"unknown member {member!r}",
                               "members": list(self.router.order)})
        return None

    async def admin_drain(self, method: str,
                          member: Optional[str]) -> Answer:
        """``GET /admin/drain``: :meth:`drain_status`; ``POST
        ?member=mN``: drain it (``FleetRouter.drain_member`` with the
        ``drain`` section's knobs), 409 when it is the last routable
        member."""
        if self.router is not None and method == "GET":
            return _json(200, self.drain_status())
        refused = self._member_or_error(member)
        if refused is not None:
            return refused
        router = self.router
        if not [n for n in router.order
                if router._routable(n) and n != member]:
            # Draining the last servable member is an outage.
            return _json(409, {"error": "refusing to drain the last "
                                        "routable member"})
        dr = self.config.drain
        doc = await router.drain_member(
            member, prestage=dr.prestage, max_planes=dr.prestage_max_planes,
            settle_timeout_s=dr.settle_timeout_s)
        doc.update(self.drain_status())
        return _json(200, doc)

    def admin_undrain(self, member: Optional[str]) -> Answer:
        """``POST /admin/undrain?member=mN``: rejoin it."""
        refused = self._member_or_error(member)
        if refused is not None:
            return refused
        self.router.undrain_member(member)
        return _json(200, self.drain_status())

    def admin_autoscaler(self) -> Answer:
        """``GET /admin/autoscaler``: the autoscaler's status document
        (:meth:`server.autoscaler.Autoscaler.status`), or JAX's 400 without
        one."""
        if self.autoscaler is not None:
            return _json(200, self.autoscaler.status())
        return _json(400, {"enabled": False,
                           "error": "autoscaler requires autoscaler.enabled "
                                    "and a fleet topology"})

    async def admin_federation(self, agree: bool = False) -> Answer:
        """``GET /admin/federation``: the coordinator's status (the
        manifest, each peer's agreement, the last gossip round, the merged
        view, the host clocks, a pending epoch and the quorum); ``agree``
        first runs a non-strict agreement round (did the fleet converge
        after an epoch bump).  JAX's 400 without a federation."""
        if self.federation is None:
            return _json(400, {"enabled": False,
                               "error": "federation requires "
                                        "federation.enabled in the combined "
                                        "role"})
        if agree:
            await self.federation.agree(strict=False)
        return _json(200, self.federation.status())


async def _counted(stream: AsyncIterator[bytes],
                   box: list) -> AsyncIterator[bytes]:
    """``stream``, adding the bytes it yields to ``box[0]``."""
    async for chunk in stream:
        box[0] += len(chunk)
        yield chunk


def configure_logging(config: AppConfig) -> None:
    """Console always; a time-rolling file appender when
    ``logging.file`` is set."""
    import logging.handlers

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


def sidecar_client(config: AppConfig, socket: Optional[str] = None):
    """A frontend's ``server.sidecar.SidecarClient`` to ``socket``
    (default ``sidecar.socket``), with the config's breaker, retry policy
    and wire knobs."""
    from ..utils.transient import CircuitBreaker, RetryPolicy
    from .sidecar import SidecarClient

    ft = config.fault_tolerance
    return SidecarClient(
        socket or config.sidecar.socket,
        breaker=CircuitBreaker(failure_threshold=ft.breaker_failure_threshold,
                               reset_after_s=ft.breaker_reset_s),
        retry=RetryPolicy(max_attempts=ft.retry_max_attempts,
                          base_backoff_s=ft.retry_base_backoff_ms / 1000.0,
                          max_backoff_s=ft.retry_max_backoff_ms / 1000.0),
        wire=config.wire)


def build_front(config: AppConfig,
                device: Union[str, torch.device] = "cuda",
                handler: Optional[ImageRegionHandler] = None,
                db=None) -> Front:
    """The :class:`Front` a config describes: with ``sidecar.role:
    frontend`` (and no ``handler``), a frontend over the sidecar wire,
    which builds nothing on the card (the degraded CPU handler behind it
    with ``fault-tolerance.degraded-mode``), routed over one sidecar per
    ``fleet.sockets`` address with ``fleet.enabled``; else the combined app
    over ``handler`` or the services :func:`build_services` makes, behind
    the federated fleet (:func:`build_federated_fleet`) with
    ``federation.enabled``, or an in-process fleet
    (:func:`build_local_fleet`) with ``fleet.enabled``."""
    fleet = config.fleet
    if handler is None and config.sidecar.role == "frontend":
        from .sidecar import SidecarImageHandler, SidecarMaskHandler

        if config.fault_injection.seed is not None:
            faultinject.install(config.fault_injection)
        telemetry.FLIGHT.configure(config.telemetry.flight_recorder_events)
        fallback = None
        if config.fault_tolerance.degraded_mode:
            from .degraded import DegradedCpuHandler
            fallback = DegradedCpuHandler(config)
        if fleet.enabled and fleet.sockets:
            members = [RemoteMember(f"m{i}", sidecar_client(config, sock),
                                    down_cooldown_s=fleet.down_cooldown_s)
                       for i, sock in enumerate(fleet.sockets)]
            router = fleet_router(config, members)
            image = FleetImageHandler(
                router,
                single_flight=SingleFlight() if config.single_flight
                else None,
                admission=fleet_admission(config, router),
                fallback=fallback)
            # Masks and the merged surfaces ride member 0's sidecar.
            client = members[0].client
            return Front(config, image, db=db,
                         mask_handler=SidecarMaskHandler(client, fallback),
                         client=client)
        client = sidecar_client(config)
        return Front(config, SidecarImageHandler(client, fallback), db=db,
                     mask_handler=SidecarMaskHandler(client, fallback),
                     client=client)
    if handler is None:
        services = build_services(config, device, db=db)
        if config.federation.enabled and config.sidecar.role == "combined":
            fleet_handler, coordinator = build_federated_fleet(config,
                                                               services)
            return Front(config, fleet_handler, db=db,
                         federation=coordinator)
        if fleet.enabled and config.sidecar.role == "combined":
            return Front(config, build_local_fleet(config, services), db=db)
        handler = ImageRegionHandler(services)
    return Front(config, handler, db=db)


def create_app(config: Optional[AppConfig] = None,
               device: Union[str, torch.device] = "cuda",
               handler: Optional[ImageRegionHandler] = None, db=None):
    """The aiohttp application a config describes (default: the JAX
    defaults, ``AppConfig()``).  ``handler`` overrides the one built from
    the config (the test seam).  ``db``, an open ``AsyncDb`` (``fetchrow``
    / ``fetch``), carries the postgres session store and metadata service
    in place of connections from the config's uri and dsn.  Startup sets
    the executor size (``worker_pool_size``), connects the OMERO database's
    metadata service when the config names one and no ``db`` was given
    (degrading to the local service with a warning without ``asyncpg``, as
    the JAX app does), and starts the watchdog and the pyramid job runner;
    cleanup stops them, closes the prefetcher, the database pool, the
    handler's renderer and the byte caches' Redis client.  A frontend
    (:func:`build_front`) watches its sidecar wire and closes its client
    instead."""
    import concurrent.futures as cf

    from aiohttp import web

    config = config or AppConfig()
    for name in config.unserved:
        log.warning("%s is switched on, but the port does not serve it",
                    name)
    front = build_front(config, device, handler, db)
    services, client = front.services, front.client
    watchdog: Optional[Watchdog] = None
    if config.watchdog.enabled:
        def escalate(event: dict) -> None:
            telemetry.FLIGHT.record("watchdog.escalate", **{
                k: v for k, v in event.items() if k != "escalate"})
            log.error("watchdog escalation: %s on %s", event.get("action"),
                      event.get("target"))

        watchdog = build_watchdog(
            config.watchdog,
            renderer=services.renderer if services is not None else None,
            # A federated fleet's remote members are another host's: the
            # wire-hang scan watches this host's sidecars only (JAX).
            clients=[] if front.federation is not None else front.clients(),
            escalate_cb=escalate)
        for renderer in _member_renderers(front):
            # Each in-process member's batcher is a stuck-lane target.
            if hasattr(renderer, "watchdog_scan"):
                renderer.watchdog_stall_factor = config.watchdog.stall_factor
                renderer.watchdog_stall_min_s = config.watchdog.stall_min_s
                renderer.watchdog_escalate_after = (
                    config.watchdog.escalate_after)
                watchdog.add_target(renderer)

    def to_response(answer: Answer) -> web.Response:
        return web.Response(status=answer.status, headers=answer.headers,
                            body=answer.body or None)

    def route_handler(route: str):
        async def serve(request: web.Request) -> web.StreamResponse:
            params = dict(request.query)
            params.update(request.match_info)
            # The tail never reaches the params: /7/0/0 and /7/0/0/ share
            # a cache key and an ETag.
            params.pop("tail", None)
            streamed: list = []

            async def send(answer: Answer) -> None:
                """Write a streamed answer chunk by chunk; a client that
                leaves closes the stream, which cancels the frames still
                queued."""
                resp = web.StreamResponse(status=answer.status,
                                          headers=answer.headers)
                streamed.append(resp)
                try:
                    await resp.prepare(request)
                    async for chunk in answer.stream:
                        await resp.write(chunk)
                    await resp.write_eof()
                except ConnectionResetError:
                    log.debug("%s client disconnected mid-stream", route)
                finally:
                    await answer.stream.aclose()

            answer = await front.observed(
                route, request.method, params, request.headers,
                request.cookies, send)
            return streamed[0] if streamed else to_response(answer)
        return serve

    async def metrics(request: web.Request) -> web.Response:
        sidecar_lines = None
        if client is not None:
            # The sidecar's series, best effort: a dead sidecar must not
            # hang the scrape.
            try:
                status, body = await asyncio.wait_for(
                    client.call("metrics", {}), timeout=2.0)
                if status == 200 and body:
                    sidecar_lines = bytes(body).decode().splitlines()
            except Exception:
                pass
        # Exemplars ride only a scrape that asked for OpenMetrics: the
        # plain text parser refuses their syntax.
        if "application/openmetrics-text" in request.headers.get("Accept",
                                                                  ""):
            return web.Response(
                text=front.metrics_text(True, sidecar_lines),
                content_type="application/openmetrics-text")
        return web.Response(text=front.metrics_text(False, sidecar_lines),
                            content_type="text/plain")

    async def details(request: web.Request) -> web.Response:
        doc = {"provider": PROVIDER, "version": __version__,
               "features": FEATURES,
               "options": {"maxTileLength": (
                   services.max_tile_length if services is not None
                   else config.max_tile_length)}}
        if config.cache_control_header:
            doc["options"]["cacheControl"] = config.cache_control_header
        return web.json_response(doc)

    async def pyramid_submit(request: web.Request) -> web.Response:
        body = await request.read()
        return to_response(await front.observed(
            "pyramid_submit", request.method, {}, request.headers,
            request.cookies, call=lambda: front.pyramid_submit(body)))

    async def pyramid_status(request: web.Request) -> web.Response:
        return to_response(front.pyramid_status(request.match_info["jobId"]))

    async def healthz(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def debug_warmstate(request: web.Request) -> web.Response:
        return web.json_response(await front.warmstate_doc(
            bool(request.query.get("snapshot"))))

    async def debug_flightrecorder(request: web.Request) -> web.Response:
        members = sidecar = None
        if front._remote_fleet():
            members = await front.member_docs("flightrecorder")
        elif client is not None:
            sidecar = await front.sidecar_doc("flightrecorder")
        return web.json_response(front.flight_doc(
            bool(request.query.get("dump")), sidecar=sidecar,
            members=members))

    async def debug_costs(request: web.Request) -> web.Response:
        return web.json_response(front.costs_doc())

    async def debug_decisions(request: web.Request) -> web.Response:
        members = (await front.member_docs("decisions")
                   if front._remote_fleet() else None)
        return web.json_response(front.decisions_doc(members))

    async def debug_exemplars(request: web.Request) -> web.Response:
        return web.json_response(front.exemplars_doc())

    async def debug_sentinel(request: web.Request) -> web.Response:
        sidecar = (await front.sidecar_doc("sentinel")
                   if client is not None else None)
        return web.json_response(front.sentinel_doc(sidecar))

    async def debug_profile(request: web.Request) -> web.Response:
        return to_response(await front.profile(request.query.get("ms")))

    async def debug_explain(request: web.Request) -> web.Response:
        return to_response(await front.explain(request.query.get("path")))

    async def admin_drain(request: web.Request) -> web.Response:
        return to_response(await front.admin_drain(
            request.method, request.query.get("member")))

    async def admin_undrain(request: web.Request) -> web.Response:
        return to_response(front.admin_undrain(request.query.get("member")))

    async def admin_autoscaler(request: web.Request) -> web.Response:
        return to_response(front.admin_autoscaler())

    async def admin_federation(request: web.Request) -> web.Response:
        return to_response(await front.admin_federation(
            bool(request.query.get("agree"))))

    async def readyz(request: web.Request) -> web.Response:
        """200 only when this process can serve renders now; a 503 names
        what it waits for."""
        ok, checks = await front.readiness()
        return web.json_response(
            {"status": "ready" if ok else "degraded", "checks": checks},
            status=200 if ok else 503)

    tasks: list = []

    owned: list = []        # the database pool this app opened

    async def on_startup(app: web.Application) -> None:
        if (services is not None and config.metadata_backend == "postgres"
                and not isinstance(services.metadata, DbMetadataService)):
            try:
                services.metadata = await PostgresMetadataService.connect(
                    config.metadata_dsn)
                owned.append(services.metadata)
            except ImportError:
                log.warning("metadata-service.type is 'postgres' but "
                            "asyncpg is unavailable; using the local "
                            "backend")
        workers = config.worker_pool_size or 2 * (os.cpu_count() or 4)
        asyncio.get_running_loop().set_default_executor(
            cf.ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="render-worker"))
        if watchdog is not None and watchdog._targets:
            tasks.append(asyncio.create_task(watchdog.run(),
                                             name="watchdog"))
        if front.jobs is not None:
            tasks.append(asyncio.create_task(front.jobs.run(),
                                             name="pyramid-jobs"))
        if front.unit_lifecycle is not None:
            # Each member's sidecar unit, spawned at once off the loop;
            # /readyz holds traffic until the members answer their pings.
            await asyncio.to_thread(front.unit_lifecycle.start_all)
        if front.federation is not None:
            # Join: one agreement round with every remote member (a split
            # brain refuses the start), then the gossip loop.
            await front.federation.agree(strict=True)
            tasks.append(asyncio.create_task(front.federation.run(),
                                             name="federation-gossip"))
        for name, loop in front.background():
            tasks.append(asyncio.create_task(loop(), name=name))

    async def on_cleanup(app: web.Application) -> None:
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        front.close()
        op = getattr(front.autoscaler, "_op", None)
        if op is not None and not op.done():
            # A scale-down mid-settle must not outlive the router it drains.
            op.cancel()
            await asyncio.gather(op, return_exceptions=True)
        if front.router is not None:
            # The lanes stop before the member stacks close under them.
            await front.router.close()
        for member_client in front.clients():
            await member_client.close()
        if front.federation is not None:
            from ..parallel import federation
            if federation.current() is front.federation.manifest:
                federation.uninstall()
        if front.unit_lifecycle is not None:
            # The units this app spawned stop with it (no restart).
            await asyncio.to_thread(front.unit_lifecycle.stop_all)
        for renderer in _member_renderers(front):
            await renderer.close()
        for resource in owned + [front.session_store]:
            close = getattr(resource, "close", None)
            if close is not None:
                await close()
        if services is None:
            return
        if services.warmstate is not None:
            # Stop the timer and the rehydrate before the stores they read
            # close under them.
            await asyncio.to_thread(services.warmstate.close)
        if services.prefetcher is not None:
            services.prefetcher.close()
        await services.renderer.close()
        # The disk tier's queued writes, then the one shared Redis client
        # (the memo's too).
        await services.caches.close()
        execcache.uninstall(getattr(services.renderer, "exec_cache", None))

    app = web.Application()
    app[_front_key()] = front
    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    for prefix in ("webgateway", "webclient"):
        for route in ROUTES:
            base = f"/{prefix}/{route}/{{imageId}}/{{theZ}}/{{theT}}"
            serve = route_handler(route)
            app.router.add_get(base, serve)          # GET and HEAD
            app.router.add_get(base + "/{tail:.*}", serve)
    mask = route_handler("render_shape_mask")
    app.router.add_get("/webgateway/render_shape_mask/{shapeId}", mask)
    app.router.add_get("/webgateway/render_shape_mask/{shapeId}/{tail:.*}",
                       mask)
    # Registered whatever the config: a disabled route answers 404 from
    # its handler, as in the JAX app.
    for route in ("render_overlay", "render_animation"):
        base = f"/webgateway/{route}/{{imageId}}/{{theZ}}/{{theT}}"
        serve = route_handler(route)
        app.router.add_get(base, serve)
        app.router.add_get(base + "/{tail:.*}", serve)
    app.router.add_post("/pyramid", pyramid_submit)
    app.router.add_get("/pyramid/{jobId}", pyramid_status)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/readyz", readyz)
    app.router.add_get("/debug/warmstate", debug_warmstate)
    app.router.add_get("/debug/flightrecorder", debug_flightrecorder)
    app.router.add_get("/debug/costs", debug_costs)
    app.router.add_get("/debug/decisions", debug_decisions)
    app.router.add_get("/debug/exemplars", debug_exemplars)
    app.router.add_get("/debug/sentinel", debug_sentinel)
    app.router.add_get("/debug/profile", debug_profile)
    app.router.add_get("/debug/explain", debug_explain)
    app.router.add_get("/admin/drain", admin_drain)
    app.router.add_post("/admin/drain", admin_drain)
    app.router.add_post("/admin/undrain", admin_undrain)
    app.router.add_get("/admin/autoscaler", admin_autoscaler)
    app.router.add_get("/admin/federation", admin_federation)
    app.router.add_route("OPTIONS", "/{tail:.*}", details)
    return app


def _member_renderers(front: Front) -> list:
    """The renderers of a combined fleet's members past member 0 (whose
    renderer is the services')."""
    if front.router is None or front.services is None:
        return []
    return [m.services.renderer for m in front.router.members.values()
            if getattr(m, "services", None) is not None
            and m.services is not front.services]


def _front_key():
    """The app key under which :func:`create_app` keeps its
    :class:`Front` (made at first use: aiohttp is imported lazily)."""
    global _FRONT_KEY
    if _FRONT_KEY is None:
        from aiohttp import web
        _FRONT_KEY = web.AppKey("front", Front)
    return _FRONT_KEY


_FRONT_KEY = None


def run_app(app, config: AppConfig) -> None:
    """Serve on ``config.port`` with the config's HTTP parse limits (the
    reference's ``max-initial-line-length`` / ``max-header-size``, as
    aiohttp's ``max_line_size`` / ``max_field_size`` / ``max_headers``)
    until SIGINT or SIGTERM.  The signal records a ``signal`` flight event
    and starts the shutdown chain (``server.shutdown``: the warm-state
    snapshot, the build store's drain, the flight dump) on a thread of its
    own; its end is awaited (15 s at most) before aiohttp's cleanup closes
    the services, so the snapshot sees them live."""
    import signal

    from aiohttp import web

    from .shutdown import build_shutdown_chain

    front = app.get(_front_key())
    chain = build_shutdown_chain(
        config, front.services if front is not None else None,
        fleet_router=front.router if front is not None else None)

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
        chain_thread: list = []

        def on_signal(signame: str) -> None:
            telemetry.FLIGHT.record("signal", sig=signame)
            if not chain_thread:
                t = threading.Thread(target=chain.run, args=(signame,),
                                     name="shutdown-chain", daemon=True)
                chain_thread.append(t)
                t.start()
            stop.set()

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, on_signal, sig.name)
            except NotImplementedError:
                pass
        try:
            await stop.wait()
            log.info("shutdown signal received")
            if chain_thread:
                await asyncio.to_thread(chain_thread[0].join, 15.0)
        finally:
            await runner.cleanup()
            log.info("shutdown complete")

    asyncio.run(serve())
