"""Service configuration: the JAX package's YAML, for the sections the port
serves.

Counterpart of the JAX package's ``server/config.py``.  ``AppConfig.
from_dict`` takes the same dict (``from_yaml`` the same file, e.g.
``conf/config.example.yaml``) with the same kebab-case keys, and gives the
served settings the same values and the same validation:

* top level: ``port``, ``worker_pool_size``, ``data-dir``,
  ``cache-control-header``, the HTTP parse limits
  (``max-initial-line-length``, ``max-header-size``, ``max-headers``),
  ``omero.server`` (``omero.pixeldata.max_tile_length``,
  ``omero.script_repo_root``, and ``omero.data.dir``: the OMERO binary
  repository an image opens from when the data directory lacks it),
  ``omero.web.session_cookie_name``, ``single-flight``, ``logging``;
* ``session-store``: ``type`` (``static``, ``redis`` or ``postgres``),
  ``uri`` and ``required`` (default: on for redis and postgres), resolved
  into a store by ``server.app.make_session_store`` as the JAX app does;
* ``metadata-service``: ``type`` ``local`` (the data directory) or
  ``postgres`` (the OMERO database, ``services.db_metadata``; needs a
  ``dsn``);
* ``sessions``: ``enabled`` (per-session admission buckets and the
  viewport model that steers the prefetcher), ``bucket-refill-per-s``,
  ``bucket-burst``, ``max-tracked`` and ``prefetch-lookahead``;
* ``batcher`` (with ``max-batch-limit``, the queue-pressure growth
  ceiling, default 2 x ``max-batch``, and ``target-inflight``, the
  backlog split, capped at ``pipeline-depth``), ``raw-cache``
  (``prefetch`` included, on by default as in the JAX package),
  ``renderer``, ``http-cache``, ``watchdog`` (with
  ``wire-hang-s``, the sidecar wire's hang bound), ``fault-tolerance``
  (the deadline, admission, the sidecar client's breaker and retries,
  ``degraded-mode`` and the split role's supervisor) and
  ``fault-injection`` (the lane faults, the wire faults and
  ``die-after-requests``), except the keys that belong to a part not
  ported (XLA's compile cache, ...); ``http-cache`` with ``peer-fetch``
  and ``peer-timeout-ms`` (the fleet's peer byte fetch);
* ``sidecar``: ``role`` (``combined``, ``frontend``, ``sidecar`` or
  ``split``) and ``socket`` (a unix path or ``host:port``; every role but
  ``combined`` needs one, or, for a frontend, an enabled
  ``fleet.sockets``), and ``wire``, the sidecar wire v3's knobs
  (``coalesce-max-frames``, ``coalesce-max-bytes``, ``ring-bytes``,
  ``ring-min-body-bytes``, ``streaming``: a render 200 leaves as an HTTP
  chunked response, on by default, and ``chunk-max-bytes``), with the JAX
  loader's checks;
* ``workloads``: ``device-masks`` (masks rasterized in the batcher's mask
  lane on the card; off: on the host), ``overlay-enabled`` and
  ``animation-enabled`` (off: the route answers 404, as the JAX handler
  does) and ``animation-max-frames``;
* ``pyramid``: ``enabled`` (off: ``POST /pyramid`` and ``GET
  /pyramid/{jobId}`` answer 404, as in the JAX app), ``chunk``,
  ``min-level-size``, ``compressor`` and ``defer-poll-s`` (how often a job
  parked under the pressure ladder's ``shed_bulk`` looks again) of the
  background pyramid job (``server.jobs``);
* the byte caches: ``image-region-cache``, ``pixels-metadata-cache`` and
  ``shape-mask-cache`` (``enabled``), and ``redis-cache.uri`` (the shared
  tier of the three and of the canRead memo), into
  ``services.cache.CacheConfig`` as the JAX loader reads them;
* ``renderer.jpeg-engine``: ``sparse``, ``huffman``, ``auto`` or
  ``bitpack`` (K6, the direct renderer's engine: with ``batcher.enabled``
  it fails the load with the JAX loader's message);
* ``qos``: ``enabled``, ``bulk-cost`` (the fairness tokens a bulk
  request draws from its session's bucket with ``sessions.enabled``) and
  ``interactive-weight`` (the fleet router's weighted two-class queue),
  each >= 1;
* the fleet (``parallel.fleet``): ``fleet`` (``enabled``, ``members``,
  the frontend's ``sockets``, ``lane-width``, ``steal-min-backlog``,
  ``hash-replicas``, ``failover``, ``down-cooldown-s``), ``hotkey`` (the
  hot-plane replication) and ``drain`` (``/admin/drain``'s ``prestage``,
  ``prestage-max-planes``, ``settle-timeout-s`` and ``fail-readyz``), with
  the JAX loader's validation; a ``frontend`` may name ``fleet.sockets``
  in place of ``sidecar.socket``;
* ``renderer.prewarm``: the tile shapes built and launched at startup
  (``server.prewarm``; a malformed spec fails the load, as in JAX);
* ``telemetry``: ``access-log`` (the JSON access line, on by default),
  ``ready-max-queue-depth`` (``/readyz``'s backlog bound),
  ``provenance-header``, the flight recorder's ``flight-recorder-events``
  (the ring's size) and ``flight-recorder-dir`` (where SIGTERM, an SLO
  breach and ``/debug/flightrecorder?dump=1`` write it),
  ``slow-request-ms`` and ``slow-request-dir`` (slow requests' span
  waterfalls), and ``profile-dir`` and ``profile-max-ms``
  (``/debug/profile``'s ``torch.profiler`` traces);
* the forensics and overload sections, with the JAX loader's validation:
  ``slo`` (the burn-rate objectives), ``decisions`` (the decision ledger's
  ring and spool), ``sentinel`` (the perf sentinel, on by default;
  ``records-dir`` is accepted and reads nothing, see ``server.sentinel``)
  and ``pressure`` (the governor and its ladder, off by default;
  ``shed_bulk`` must come before ``tighten_admission``);
* ``persistence`` (off by default, as in JAX): ``enabled``, ``dir`` (the
  disk byte tier under ``bytecache/``, the build store under
  ``executables/``, ``manifest.json``), ``disk-cache-max-bytes``,
  ``executables`` (the build store: built kernel and codec libraries
  kept across deploys, ``server.execcache``), ``snapshot-interval-s``,
  ``snapshot-top-k``, ``max-plane-entries``, ``rehydrate`` and
  ``rehydrate-concurrency`` (``services.warmstate``), with the JAX
  loader's validation.

One default differs on purpose: ``raw-cache.digest-dedup`` is off unless
the file sets it.  The dedup cost a cold GET 19-20 ms on the H100 and saved
no copy (PERF.md, ROADMAP Queue 1 item 9).

* mesh serving (``parallel.mesh``, ``parallel.serve``): ``parallel``
  (``enabled``, ``chan-parallel``, ``n-devices``, ``coordinator-address``,
  ``num-processes``, ``process-id``) as the JAX loader reads it, with its
  errors: ``chan-parallel`` below 1, a coordinator without
  ``num-processes``, ``bitpack`` with ``parallel.enabled`` and
  ``fault-injection.seed`` with a multi-process ``parallel`` section.  A
  position is one process with one GPU (``parallel.cluster``): an
  ``n-devices`` other than the world size fails at startup, by name.

* the elastic control plane (``server.autoscaler``,
  ``services.loadmodel``): ``autoscaler`` and ``loadmodel`` as the JAX
  loader reads them, with its errors, the cross-section ones included:
  ``autoscaler.unit-config`` needs ``fleet.sockets``, ``autoscaler.enabled``
  a fleet, and ``autoscaler.floor`` at most the provisioned members.

* the cross-host federation (``parallel.federation``): ``federation``
  (``enabled``, ``host``, ``shard-epoch``, ``ring-seed``,
  ``hash-replicas``, ``gossip-interval-s``, ``quorum``,
  ``suspect-after-s``, ``roll-ack-timeout-s``, ``members``) as the JAX
  loader reads it, with its errors in its order: the members' shape, the
  epoch, the replicas and the intervals, ``quorum`` only with
  ``enabled``; and with ``enabled``, at least two members, unique names, a
  ``host`` (by default ``parallel.cluster.host_identity()``) that owns a
  member, and no ``fleet.sockets`` beside it.

Everything else is read and checked against the JAX default.  A section
that is switched off (``enabled: false``) is inert.  A boolean set from
``true`` to ``false`` switches off a feature the port does not have, which
is what the port does.  Any other value away from the JAX default fails
the load with a ``ValueError`` that names the setting and says the port
does not serve it yet.  ``AppConfig.unserved`` would name a section that
loads but is not served, with a warning at startup; since the byte caches
are served, no section is.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..services.cache import CacheConfig
from ..utils.faultinject import FaultInjectionConfig
from .httpcache import EPOCH_RE


@dataclass
class BatcherConfig:
    enabled: bool = True
    max_batch: int = 8
    # The queue-pressure growth ceiling; None: 2 x max_batch.
    max_batch_limit: Optional[int] = None
    linger_ms: float = 2.0
    pipeline_depth: int = 4
    # Concurrent groups a backlog is split across (1: max_batch groups).
    target_inflight: int = 1
    device_lanes: int = 2


@dataclass
class QosConfig:
    """Tiered QoS: a bulk request (a projection or a full plane) draws
    ``bulk_cost`` session tokens; ``interactive_weight`` is the fleet
    router's, stored for it."""

    enabled: bool = False
    interactive_weight: int = 4
    bulk_cost: float = 4.0


@dataclass
class RawCacheConfig:
    """The device raw cache (``io.devicecache.DeviceRawCache``)."""

    enabled: bool = True
    max_bytes: int = 2 * 1024 * 1024 * 1024
    digest_dedup: bool = False
    prefetch: bool = True          # the predicted next tiles, staged


@dataclass
class RendererConfig:
    # JPEG regions of at most this many pixels are rendered on the card
    # and encoded with PIL (the port's ``jpeg_host_max_px``; the JAX
    # package renders them on the host CPU, with the same bytes).
    cpu_fallback_max_px: int = 256 * 256
    jpeg_engine: str = "sparse"
    # Tile shapes built and launched at startup, on a background thread
    # behind /readyz (server.prewarm): "<channels>x<edge>[@q][:dtype]".
    prewarm: Tuple[str, ...] = ()


@dataclass
class TelemetryConfig:
    """The request telemetry (the JAX ``TelemetryConfig``): the JSON access
    log, the ``/readyz`` backlog bound, the provenance debug header, the
    flight recorder (``utils.telemetry.FLIGHT``), the slow-request
    waterfalls and ``/debug/profile``'s captures."""

    # Requests slower than this write their span waterfall as JSON into
    # slow_request_dir; 0 disables it.
    slow_request_ms: float = 0.0
    slow_request_dir: str = "./slow-traces"
    access_log: bool = True
    ready_max_queue_depth: int = 64
    provenance_header: bool = False
    flight_recorder_events: int = 512
    flight_recorder_dir: str = "./flight-recorder"
    # /debug/profile?ms=N writes its torch.profiler trace here; a request
    # is clamped to profile_max_ms.
    profile_dir: str = "./profiles"
    profile_max_ms: float = 10000.0


@dataclass
class SloConfig:
    """Service-level objectives as multi-window burn rates
    (``utils.telemetry.SLO``); both off by default."""

    availability_target: float = 0.0     # 0: off
    latency_ms: float = 0.0               # 0: off
    latency_target: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    breach_burn_rate: float = 14.4


@dataclass
class DecisionsConfig:
    """The decision ledger (``utils.decisions.LEDGER``)."""

    ring_size: int = 256
    spool_dir: str = ""                   # "": no JSONL spool
    outcome_horizon_ticks: int = 3


@dataclass
class SentinelConfig:
    """The live perf-regression sentinel (``server.sentinel``), on by
    default.  ``records_dir`` is accepted and read by nothing: the repo's
    records are the JAX package's TPU and CPU runs
    (``server.sentinel.load_repo_watermarks``)."""

    enabled: bool = True
    tick_interval_s: float = 5.0
    confirm_ticks: int = 3
    recover_ticks: int = 3
    min_samples: int = 32
    warmup_ticks: int = 3
    drift_ratio: float = 1.5
    baseline_alpha: float = 0.2
    throughput_floor_ratio: float = 0.5
    bundle_dir: str = ""                  # "": no incident bundle
    max_bundles: int = 8
    profile_ms: int = 200
    records_dir: str = "."


@dataclass
class PressureConfig:
    """The pressure governor and its brownout ladder
    (``server.pressure``), off by default."""

    enabled: bool = False
    interval_s: float = 1.0
    # Enter elevated at ``high``, leave below ``low``; ``high x
    # critical-factor`` reads critical; high 0 disables the signal.
    hbm_high: float = 0.90
    hbm_low: float = 0.75
    host_rss_high_mb: float = 0.0
    host_rss_low_mb: float = 0.0
    disk_high: float = 0.95
    disk_low: float = 0.85
    queue_high: int = 48
    queue_low: int = 16
    loop_lag_high_ms: float = 250.0
    loop_lag_low_ms: float = 50.0
    critical_factor: float = 1.25
    step_hold_ticks: int = 2
    release_hold_ticks: int = 3
    ladder: Tuple[str, ...] = (
        "pause_prefetch", "pause_snapshots", "evict_caches",
        "cap_lanes", "drop_quality", "shed_bulk",
        "tighten_admission")
    quality_cap: int = 60              # drop_quality: JPEG ceiling
    evict_to_frac: float = 0.70        # evict_caches: low-water target
    lane_cap: int = 1                  # cap_lanes: groups on a lane
    admission_scale: float = 0.25      # tighten_admission multiplier
    prefetch_budget_elevated: float = 0.5
    prefetch_budget_critical: float = 0.25


@dataclass
class PersistenceConfig:
    """What survives a restart (the JAX ``PersistenceConfig``): the disk
    byte tier (``services.diskcache``), the build store
    (``server.execcache``) and the warm-state manifest
    (``services.warmstate``).  Off by default."""

    enabled: bool = False
    # bytecache/, executables/ and manifest.json live under it.
    dir: str = "./warm-state"
    disk_cache_max_bytes: int = 1024 * 1024 * 1024
    # The build store: nvcc and g++ libraries kept across deploys.
    executables: bool = True
    # 0 disables the timer; SIGTERM snapshots through the shutdown chain.
    snapshot_interval_s: float = 60.0
    snapshot_top_k: int = 512
    max_plane_entries: int = 256
    rehydrate: bool = True
    rehydrate_concurrency: int = 2


@dataclass
class HttpConfig:
    """Request parse limits, mapped onto aiohttp's ``max_line_size`` /
    ``max_field_size`` / ``max_headers``."""

    max_initial_line_length: int = 4096
    max_header_size: int = 8192
    max_headers: int = 32768


@dataclass
class HttpCacheConfig:
    """Conditional HTTP (``server.httpcache``) and the fleet's peer byte
    fetch."""

    enabled: bool = True
    epoch: str = "0"               # "auto": derived from the data tree
    max_age_s: int = 0             # 0: "no-cache", revalidate every serve
    vary_acl: bool = True
    # A fleet asks the shard authority's byte tier before a re-render on
    # another member (sidecar members only), within peer_timeout_ms.
    peer_fetch: bool = True
    peer_timeout_ms: float = 500.0


@dataclass
class FleetConfig:
    """The consistent-hash fleet (``parallel.fleet``): N members, each
    owning a shard of the card's raw-cache state, routed by plane
    identity, with bounded stealing and hash-ring-next failover."""

    enabled: bool = False
    # Combined role: in-process members (member 0 is the base stack; the
    # others get their own renderer and raw cache), all on the app's card.
    members: int = 2
    # Frontend role: one render sidecar per address (overrides members).
    sockets: Tuple[str, ...] = ()
    lane_width: int = 2            # concurrent renders per member
    # An idle lane steals the oldest queued request of the most backlogged
    # peer at this depth; 0: no stealing.
    steal_min_backlog: int = 2
    hash_replicas: int = 64        # virtual nodes per member
    failover: bool = True          # a dead member's shard moves ring-next
    down_cooldown_s: float = 5.0   # a dead member's time out of the ring


@dataclass
class ParallelConfig:
    """Mesh-sharded serving (``parallel.serve``): every coalesced group
    through a ``(data, chan)`` mesh of processes, one GPU each; tiles
    data-parallel, channels tensor-parallel (K12)."""

    enabled: bool = False
    chan_parallel: int = 1
    # None: the world size.  One process per position, so any other value
    # is refused at startup.
    n_devices: Optional[int] = None
    # The tcp:// init (host:port), world size and rank of a pod; None: the
    # torch.distributed environment, or standalone.
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclass
class HotkeyConfig:
    """Hot-plane replication: a route whose decayed heat passes
    ``threshold`` gets a replica set, a prefix of its ring chain, and
    reads balance across the live replicas."""

    enabled: bool = False
    threshold: float = 12.0
    decay_s: float = 20.0
    max_replicas: int = 2
    top_k: int = 128
    demote_fraction: float = 0.5
    # The autoscaler's scale-up signal: grow once the hottest promoted
    # route's heat reaches this many promotion thresholds (0: off).
    scale_factor: float = 2.0


@dataclass
class DrainConfig:
    """Rolling drains (``/admin/drain``)."""

    prestage: bool = True          # the shard handed warm to successors
    prestage_max_planes: int = 256
    settle_timeout_s: float = 30.0
    # /readyz answers 503 while an operator drain is on.
    fail_readyz: bool = False


@dataclass
class WatchdogConfig:
    """The stuck-lane and hung-wire watchdog (``server.watchdog``)."""

    enabled: bool = True
    interval_s: float = 2.0
    stall_factor: float = 8.0
    stall_min_s: float = 30.0
    escalate_after: int = 2
    # A sidecar connection with requests in flight and no frame received
    # for this long is dropped (0: no scan).
    wire_hang_s: float = 60.0


@dataclass
class FaultToleranceConfig:
    request_deadline_ms: float = 0.0     # 0: no deadline
    # The sidecar client's breaker: this many consecutive connection
    # failures open it; after breaker-reset-s one trial call goes through.
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 5.0
    # The idempotent sidecar ops' attempts and capped backoff.
    retry_max_attempts: int = 3
    retry_base_backoff_ms: float = 25.0
    retry_max_backoff_ms: float = 1000.0
    admission_max_queue: int = 512       # 0: no admission control
    shed_retry_after_s: float = 1.0
    # A frontend renders on its own CPU (server.degraded) while the
    # sidecar is unreachable; off: it answers 503.
    degraded_mode: bool = False
    # --role split: restart a dead sidecar child with capped backoff.
    supervise: bool = True
    supervisor_max_backoff_s: float = 30.0


@dataclass
class SidecarConfig:
    """The frontend/sidecar process split (``server.sidecar``).

    role: ``combined`` (one process, HTTP and the card; the default),
    ``frontend`` (HTTP only, renders forwarded to ``socket``), ``sidecar``
    (the card only, serving renders on ``socket``) or ``split`` (spawn a
    sidecar child, then serve as a frontend)."""

    socket: Optional[str] = None
    role: str = "combined"


@dataclass
class WireConfig:
    """The sidecar wire v3 (``server.sidecar``): frame coalescing bounds,
    the same-host shared-memory ring and chunked streaming."""

    coalesce_max_frames: int = 64
    coalesce_max_bytes: int = 1024 * 1024
    # Bodies of at least ring-min-body-bytes ride a shared-memory ring of
    # ring-bytes per direction (0: no ring).
    ring_bytes: int = 32 * 1024 * 1024
    ring_min_body_bytes: int = 4096
    # A render 200 leaves as an HTTP chunked response (the sidecar's
    # chunk frames forwarded as they arrive); off: one body.
    streaming: bool = True
    chunk_max_bytes: int = 256 * 1024


@dataclass
class WorkloadsConfig:
    """The mask lane and the overlay and animation routes."""

    device_masks: bool = True
    overlay_enabled: bool = True
    animation_enabled: bool = True
    animation_max_frames: int = 64


@dataclass
class PyramidConfig:
    """The background pyramid job (``server.jobs``)."""

    enabled: bool = True
    chunk: int = 256                # NGFF chunk edge of written levels
    min_level_size: int = 256       # stop halving below this
    compressor: str = "zlib"        # zlib | gzip | none
    defer_poll_s: float = 0.25      # parked under shed_bulk: re-check


@dataclass
class SessionsConfig:
    """Session-aware serving: the per-session admission buckets
    (``server.admission``) and the viewport model (``services.viewport``)
    that steers the prefetcher."""

    enabled: bool = False
    bucket_refill_per_s: float = 20.0    # tokens (requests) per second
    bucket_burst: float = 40.0
    max_tracked: int = 4096              # LRU bound of buckets and states
    prefetch_lookahead: int = 2          # pan steps predicted ahead


@dataclass
class LoadModelConfig:
    """The open-loop load model (``services.loadmodel.LoadModel
    .from_config``): the simulated viewer population, seeded, so one seed
    gives one event stream."""

    seed: int = 1234
    viewers: int = 10000
    # Lognormal think time between a viewer's requests, and session
    # length in requests.
    think_time_median_ms: float = 350.0
    think_time_sigma: float = 1.0
    session_length_median: float = 24.0
    session_length_sigma: float = 1.2
    # Session starts bunch toward the peak of a half-sine day.
    diurnal_amplitude: float = 0.6
    # The class mix (the rest is interactive tiles).
    bulk_fraction: float = 0.02
    mask_fraction: float = 0.0
    pyramid_fraction: float = 0.0
    animation_fraction: float = 0.0
    zoom_fraction: float = 0.05          # pan steps that change level
    # Zipf popularity skew over image ranks (0: every session on rank 0).
    skew: float = 0.0
    image_population: int = 1


@dataclass
class AutoscalerConfig:
    """The elastic fleet autoscaler (``server.autoscaler``): scales the
    fleet's members between ``floor`` and ``ceiling`` by drains with a
    warm handoff and undrains with pre-stage-back."""

    enabled: bool = False
    interval_s: float = 2.0
    floor: int = 1
    ceiling: int = 0                     # 0: every member
    # Fleet depth per routable lane: sustained >= high grows, <= low
    # shrinks (the hysteresis band).
    queue_high_per_lane: float = 3.0
    queue_low_per_lane: float = 0.5
    hold_ticks: int = 2                  # consecutive readings to act
    cooldown_s: float = 30.0             # least spacing of transitions
    # Requests/s a lane serves; > 0 arms the predicted-demand signal.
    lane_capacity_tps: float = 0.0
    session_tps: float = 2.0             # steady requests/s a session
    # The diurnal fit's period (0: off) and how far ahead it looks.
    diurnal_period_s: float = 86400.0
    diurnal_horizon_s: float = 300.0
    # A sidecar config path: the frontend spawns each fleet.sockets
    # member's unit, and a scale-down stops it ("": operator-owned).
    unit_config: str = ""


@dataclass
class FederationConfig:
    """The cross-host federation (``parallel.federation``): the fleet's
    membership as a versioned manifest every host carries alike, agreed by
    digest at join (``manifest_hello``), gossiped, rolled in two phases and
    drained across hosts over ``shard_transfer``."""

    enabled: bool = False
    # This process's host; it must own at least one member ("": the
    # cluster layer's host identity).
    host: str = ""
    # The shard epoch: bumped with every membership or ring change.
    shard_epoch: int = 1
    # Folded into every ring point ("" keeps the single-host owners).
    ring_seed: str = ""
    hash_replicas: int = 64
    gossip_interval_s: float = 5.0
    # A host that hears no strict majority of manifest hosts within
    # suspect_after_s fences (refuses adoption, write-backs, promotions,
    # autoscaling and rolls) until the partition heals.
    quorum: bool = False
    suspect_after_s: float = 10.0
    roll_ack_timeout_s: float = 5.0
    # Every member fleet-wide, in ring order: {name, host, address}, the
    # address (unix path or host:port) needed by other hosts.
    members: Tuple[dict, ...] = ()


@dataclass
class LoggingConfig:
    level: str = "INFO"
    file: Optional[str] = None           # a time-rolling file appender
    when: str = "midnight"
    backup_count: int = 7


# The unported keys of the served sections, with their JAX defaults.
_UNPORTED_KEYS = {
    "batcher": {},
    "raw-cache": {},
    "renderer": {"kernel": "xla", "compilation-cache-dir": None},
    "telemetry": {},
    "http-cache": {},
    "watchdog": {},
    "fault-tolerance": {},
    "fault-injection": {},
    "omero.server": {},
    "pyramid": {},
    "session-store": {},
    "metadata-service": {},
}


def _same(value, default) -> bool:
    if isinstance(value, list):
        value = tuple(value)
    return value == default


def _refuse(name: str, value) -> ValueError:
    return ValueError(f"{name}: {value!r} is not served by the port yet "
                      f"(omero_ms_image_region_tpu_torch serves only the "
                      f"JAX default here)")


def _check(section: str, block: dict, defaults: dict,
           served=()) -> None:
    """Hold ``block``'s keys outside ``served`` to ``defaults``."""
    for key, value in block.items():
        if key in served:
            continue
        name = f"{section}.{key}"
        if key not in defaults:
            raise ValueError(f"{name}: unknown setting; the port cannot "
                             f"check it against the JAX default")
        default = defaults[key]
        if _same(value, default) or (default is True and value is False):
            continue
        raise _refuse(name, value)


def _block(raw: dict, name: str) -> dict:
    block = raw.get(name, {}) or {}
    if not isinstance(block, dict):
        raise ValueError(f"{name} must be a mapping")
    return block


@dataclass
class AppConfig:
    port: int = 8080
    # None: 2 x cores; sizes the executor every render offload runs on.
    worker_pool_size: Optional[int] = None
    data_dir: str = "./data"
    max_tile_length: int = 2048            # omero.pixeldata.max_tile_length
    cache_control_header: str = ""
    lut_root: Optional[str] = None         # omero.script_repo_root
    # The OMERO binary repository (omero.data.dir); None: off.
    omero_data_dir: Optional[str] = None
    session_cookie_name: str = "sessionid"
    session_store_type: Optional[str] = None   # redis | postgres | static
    session_store_uri: Optional[str] = None
    # None: on for the redis and postgres stores, off for static or none.
    session_store_required: Optional[bool] = None
    metadata_backend: str = "local"            # local | postgres
    metadata_dsn: Optional[str] = None
    single_flight: bool = True
    batcher: BatcherConfig = field(default_factory=BatcherConfig)
    raw_cache: RawCacheConfig = field(default_factory=RawCacheConfig)
    renderer: RendererConfig = field(default_factory=RendererConfig)
    http: HttpConfig = field(default_factory=HttpConfig)
    http_cache: HttpCacheConfig = field(default_factory=HttpCacheConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    sidecar: SidecarConfig = field(default_factory=SidecarConfig)
    wire: WireConfig = field(default_factory=WireConfig)
    fault_tolerance: FaultToleranceConfig = field(
        default_factory=FaultToleranceConfig)
    fault_injection: FaultInjectionConfig = field(
        default_factory=FaultInjectionConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    workloads: WorkloadsConfig = field(default_factory=WorkloadsConfig)
    pyramid: PyramidConfig = field(default_factory=PyramidConfig)
    sessions: SessionsConfig = field(default_factory=SessionsConfig)
    caches: CacheConfig = field(default_factory=CacheConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    persistence: PersistenceConfig = field(
        default_factory=PersistenceConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    decisions: DecisionsConfig = field(default_factory=DecisionsConfig)
    sentinel: SentinelConfig = field(default_factory=SentinelConfig)
    pressure: PressureConfig = field(default_factory=PressureConfig)
    qos: QosConfig = field(default_factory=QosConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    hotkey: HotkeyConfig = field(default_factory=HotkeyConfig)
    drain: DrainConfig = field(default_factory=DrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    loadmodel: LoadModelConfig = field(default_factory=LoadModelConfig)
    autoscaler: AutoscalerConfig = field(default_factory=AutoscalerConfig)
    federation: FederationConfig = field(default_factory=FederationConfig)
    # Sections switched on that the port loads but does not serve (none
    # today).
    unserved: Tuple[str, ...] = ()

    @classmethod
    def from_yaml(cls, path: str) -> "AppConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "AppConfig":
        cfg = cls()
        cfg.port = int(raw.get("port", cfg.port))
        if raw.get("worker_pool_size") is not None:
            cfg.worker_pool_size = int(raw["worker_pool_size"])
            if cfg.worker_pool_size <= 0:
                raise ValueError("worker_pool_size must be positive")
        cfg.http = HttpConfig(
            max_initial_line_length=int(raw.get(
                "max-initial-line-length",
                cfg.http.max_initial_line_length)),
            max_header_size=int(raw.get("max-header-size",
                                        cfg.http.max_header_size)),
            max_headers=int(raw.get("max-headers", cfg.http.max_headers)))
        lg = _block(raw, "logging")
        cfg.logging = LoggingConfig(
            level=str(lg.get("level", cfg.logging.level)),
            file=lg.get("file"),
            when=str(lg.get("when", cfg.logging.when)),
            backup_count=int(lg.get("backup-count",
                                    cfg.logging.backup_count)))
        cfg.data_dir = raw.get("data-dir", cfg.data_dir)
        server = _block(raw, "omero.server")
        _check("omero.server", server, _UNPORTED_KEYS["omero.server"],
               served=("omero.pixeldata.max_tile_length",
                       "omero.script_repo_root", "omero.data.dir"))
        cfg.max_tile_length = int(server.get(
            "omero.pixeldata.max_tile_length", cfg.max_tile_length))
        cfg.lut_root = server.get("omero.script_repo_root", cfg.lut_root)
        cfg.omero_data_dir = server.get("omero.data.dir",
                                        cfg.omero_data_dir)
        cfg.cache_control_header = raw.get("cache-control-header",
                                           cfg.cache_control_header)
        cfg._http_cache(_block(raw, "http-cache"))
        cfg.session_cookie_name = _block(raw, "omero.web").get(
            "session_cookie_name", cfg.session_cookie_name)
        store = _block(raw, "session-store")
        _check("session-store", store, _UNPORTED_KEYS["session-store"],
               served=("type", "uri", "required"))
        cfg.session_store_type = store.get("type")
        cfg.session_store_uri = store.get("uri")
        if store.get("required") is not None:
            cfg.session_store_required = bool(store["required"])
        cfg._metadata_service(_block(raw, "metadata-service"))
        cfg._caches(raw)
        cfg._batcher(_block(raw, "batcher"))
        sf = raw.get("single-flight")
        # An empty section (its children commented out) parses as None
        # and keeps the default.
        if isinstance(sf, dict):
            cfg.single_flight = bool(sf.get("enabled", cfg.single_flight))
        elif sf is not None:
            cfg.single_flight = bool(sf)
        rc = _block(raw, "raw-cache")
        _check("raw-cache", rc, _UNPORTED_KEYS["raw-cache"],
               served=("enabled", "max-bytes", "digest-dedup", "prefetch"))
        cfg.raw_cache = RawCacheConfig(
            enabled=bool(rc.get("enabled", cfg.raw_cache.enabled)),
            max_bytes=int(rc.get("max-bytes", cfg.raw_cache.max_bytes)),
            digest_dedup=bool(rc.get("digest-dedup",
                                     cfg.raw_cache.digest_dedup)),
            prefetch=bool(rc.get("prefetch", cfg.raw_cache.prefetch)))
        cfg._sessions(_block(raw, "sessions"))
        cfg._loadmodel(_block(raw, "loadmodel"))
        cfg._sidecar(_block(raw, "sidecar"), _block(raw, "wire"),
                     _block(raw, "fleet"))
        cfg._fleet(_block(raw, "fleet"), _block(raw, "hotkey"))
        cfg._federation(_block(raw, "federation"))
        cfg._parallel(_block(raw, "parallel"))
        cfg._watchdog(_block(raw, "watchdog"))
        cfg._drain(_block(raw, "drain"))
        cfg._fault_tolerance(_block(raw, "fault-tolerance"))
        cfg._fault_injection(_block(raw, "fault-injection"))
        if (cfg.fault_injection.seed is not None and cfg.parallel.enabled
                and (cfg.parallel.num_processes or 1) > 1):
            # Chaos fires on the process that installed it: on a pod it
            # would stall or fail one rank's lockstep sequence and hang
            # the rest (a pod joined from the environment is disarmed at
            # startup instead).  The JAX loader's check.
            raise ValueError("fault-injection.seed cannot be combined "
                             "with a multi-host parallel config")
        cfg._renderer(_block(raw, "renderer"))
        cfg._telemetry(_block(raw, "telemetry"))
        cfg._slo(_block(raw, "slo"))
        cfg._decisions(_block(raw, "decisions"))
        cfg._sentinel(_block(raw, "sentinel"))
        cfg._pressure(_block(raw, "pressure"))
        cfg._persistence(_block(raw, "persistence"))
        cfg._workloads(_block(raw, "workloads"))
        cfg._pyramid(_block(raw, "pyramid"))
        cfg._autoscaler(_block(raw, "autoscaler"))
        cfg._qos(_block(raw, "qos"))
        if (cfg.renderer.jpeg_engine == "bitpack"
                and (cfg.batcher.enabled or cfg.parallel.enabled)):
            # bitpack has no batched group form (the JAX loader's check).
            raise ValueError(
                "renderer.jpeg-engine 'bitpack' is only supported by "
                "the direct (unbatched) renderer; with batcher.enabled "
                "or parallel.enabled use 'sparse', 'huffman' or 'auto'")
        return cfg

    def _federation(self, fe: dict) -> None:
        """The JAX loader's ``federation`` block and its checks, in its
        order (JAX ``:1169-1258``); after the fleet, whose ``sockets`` it
        excludes."""
        d = FederationConfig()
        _check("federation", fe, {}, served=tuple(
            f.replace("_", "-") for f in d.__dataclass_fields__))
        members_raw = fe.get("members", ()) or ()
        if not isinstance(members_raw, (list, tuple)):
            raise ValueError("federation.members must be a list of "
                             "{name, host, address?} entries")
        members = []
        for i, m in enumerate(members_raw):
            if not isinstance(m, dict) or not m.get("name") \
                    or not m.get("host"):
                raise ValueError(f"federation.members[{i}] must be a "
                                 f"mapping with at least name and host")
            members.append({"name": str(m["name"]), "host": str(m["host"]),
                            "address": str(m.get("address") or "")})
        self.federation = f = FederationConfig(
            enabled=bool(fe.get("enabled", d.enabled)),
            host=str(fe.get("host", d.host) or ""),
            shard_epoch=int(fe.get("shard-epoch", d.shard_epoch)),
            ring_seed=str(fe.get("ring-seed", d.ring_seed) or ""),
            hash_replicas=int(fe.get("hash-replicas", d.hash_replicas)),
            gossip_interval_s=float(fe.get("gossip-interval-s",
                                           d.gossip_interval_s)),
            quorum=bool(fe.get("quorum", d.quorum)),
            suspect_after_s=float(fe.get("suspect-after-s",
                                         d.suspect_after_s)),
            roll_ack_timeout_s=float(fe.get("roll-ack-timeout-s",
                                            d.roll_ack_timeout_s)),
            members=tuple(members))
        if f.shard_epoch < 1:
            raise ValueError("federation.shard-epoch must be >= 1 "
                             "(bump it with every membership change)")
        if f.hash_replicas < 1:
            raise ValueError("federation.hash-replicas must be >= 1")
        if f.gossip_interval_s <= 0:
            raise ValueError("federation.gossip-interval-s must be > 0")
        if f.suspect_after_s <= 0:
            raise ValueError("federation.suspect-after-s must be > 0")
        if f.roll_ack_timeout_s <= 0:
            raise ValueError("federation.roll-ack-timeout-s must be > 0")
        if f.quorum and not f.enabled:
            raise ValueError("federation.quorum requires "
                             "federation.enabled (quorum is a verdict "
                             "over manifest hosts)")
        if not f.enabled:
            return
        if len(f.members) < 2:
            raise ValueError("federation.enabled requires >= 2 members "
                             "(one host needs no federation — use "
                             "fleet.members)")
        names = [m["name"] for m in f.members]
        if len(set(names)) != len(names):
            raise ValueError("federation.members names must be unique "
                             "fleet-wide")
        if not f.host:
            from ..parallel.cluster import host_identity
            f.host = host_identity()
        hosts = {m["host"] for m in f.members}
        if f.host not in hosts:
            raise ValueError(
                f"federation.host {f.host!r} owns no manifest member "
                f"(hosts: {sorted(hosts)}); set federation.host "
                f"explicitly, or name manifest hosts by "
                f"cluster.host_identity() — the default when the key is "
                f"omitted")
        # A remote member's address is checked where the topology is
        # built (``build_federated_members``): only a routing process
        # dials them.
        if self.fleet.sockets:
            raise ValueError(
                "federation.enabled and fleet.sockets are mutually "
                "exclusive — the manifest IS the membership; list remote "
                "members with addresses in federation.members instead")

    def _parallel(self, par: dict) -> None:
        _check("parallel", par, {},
               served=("enabled", "chan-parallel", "n-devices",
                       "coordinator-address", "num-processes",
                       "process-id"))

        def opt_int(key):
            return int(par[key]) if par.get(key) is not None else None

        d = ParallelConfig()
        self.parallel = ParallelConfig(
            enabled=bool(par.get("enabled", d.enabled)),
            chan_parallel=int(par.get("chan-parallel", d.chan_parallel)),
            n_devices=opt_int("n-devices"),
            coordinator_address=par.get("coordinator-address"),
            num_processes=opt_int("num-processes"),
            process_id=opt_int("process-id"))
        if self.parallel.chan_parallel < 1:
            raise ValueError("parallel.chan-parallel must be >= 1")
        if (self.parallel.coordinator_address is not None
                and self.parallel.num_processes is None):
            raise ValueError("parallel.coordinator-address requires "
                             "num-processes and process-id")

    def _qos(self, qo: dict) -> None:
        _check("qos", qo, {},
               served=("enabled", "interactive-weight", "bulk-cost"))
        d = QosConfig()
        self.qos = QosConfig(
            enabled=bool(qo.get("enabled", d.enabled)),
            interactive_weight=int(qo.get("interactive-weight",
                                          d.interactive_weight)),
            bulk_cost=float(qo.get("bulk-cost", d.bulk_cost)))
        if self.qos.interactive_weight < 1:
            raise ValueError("qos.interactive-weight must be >= 1")
        if self.qos.bulk_cost < 1:
            raise ValueError("qos.bulk-cost must be >= 1")

    def _metadata_service(self, meta: dict) -> None:
        _check("metadata-service", meta, _UNPORTED_KEYS["metadata-service"],
               served=("type", "dsn"))
        self.metadata_backend = str(meta.get("type", self.metadata_backend))
        self.metadata_dsn = meta.get("dsn")
        if self.metadata_backend not in ("local", "postgres"):
            raise ValueError(
                "metadata-service.type must be 'local' or 'postgres', "
                f"got {self.metadata_backend!r}")
        if self.metadata_backend == "postgres" and not self.metadata_dsn:
            raise ValueError("metadata-service.type 'postgres' requires "
                             "a dsn")

    def _sessions(self, se: dict) -> None:
        _check("sessions", se, {},
               served=("enabled", "bucket-refill-per-s", "bucket-burst",
                       "max-tracked", "prefetch-lookahead"))
        d = SessionsConfig()
        self.sessions = SessionsConfig(
            enabled=bool(se.get("enabled", d.enabled)),
            bucket_refill_per_s=float(se.get("bucket-refill-per-s",
                                             d.bucket_refill_per_s)),
            bucket_burst=float(se.get("bucket-burst", d.bucket_burst)),
            max_tracked=int(se.get("max-tracked", d.max_tracked)),
            prefetch_lookahead=int(se.get("prefetch-lookahead",
                                          d.prefetch_lookahead)))
        if self.sessions.bucket_refill_per_s <= 0:
            raise ValueError("sessions.bucket-refill-per-s must be > 0")
        if self.sessions.bucket_burst < 1:
            raise ValueError("sessions.bucket-burst must be >= 1")
        if self.sessions.max_tracked < 1:
            raise ValueError("sessions.max-tracked must be >= 1")
        if self.sessions.prefetch_lookahead < 1:
            raise ValueError("sessions.prefetch-lookahead must be >= 1")

    def _http_cache(self, hc: dict) -> None:
        _check("http-cache", hc, _UNPORTED_KEYS["http-cache"],
               served=("enabled", "epoch", "max-age-s", "vary-acl",
                       "peer-fetch", "peer-timeout-ms"))
        d = HttpCacheConfig()
        self.http_cache = HttpCacheConfig(
            enabled=bool(hc.get("enabled", d.enabled)),
            epoch=str(hc.get("epoch", d.epoch)),
            max_age_s=int(hc.get("max-age-s", d.max_age_s)),
            vary_acl=bool(hc.get("vary-acl", d.vary_acl)),
            peer_fetch=bool(hc.get("peer-fetch", d.peer_fetch)),
            peer_timeout_ms=float(hc.get("peer-timeout-ms",
                                         d.peer_timeout_ms)))
        if not EPOCH_RE.match(self.http_cache.epoch):
            raise ValueError("http-cache.epoch must match [A-Za-z0-9._-]+, "
                             f"got {self.http_cache.epoch!r}")
        if self.http_cache.max_age_s < 0:
            raise ValueError("http-cache.max-age-s must be >= 0 "
                             "(0 = no-cache, revalidate every serve)")
        if self.http_cache.peer_timeout_ms <= 0:
            raise ValueError("http-cache.peer-timeout-ms must be > 0")

    def _batcher(self, b: dict) -> None:
        _check("batcher", b, _UNPORTED_KEYS["batcher"],
               served=("enabled", "max-batch", "max-batch-limit",
                       "linger-ms", "pipeline-depth", "target-inflight",
                       "device-lanes"))
        d = BatcherConfig()
        self.batcher = BatcherConfig(
            enabled=bool(b.get("enabled", d.enabled)),
            max_batch=int(b.get("max-batch", d.max_batch)),
            max_batch_limit=(int(b["max-batch-limit"])
                             if b.get("max-batch-limit") is not None
                             else None),
            linger_ms=float(b.get("linger-ms", d.linger_ms)),
            pipeline_depth=int(b.get("pipeline-depth", d.pipeline_depth)),
            target_inflight=int(b.get("target-inflight",
                                      d.target_inflight)),
            device_lanes=int(b.get("device-lanes", d.device_lanes)))
        if self.batcher.pipeline_depth < 1:
            raise ValueError("batcher.pipeline-depth must be >= 1")
        if self.batcher.target_inflight < 1:
            raise ValueError("batcher.target-inflight must be >= 1")
        if self.batcher.device_lanes < 1:
            raise ValueError("batcher.device-lanes must be >= 1")

    def _sidecar(self, sc: dict, wi: dict, fl: dict) -> None:
        _check("sidecar", sc, {}, served=("socket", "role"))
        d = SidecarConfig()
        self.sidecar = SidecarConfig(socket=sc.get("socket", d.socket),
                                     role=str(sc.get("role", d.role)))
        if self.sidecar.role not in ("combined", "frontend", "sidecar",
                                     "split"):
            raise ValueError(f"invalid sidecar.role {self.sidecar.role!r}")
        if (self.sidecar.role != "combined" and not self.sidecar.socket
                and not (self.sidecar.role == "frontend"
                         and fl.get("enabled") and fl.get("sockets"))):
            # A frontend may address a fleet of sidecars in place of one.
            raise ValueError(f"sidecar.role {self.sidecar.role!r} requires "
                             f"sidecar.socket (or an enabled fleet.sockets "
                             f"list)")
        _check("wire", wi, {},
               served=("coalesce-max-frames", "coalesce-max-bytes",
                       "ring-bytes", "ring-min-body-bytes", "streaming",
                       "chunk-max-bytes"))
        w = WireConfig()
        self.wire = WireConfig(
            coalesce_max_frames=int(wi.get("coalesce-max-frames",
                                           w.coalesce_max_frames)),
            coalesce_max_bytes=int(wi.get("coalesce-max-bytes",
                                          w.coalesce_max_bytes)),
            ring_bytes=int(wi.get("ring-bytes", w.ring_bytes)),
            ring_min_body_bytes=int(wi.get("ring-min-body-bytes",
                                           w.ring_min_body_bytes)),
            streaming=bool(wi.get("streaming", w.streaming)),
            chunk_max_bytes=int(wi.get("chunk-max-bytes",
                                       w.chunk_max_bytes)))
        if self.wire.coalesce_max_frames < 1:
            raise ValueError("wire.coalesce-max-frames must be >= 1")
        if self.wire.coalesce_max_bytes < 4096:
            raise ValueError("wire.coalesce-max-bytes must be >= 4096")
        if self.wire.ring_bytes != 0 and self.wire.ring_bytes < 1024 * 1024:
            raise ValueError("wire.ring-bytes must be 0 (disabled) or "
                             ">= 1 MiB")
        if self.wire.ring_min_body_bytes < 1:
            raise ValueError("wire.ring-min-body-bytes must be >= 1")
        if self.wire.chunk_max_bytes < 4096:
            raise ValueError("wire.chunk-max-bytes must be >= 4096")

    def _fleet(self, fl: dict, hk: dict) -> None:
        _check("fleet", fl, {},
               served=("enabled", "members", "sockets", "lane-width",
                       "steal-min-backlog", "hash-replicas", "failover",
                       "down-cooldown-s"))
        d = FleetConfig()
        self.fleet = FleetConfig(
            enabled=bool(fl.get("enabled", d.enabled)),
            members=int(fl.get("members", d.members)),
            sockets=tuple(str(a) for a in fl.get("sockets", ()) or ()),
            lane_width=int(fl.get("lane-width", d.lane_width)),
            steal_min_backlog=int(fl.get("steal-min-backlog",
                                         d.steal_min_backlog)),
            hash_replicas=int(fl.get("hash-replicas", d.hash_replicas)),
            failover=bool(fl.get("failover", d.failover)),
            down_cooldown_s=float(fl.get("down-cooldown-s",
                                         d.down_cooldown_s)))
        f = self.fleet
        if f.enabled and not f.sockets and f.members < 2:
            raise ValueError("fleet.enabled requires members >= 2 "
                             "or a fleet.sockets list")
        if f.members < 1:
            raise ValueError("fleet.members must be >= 1")
        if f.lane_width < 1:
            raise ValueError("fleet.lane-width must be >= 1")
        if f.steal_min_backlog < 0:
            raise ValueError("fleet.steal-min-backlog must be >= 0 "
                             "(0 disables stealing)")
        if f.hash_replicas < 1:
            raise ValueError("fleet.hash-replicas must be >= 1")
        if f.down_cooldown_s < 0:
            raise ValueError("fleet.down-cooldown-s must be >= 0")
        _check("hotkey", hk, {},
               served=("enabled", "threshold", "decay-s", "max-replicas",
                       "top-k", "demote-fraction", "scale-factor"))
        d = HotkeyConfig()
        self.hotkey = h = HotkeyConfig(
            enabled=bool(hk.get("enabled", d.enabled)),
            threshold=float(hk.get("threshold", d.threshold)),
            decay_s=float(hk.get("decay-s", d.decay_s)),
            max_replicas=int(hk.get("max-replicas", d.max_replicas)),
            top_k=int(hk.get("top-k", d.top_k)),
            demote_fraction=float(hk.get("demote-fraction",
                                         d.demote_fraction)),
            scale_factor=float(hk.get("scale-factor", d.scale_factor)))
        if h.threshold <= 0:
            raise ValueError("hotkey.threshold must be > 0")
        if h.decay_s <= 0:
            raise ValueError("hotkey.decay-s must be > 0")
        if h.max_replicas < 2:
            raise ValueError("hotkey.max-replicas must be >= 2 "
                             "(R=1 is the unreplicated ring)")
        if h.top_k < 1:
            raise ValueError("hotkey.top-k must be >= 1")
        if not 0.0 < h.demote_fraction < 1.0:
            raise ValueError("hotkey.demote-fraction must be in "
                             "(0, 1) — the promotion/demotion "
                             "hysteresis band")
        if h.scale_factor < 0:
            raise ValueError("hotkey.scale-factor must be >= 0 "
                             "(0 disables the autoscaler signal)")

    def _drain(self, dr: dict) -> None:
        _check("drain", dr, {},
               served=("prestage", "prestage-max-planes",
                       "settle-timeout-s", "fail-readyz"))
        d = DrainConfig()
        self.drain = DrainConfig(
            prestage=bool(dr.get("prestage", d.prestage)),
            prestage_max_planes=int(dr.get("prestage-max-planes",
                                           d.prestage_max_planes)),
            settle_timeout_s=float(dr.get("settle-timeout-s",
                                          d.settle_timeout_s)),
            fail_readyz=bool(dr.get("fail-readyz", d.fail_readyz)))
        if self.drain.prestage_max_planes < 1:
            raise ValueError("drain.prestage-max-planes must be >= 1")
        if self.drain.settle_timeout_s <= 0:
            raise ValueError("drain.settle-timeout-s must be > 0")

    def _watchdog(self, wd: dict) -> None:
        _check("watchdog", wd, _UNPORTED_KEYS["watchdog"],
               served=("enabled", "interval-s", "stall-factor",
                       "stall-min-s", "escalate-after", "wire-hang-s"))
        d = WatchdogConfig()
        self.watchdog = WatchdogConfig(
            enabled=bool(wd.get("enabled", d.enabled)),
            interval_s=float(wd.get("interval-s", d.interval_s)),
            stall_factor=float(wd.get("stall-factor", d.stall_factor)),
            stall_min_s=float(wd.get("stall-min-s", d.stall_min_s)),
            escalate_after=int(wd.get("escalate-after",
                                      d.escalate_after)),
            wire_hang_s=float(wd.get("wire-hang-s", d.wire_hang_s)))
        if self.watchdog.interval_s <= 0:
            raise ValueError("watchdog.interval-s must be > 0")
        if self.watchdog.stall_factor < 1.0:
            raise ValueError("watchdog.stall-factor must be >= 1")
        if self.watchdog.stall_min_s <= 0:
            raise ValueError("watchdog.stall-min-s must be > 0")
        if self.watchdog.escalate_after < 1:
            raise ValueError("watchdog.escalate-after must be >= 1")
        if self.watchdog.wire_hang_s < 0:
            raise ValueError("watchdog.wire-hang-s must be >= 0 "
                             "(0 disables the hung-wire scan)")

    def _fault_tolerance(self, ft: dict) -> None:
        _check("fault-tolerance", ft, _UNPORTED_KEYS["fault-tolerance"],
               served=("request-deadline-ms", "breaker-failure-threshold",
                       "breaker-reset-s", "retry-max-attempts",
                       "retry-base-backoff-ms", "retry-max-backoff-ms",
                       "admission-max-queue", "shed-retry-after-s",
                       "degraded-mode", "supervise",
                       "supervisor-max-backoff-s"))
        d = FaultToleranceConfig()
        self.fault_tolerance = FaultToleranceConfig(
            request_deadline_ms=float(ft.get("request-deadline-ms",
                                             d.request_deadline_ms)),
            breaker_failure_threshold=int(ft.get(
                "breaker-failure-threshold", d.breaker_failure_threshold)),
            breaker_reset_s=float(ft.get("breaker-reset-s",
                                         d.breaker_reset_s)),
            retry_max_attempts=int(ft.get("retry-max-attempts",
                                          d.retry_max_attempts)),
            retry_base_backoff_ms=float(ft.get("retry-base-backoff-ms",
                                               d.retry_base_backoff_ms)),
            retry_max_backoff_ms=float(ft.get("retry-max-backoff-ms",
                                              d.retry_max_backoff_ms)),
            admission_max_queue=int(ft.get("admission-max-queue",
                                           d.admission_max_queue)),
            shed_retry_after_s=float(ft.get("shed-retry-after-s",
                                            d.shed_retry_after_s)),
            degraded_mode=bool(ft.get("degraded-mode", d.degraded_mode)),
            supervise=bool(ft.get("supervise", d.supervise)),
            supervisor_max_backoff_s=float(ft.get(
                "supervisor-max-backoff-s", d.supervisor_max_backoff_s)))
        if self.fault_tolerance.request_deadline_ms < 0:
            raise ValueError("fault-tolerance.request-deadline-ms must "
                             "be >= 0")
        if self.fault_tolerance.breaker_failure_threshold < 1:
            raise ValueError("fault-tolerance.breaker-failure-threshold "
                             "must be >= 1")
        if self.fault_tolerance.retry_max_attempts < 1:
            raise ValueError("fault-tolerance.retry-max-attempts must "
                             "be >= 1")
        if self.fault_tolerance.admission_max_queue < 0:
            raise ValueError("fault-tolerance.admission-max-queue must "
                             "be >= 0 (0 disables admission control)")

    def _fault_injection(self, fi: dict) -> None:
        _check("fault-injection", fi, _UNPORTED_KEYS["fault-injection"],
               served=("seed", "wire-drop-rate", "wire-truncate-rate",
                       "wire-delay-rate", "wire-delay-ms",
                       "device-error-rate", "freeze-rate", "freeze-ms",
                       "freeze-max", "die-after-requests"))
        d = FaultInjectionConfig()
        self.fault_injection = FaultInjectionConfig(
            seed=int(fi["seed"]) if fi.get("seed") is not None else None,
            wire_drop_rate=float(fi.get("wire-drop-rate",
                                        d.wire_drop_rate)),
            wire_truncate_rate=float(fi.get("wire-truncate-rate",
                                            d.wire_truncate_rate)),
            wire_delay_rate=float(fi.get("wire-delay-rate",
                                         d.wire_delay_rate)),
            wire_delay_ms=float(fi.get("wire-delay-ms", d.wire_delay_ms)),
            device_error_rate=float(fi.get("device-error-rate",
                                           d.device_error_rate)),
            freeze_rate=float(fi.get("freeze-rate", d.freeze_rate)),
            freeze_ms=float(fi.get("freeze-ms", d.freeze_ms)),
            freeze_max=int(fi.get("freeze-max", d.freeze_max)),
            die_after_requests=int(fi.get("die-after-requests",
                                          d.die_after_requests))
        ).validate()

    def _workloads(self, wl: dict) -> None:
        _check("workloads", wl, {},
               served=("device-masks", "overlay-enabled",
                       "animation-enabled", "animation-max-frames"))
        d = WorkloadsConfig()
        self.workloads = WorkloadsConfig(
            device_masks=bool(wl.get("device-masks", d.device_masks)),
            overlay_enabled=bool(wl.get("overlay-enabled",
                                        d.overlay_enabled)),
            animation_enabled=bool(wl.get("animation-enabled",
                                          d.animation_enabled)),
            animation_max_frames=int(wl.get("animation-max-frames",
                                            d.animation_max_frames)))
        if self.workloads.animation_max_frames < 1:
            raise ValueError("workloads.animation-max-frames must be >= 1")

    def _caches(self, raw: dict) -> None:
        redis = _block(raw, "redis-cache")
        _check("redis-cache", redis, {}, served=("uri",))
        flags = {}
        for name in ("image-region-cache", "pixels-metadata-cache",
                     "shape-mask-cache"):
            block = _block(raw, name)
            _check(name, block, {}, served=("enabled",))
            flags[name] = bool(block.get("enabled", False))
        self.caches = CacheConfig(
            redis_uri=redis.get("uri"),
            image_region=flags["image-region-cache"],
            pixels_metadata=flags["pixels-metadata-cache"],
            shape_mask=flags["shape-mask-cache"])

    def _renderer(self, rd: dict) -> None:
        _check("renderer", rd, _UNPORTED_KEYS["renderer"],
               served=("cpu-fallback-max-px", "jpeg-engine", "prewarm"))
        d = RendererConfig()
        self.renderer = RendererConfig(
            cpu_fallback_max_px=int(rd.get("cpu-fallback-max-px",
                                           d.cpu_fallback_max_px)),
            jpeg_engine=str(rd.get("jpeg-engine", d.jpeg_engine)),
            prewarm=tuple(str(s) for s in rd.get("prewarm", ()) or ()))
        from .prewarm import parse_spec
        for spec in self.renderer.prewarm:
            parse_spec(spec)        # a malformed spec fails the load
        engine = self.renderer.jpeg_engine
        if engine not in ("sparse", "huffman", "bitpack", "auto"):
            raise ValueError(
                f"renderer.jpeg-engine must be 'sparse', 'huffman', "
                f"'bitpack' or 'auto', got {engine!r}")

    def _telemetry(self, tel: dict) -> None:
        _check("telemetry", tel, _UNPORTED_KEYS["telemetry"],
               served=("slow-request-ms", "slow-request-dir", "access-log",
                       "ready-max-queue-depth", "provenance-header",
                       "flight-recorder-events", "flight-recorder-dir",
                       "profile-dir", "profile-max-ms"))
        d = TelemetryConfig()
        self.telemetry = TelemetryConfig(
            slow_request_ms=float(tel.get("slow-request-ms",
                                          d.slow_request_ms)),
            slow_request_dir=str(tel.get("slow-request-dir",
                                         d.slow_request_dir)),
            access_log=bool(tel.get("access-log", d.access_log)),
            ready_max_queue_depth=int(tel.get("ready-max-queue-depth",
                                              d.ready_max_queue_depth)),
            provenance_header=bool(tel.get("provenance-header",
                                           d.provenance_header)),
            flight_recorder_events=int(tel.get(
                "flight-recorder-events", d.flight_recorder_events)),
            flight_recorder_dir=str(tel.get("flight-recorder-dir",
                                            d.flight_recorder_dir)),
            profile_dir=str(tel.get("profile-dir", d.profile_dir)),
            profile_max_ms=float(tel.get("profile-max-ms",
                                         d.profile_max_ms)))
        if self.telemetry.slow_request_ms < 0:
            raise ValueError("telemetry.slow-request-ms must be >= 0")
        if self.telemetry.ready_max_queue_depth < 1:
            raise ValueError("telemetry.ready-max-queue-depth must be "
                             ">= 1")
        if self.telemetry.flight_recorder_events < 16:
            raise ValueError("telemetry.flight-recorder-events must be "
                             ">= 16 (the black box needs some tape)")
        if self.telemetry.profile_max_ms <= 0:
            raise ValueError("telemetry.profile-max-ms must be > 0")

    def _slo(self, slo: dict) -> None:
        d = SloConfig()
        _check("slo", slo, {}, served=tuple(
            f.replace("_", "-") for f in vars(d)))
        self.slo = SloConfig(
            availability_target=float(slo.get("availability-target",
                                              d.availability_target)),
            latency_ms=float(slo.get("latency-ms", d.latency_ms)),
            latency_target=float(slo.get("latency-target",
                                         d.latency_target)),
            fast_window_s=float(slo.get("fast-window-s", d.fast_window_s)),
            slow_window_s=float(slo.get("slow-window-s", d.slow_window_s)),
            breach_burn_rate=float(slo.get("breach-burn-rate",
                                           d.breach_burn_rate)))
        for name in ("availability_target", "latency_target"):
            v = getattr(self.slo, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(
                    f"slo.{name.replace('_', '-')} must be in [0, 1) "
                    f"(a target of 1.0 leaves zero error budget), got {v}")
        if self.slo.latency_ms < 0:
            raise ValueError("slo.latency-ms must be >= 0")
        if self.slo.fast_window_s <= 0 or self.slo.slow_window_s <= 0:
            raise ValueError("slo windows must be > 0 seconds")
        if self.slo.breach_burn_rate <= 0:
            raise ValueError("slo.breach-burn-rate must be > 0")

    def _decisions(self, dec: dict) -> None:
        d = DecisionsConfig()
        _check("decisions", dec, {}, served=(
            "ring-size", "spool-dir", "outcome-horizon-ticks"))
        self.decisions = DecisionsConfig(
            ring_size=int(dec.get("ring-size", d.ring_size)),
            spool_dir=str(dec.get("spool-dir", d.spool_dir) or ""),
            outcome_horizon_ticks=int(dec.get("outcome-horizon-ticks",
                                              d.outcome_horizon_ticks)))
        if self.decisions.ring_size < 16:
            raise ValueError("decisions.ring-size must be >= 16")
        if self.decisions.outcome_horizon_ticks < 1:
            raise ValueError("decisions.outcome-horizon-ticks must be >= 1")

    def _sentinel(self, sen: dict) -> None:
        d = SentinelConfig()
        _check("sentinel", sen, {}, served=tuple(
            f.replace("_", "-") for f in vars(d)))
        self.sentinel = SentinelConfig(
            enabled=bool(sen.get("enabled", d.enabled)),
            tick_interval_s=float(sen.get("tick-interval-s",
                                          d.tick_interval_s)),
            confirm_ticks=int(sen.get("confirm-ticks", d.confirm_ticks)),
            recover_ticks=int(sen.get("recover-ticks", d.recover_ticks)),
            min_samples=int(sen.get("min-samples", d.min_samples)),
            warmup_ticks=int(sen.get("warmup-ticks", d.warmup_ticks)),
            drift_ratio=float(sen.get("drift-ratio", d.drift_ratio)),
            baseline_alpha=float(sen.get("baseline-alpha",
                                         d.baseline_alpha)),
            throughput_floor_ratio=float(sen.get(
                "throughput-floor-ratio", d.throughput_floor_ratio)),
            bundle_dir=str(sen.get("bundle-dir", d.bundle_dir) or ""),
            max_bundles=int(sen.get("max-bundles", d.max_bundles)),
            profile_ms=int(sen.get("profile-ms", d.profile_ms)),
            records_dir=str(sen.get("records-dir", d.records_dir) or ""))
        c = self.sentinel
        if c.tick_interval_s <= 0:
            raise ValueError("sentinel.tick-interval-s must be > 0")
        if c.confirm_ticks < 1:
            raise ValueError("sentinel.confirm-ticks must be >= 1 (a "
                             "zero-confirmation sentinel would page on one "
                             "slow window)")
        if c.recover_ticks < 1:
            raise ValueError("sentinel.recover-ticks must be >= 1")
        if c.min_samples < 1:
            raise ValueError("sentinel.min-samples must be >= 1")
        if c.warmup_ticks < 1:
            raise ValueError("sentinel.warmup-ticks must be >= 1")
        if c.drift_ratio <= 1.0:
            raise ValueError("sentinel.drift-ratio must be > 1.0 (a ratio "
                             "at or under 1.0 calls steady state a drift)")
        if not 0.0 < c.baseline_alpha <= 1.0:
            raise ValueError("sentinel.baseline-alpha must be in (0, 1]")
        if not 0.0 < c.throughput_floor_ratio <= 1.0:
            raise ValueError(
                "sentinel.throughput-floor-ratio must be in (0, 1]")
        if c.max_bundles < 1:
            raise ValueError("sentinel.max-bundles must be >= 1")
        if c.profile_ms < 0:
            raise ValueError("sentinel.profile-ms must be >= 0")

    def _pressure(self, pr: dict) -> None:
        d = PressureConfig()
        _check("pressure", pr, {}, served=tuple(
            f.replace("_", "-") for f in vars(d)))
        fields = {}
        for f, default in vars(d).items():
            key = f.replace("_", "-")
            if f == "ladder":
                fields[f] = tuple(str(v) for v in pr.get(key, ()) or ()) \
                    or default
            elif key in pr:
                fields[f] = type(default)(pr[key])
        self.pressure = c = PressureConfig(**fields)
        if c.interval_s <= 0:
            raise ValueError("pressure.interval-s must be > 0")
        from .pressure import KNOWN_STEPS
        seen = set()
        for step in c.ladder:
            if step not in KNOWN_STEPS:
                raise ValueError(f"pressure.ladder step {step!r} is not "
                                 f"one of {sorted(KNOWN_STEPS)}")
            if step in seen:
                raise ValueError(f"pressure.ladder repeats step {step!r}")
            seen.add(step)
        if ("shed_bulk" in seen and "tighten_admission" in seen
                and c.ladder.index("shed_bulk")
                > c.ladder.index("tighten_admission")):
            raise ValueError(
                "pressure.ladder must engage shed_bulk before "
                "tighten_admission (bulk work sheds first; interactive "
                "availability goes last)")
        for high_name, low_name in (
                ("hbm_high", "hbm_low"),
                ("host_rss_high_mb", "host_rss_low_mb"),
                ("disk_high", "disk_low"), ("queue_high", "queue_low"),
                ("loop_lag_high_ms", "loop_lag_low_ms")):
            high, low = getattr(c, high_name), getattr(c, low_name)
            if high > 0 and not 0 <= low < high:
                raise ValueError(
                    f"pressure.{low_name.replace('_', '-')} must be in "
                    f"[0, {high_name.replace('_', '-')}) (the hysteresis "
                    f"band needs low < high)")
        if c.critical_factor < 1.0:
            raise ValueError("pressure.critical-factor must be >= 1")
        if c.step_hold_ticks < 1 or c.release_hold_ticks < 1:
            raise ValueError("pressure step/release hold ticks must be "
                             ">= 1")
        if not 1 <= c.quality_cap <= 100:
            raise ValueError("pressure.quality-cap must be in [1, 100]")
        if not 0.0 < c.evict_to_frac < 1.0:
            raise ValueError("pressure.evict-to-frac must be in (0, 1)")
        if c.lane_cap < 1:
            raise ValueError("pressure.lane-cap must be >= 1")
        if not 0.0 < c.admission_scale <= 1.0:
            raise ValueError("pressure.admission-scale must be in (0, 1]")
        if not (0.0 < c.prefetch_budget_critical
                <= c.prefetch_budget_elevated <= 1.0):
            raise ValueError(
                "pressure prefetch budgets must satisfy 0 < "
                "prefetch-budget-critical <= prefetch-budget-elevated "
                "<= 1")

    def _persistence(self, per: dict) -> None:
        _check("persistence", per, {},
               served=("enabled", "dir", "disk-cache-max-bytes",
                       "executables", "snapshot-interval-s",
                       "snapshot-top-k", "max-plane-entries", "rehydrate",
                       "rehydrate-concurrency"))
        d = PersistenceConfig()
        self.persistence = PersistenceConfig(
            enabled=bool(per.get("enabled", d.enabled)),
            dir=str(per.get("dir", d.dir)),
            disk_cache_max_bytes=int(per.get("disk-cache-max-bytes",
                                             d.disk_cache_max_bytes)),
            executables=bool(per.get("executables", d.executables)),
            snapshot_interval_s=float(per.get("snapshot-interval-s",
                                              d.snapshot_interval_s)),
            snapshot_top_k=int(per.get("snapshot-top-k", d.snapshot_top_k)),
            max_plane_entries=int(per.get("max-plane-entries",
                                          d.max_plane_entries)),
            rehydrate=bool(per.get("rehydrate", d.rehydrate)),
            rehydrate_concurrency=int(per.get("rehydrate-concurrency",
                                              d.rehydrate_concurrency)))
        p = self.persistence
        if p.disk_cache_max_bytes < 1024 * 1024:
            raise ValueError("persistence.disk-cache-max-bytes must be "
                             ">= 1 MiB")
        if p.snapshot_interval_s < 0:
            raise ValueError("persistence.snapshot-interval-s must be >= 0 "
                             "(0 disables the timer)")
        if p.rehydrate_concurrency < 1:
            raise ValueError("persistence.rehydrate-concurrency must be "
                             ">= 1")
        if p.snapshot_top_k < 1:
            raise ValueError("persistence.snapshot-top-k must be >= 1")

    def _pyramid(self, py: dict) -> None:
        _check("pyramid", py, _UNPORTED_KEYS["pyramid"],
               served=("enabled", "chunk", "min-level-size", "compressor",
                       "defer-poll-s"))
        d = PyramidConfig()
        self.pyramid = PyramidConfig(
            enabled=bool(py.get("enabled", d.enabled)),
            chunk=int(py.get("chunk", d.chunk)),
            min_level_size=int(py.get("min-level-size", d.min_level_size)),
            compressor=str(py.get("compressor", d.compressor)),
            defer_poll_s=float(py.get("defer-poll-s", d.defer_poll_s)))
        if self.pyramid.chunk < 16:
            raise ValueError("pyramid.chunk must be >= 16")
        if self.pyramid.min_level_size < 1:
            raise ValueError("pyramid.min-level-size must be >= 1")
        if self.pyramid.compressor not in ("zlib", "gzip", "none"):
            raise ValueError("pyramid.compressor must be zlib, gzip, "
                             "or none")
        if self.pyramid.defer_poll_s <= 0:
            raise ValueError("pyramid.defer-poll-s must be > 0")

    def _loadmodel(self, lm: dict) -> None:
        """The JAX loader's ``loadmodel`` block and its checks, in its
        order (the generator checks again when it is built)."""
        d = LoadModelConfig()
        _check("loadmodel", lm, {}, served=tuple(
            f.replace("_", "-") for f in d.__dataclass_fields__))
        self.loadmodel = m = LoadModelConfig(
            seed=int(lm.get("seed", d.seed)),
            viewers=int(lm.get("viewers", d.viewers)),
            think_time_median_ms=float(lm.get("think-time-median-ms",
                                              d.think_time_median_ms)),
            think_time_sigma=float(lm.get("think-time-sigma",
                                          d.think_time_sigma)),
            session_length_median=float(lm.get("session-length-median",
                                               d.session_length_median)),
            session_length_sigma=float(lm.get("session-length-sigma",
                                              d.session_length_sigma)),
            diurnal_amplitude=float(lm.get("diurnal-amplitude",
                                           d.diurnal_amplitude)),
            bulk_fraction=float(lm.get("bulk-fraction", d.bulk_fraction)),
            mask_fraction=float(lm.get("mask-fraction", d.mask_fraction)),
            pyramid_fraction=float(lm.get("pyramid-fraction",
                                          d.pyramid_fraction)),
            animation_fraction=float(lm.get("animation-fraction",
                                            d.animation_fraction)),
            zoom_fraction=float(lm.get("zoom-fraction", d.zoom_fraction)),
            skew=float(lm.get("skew", d.skew)),
            image_population=int(lm.get("image-population",
                                        d.image_population)))
        if m.viewers < 1:
            raise ValueError("loadmodel.viewers must be >= 1")
        if m.think_time_median_ms <= 0 or m.session_length_median <= 0:
            raise ValueError("loadmodel medians must be > 0")
        if m.think_time_sigma < 0 or m.session_length_sigma < 0:
            raise ValueError("loadmodel sigmas must be >= 0")
        if not 0.0 <= m.diurnal_amplitude < 1.0:
            raise ValueError("loadmodel.diurnal-amplitude must be in "
                             "[0, 1)")
        for name in ("bulk_fraction", "mask_fraction", "pyramid_fraction",
                     "animation_fraction", "zoom_fraction"):
            if not 0.0 <= getattr(m, name) <= 1.0:
                raise ValueError(f"loadmodel.{name.replace('_', '-')} "
                                 f"must be in [0, 1]")
        if (m.bulk_fraction + m.mask_fraction + m.pyramid_fraction
                + m.animation_fraction) > 1.0:
            raise ValueError("loadmodel bulk-fraction + mask-fraction "
                             "+ pyramid-fraction + animation-fraction "
                             "must sum to <= 1")
        if m.skew < 0:
            raise ValueError("loadmodel.skew must be >= 0 "
                             "(0 = every session on one image)")
        if m.image_population < 1:
            raise ValueError("loadmodel.image-population must be >= 1")

    def _autoscaler(self, au: dict) -> None:
        """The JAX loader's ``autoscaler`` block and its checks, the
        cross-section ones last, in its order.  The provisioned fleet is
        the federation's manifest members, else ``fleet.sockets`` or
        ``fleet.members`` (JAX ``:1505-1512``)."""
        d = AutoscalerConfig()
        _check("autoscaler", au, {}, served=tuple(
            f.replace("_", "-") for f in d.__dataclass_fields__))
        self.autoscaler = a = AutoscalerConfig(
            enabled=bool(au.get("enabled", d.enabled)),
            interval_s=float(au.get("interval-s", d.interval_s)),
            floor=int(au.get("floor", d.floor)),
            ceiling=int(au.get("ceiling", d.ceiling)),
            queue_high_per_lane=float(au.get("queue-high-per-lane",
                                             d.queue_high_per_lane)),
            queue_low_per_lane=float(au.get("queue-low-per-lane",
                                            d.queue_low_per_lane)),
            hold_ticks=int(au.get("hold-ticks", d.hold_ticks)),
            cooldown_s=float(au.get("cooldown-s", d.cooldown_s)),
            lane_capacity_tps=float(au.get("lane-capacity-tps",
                                           d.lane_capacity_tps)),
            session_tps=float(au.get("session-tps", d.session_tps)),
            diurnal_period_s=float(au.get("diurnal-period-s",
                                          d.diurnal_period_s)),
            diurnal_horizon_s=float(au.get("diurnal-horizon-s",
                                           d.diurnal_horizon_s)),
            unit_config=str(au.get("unit-config", d.unit_config) or ""))
        if a.interval_s <= 0:
            raise ValueError("autoscaler.interval-s must be > 0")
        if a.floor < 1:
            raise ValueError("autoscaler.floor must be >= 1 (the "
                             "fleet must always keep a servable "
                             "member)")
        if a.ceiling != 0 and a.ceiling < a.floor:
            raise ValueError("autoscaler.ceiling must be 0 (all "
                             "members) or >= autoscaler.floor")
        if not 0 <= a.queue_low_per_lane < a.queue_high_per_lane:
            raise ValueError(
                "autoscaler.queue-low-per-lane must be in [0, "
                "queue-high-per-lane) — the hysteresis band needs "
                "low < high")
        if a.hold_ticks < 1:
            raise ValueError("autoscaler.hold-ticks must be >= 1")
        if a.cooldown_s < 0:
            raise ValueError("autoscaler.cooldown-s must be >= 0")
        if a.lane_capacity_tps < 0:
            raise ValueError("autoscaler.lane-capacity-tps must be "
                             ">= 0 (0 disables the demand signal)")
        if a.session_tps <= 0:
            raise ValueError("autoscaler.session-tps must be > 0")
        if a.diurnal_period_s < 0:
            raise ValueError("autoscaler.diurnal-period-s must be "
                             ">= 0 (0 disables diurnal prediction)")
        if a.diurnal_horizon_s < 0:
            raise ValueError("autoscaler.diurnal-horizon-s must be "
                             ">= 0")
        if a.unit_config and not self.fleet.sockets:
            raise ValueError(
                "autoscaler.unit-config manages sidecar unit "
                "processes — it requires the fleet.sockets topology")
        if a.enabled and not (self.fleet.enabled
                              or self.federation.enabled):
            raise ValueError(
                "autoscaler.enabled requires a fleet topology "
                "(fleet.enabled or federation.enabled) — there is "
                "nothing to scale without members")
        if a.enabled:
            provisioned = (len(self.federation.members)
                           if self.federation.enabled
                           else (len(self.fleet.sockets)
                                 or self.fleet.members))
            if a.floor > provisioned:
                raise ValueError(
                    f"autoscaler.floor ({a.floor}) exceeds the "
                    f"provisioned fleet size ({provisioned} members)")
