"""Resource-pressure governor and brownout ladder: degrade by choice
before degrading by accident.

Counterpart of the JAX package's ``server/pressure.py`` (off by default,
``pressure.enabled``).  A periodic sampler (:meth:`PressureGovernor.tick`,
driven by an asyncio task every ``pressure.interval-s``) reads a fixed set
of signals and folds them into one level (``ok`` / ``elevated`` /
``critical``) with per-signal hysteresis (enter at ``high``, leave only
below ``low``):

* ``hbm``: the device raw cache's own byte count over its budget
  (``DeviceRawCache.size_bytes / max_bytes``).  Not
  ``torch.cuda.memory_allocated``, and no ``torch.cuda.empty_cache()`` a
  tick: that synchronizes the device, and PyTorch's caching allocator
  keeps freed blocks for reuse anyway, so the cache's count is the
  signal that moves when it evicts;
* ``host_rss_mb``: ``VmRSS`` from ``/proc/self/status`` (the pinned
  staging buffers count once touched); its watermarks default from the
  cgroup memory limit (:func:`apply_cgroup_rss_defaults`);
* ``disk``: the disk byte tier's fill (``services.diskcache``);
* ``queue``: the batcher's queued tiles;
* ``loop_lag_ms``: the governor's own event-loop lag.

The **brownout ladder** is an ordered list of :data:`KNOWN_STEPS`: under
``elevated`` the next step engages every ``step-hold-ticks`` ticks, under
``critical`` one a tick, and after ``release-hold-ticks`` ``ok`` ticks the
last engaged step releases, so the engaged set is always a prefix of the
ladder: steps engage in order and release in exact reverse.  The config
loader holds ``shed_bulk`` before ``tighten_admission``.

Consumers read the governor through :func:`install` / :func:`active` (one
``is None`` test when it is off):

* ``services.prefetch.TilePrefetcher`` (``paused``, and the budget scale
  :meth:`PressureGovernor.prefetch_budget`) and ``services.warmstate
  .WarmStateManager.paused``;
* ``DeviceRawCache.evict_to_fraction`` and the disk tier's, re-applied
  every tick while ``evict_caches`` is engaged (the freed blocks go back
  to PyTorch's caching allocator, not to the driver);
* ``server.batcher.BatchingRenderer.set_lane_cap`` (``cap_lanes``: the
  device lanes above the cap take no new group; groups already on their
  streams finish);
* ``server.handler``: ``drop_quality`` (:func:`pressure_quality`) and
  ``shed_bulk`` (:func:`shed_bulk_under_pressure`, 503 + Retry-After);
  ``server.jobs`` parks the pyramid job under ``shed_bulk``;
* ``server.admission.AdmissionController`` (``tighten_admission``
  scales the queue bound);
* ``utils.provenance`` (the record's ``ladder`` and ``quality_capped``).

Every level transition and every step is a flight event and an
``imageregion_pressure_*`` series.  With a fleet (``parallel.fleet``) the
``queue`` source reads the router's depth (queued and executing across
the members), and ``evict_caches`` demotes every promoted hot route's
replica set (``FleetRouter.shed_replicas``) before the LRU pass, as in
JAX: a replica is a duplicate whose owner keeps its copy.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import telemetry

log = logging.getLogger("omero_ms_image_region_tpu_torch.pressure")

# Ladder-step vocabulary; config validation rejects anything else.
KNOWN_STEPS = (
    "pause_prefetch",     # stop pan-ahead staging (frees PCIe + memory)
    "pause_snapshots",    # stop warm-state manifest writes (disk/CPU)
    "evict_caches",       # walk the raw cache + disk tier to low water
    "cap_lanes",          # bound concurrent group renders
    "drop_quality",       # lower interactive-tile JPEG quality
    "shed_bulk",          # 503 full-plane / z-projection work
    "tighten_admission",  # scale the admission queue bound down
)

LEVEL_OK, LEVEL_ELEVATED, LEVEL_CRITICAL = 0, 1, 2
LEVEL_NAMES = ("ok", "elevated", "critical")


def read_rss_mb() -> Optional[float]:
    """Host RSS in MB from ``/proc/self/status`` (no psutil in the
    image); None where /proc is unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return None


# cgroup v2 exposes the memory limit at memory.max ("max" = unlimited);
# v1 at memory/memory.limit_in_bytes (an absurdly large number =
# unlimited — kernels report PAGE_COUNTER_MAX there).
_CGROUP_V2_LIMIT = "/sys/fs/cgroup/memory.max"
_CGROUP_V1_LIMIT = "/sys/fs/cgroup/memory/memory.limit_in_bytes"
_CGROUP_UNLIMITED_BYTES = 1 << 60


def read_cgroup_memory_limit_mb(
        v2_path: str = _CGROUP_V2_LIMIT,
        v1_path: str = _CGROUP_V1_LIMIT) -> Optional[float]:
    """The container's memory limit in MB from the cgroup filesystem
    (v2 first, v1 fallback); None when unlimited or not in a cgroup."""
    for path in (v2_path, v1_path):
        try:
            with open(path) as f:
                raw = f.read().strip()
        except OSError:
            continue
        if raw == "max":
            return None
        try:
            limit = int(raw)
        except ValueError:
            continue
        if limit <= 0 or limit >= _CGROUP_UNLIMITED_BYTES:
            return None
        return limit / (1024.0 * 1024.0)
    return None


# Auto-wired host-RSS watermarks as fractions of the cgroup limit:
# enter elevated at 80% (bloat caught before the OOM killer),
# release below 65%.
_RSS_HIGH_FRAC = 0.80
_RSS_LOW_FRAC = 0.65


def apply_cgroup_rss_defaults(config,
                              limit_mb: Optional[float] = None):
    """Default the host-RSS watermarks from the cgroup memory limit
    when the operator left them unset (``host-rss-high-mb: 0``).  The
    explicit knob always wins; with no cgroup limit the signal simply
    stays disabled, as before.  Returns the config for chaining."""
    if config.host_rss_high_mb > 0:
        return config            # explicit override: never touched
    limit = limit_mb if limit_mb is not None \
        else read_cgroup_memory_limit_mb()
    if limit is None or limit <= 0:
        return config
    config.host_rss_high_mb = round(limit * _RSS_HIGH_FRAC, 1)
    config.host_rss_low_mb = round(limit * _RSS_LOW_FRAC, 1)
    log.info("pressure: host-RSS watermarks defaulted from the cgroup "
             "limit (%.0f MB): high %.0f / low %.0f",
             limit, config.host_rss_high_mb, config.host_rss_low_mb)
    return config


@dataclass
class StepActuator:
    """What a ladder step DOES.  ``engage``/``release`` fire on the
    transition; ``while_engaged`` re-fires every tick the step stays
    engaged (eviction steps need re-applying — traffic refills what
    one pass freed).  All three are guarded: a failing actuator logs
    and never stalls the governor."""

    engage: Optional[Callable[[], None]] = None
    release: Optional[Callable[[], None]] = None
    while_engaged: Optional[Callable[[], None]] = None


class _SignalState:
    __slots__ = ("engaged",)

    def __init__(self):
        self.engaged = False


class PressureGovernor:
    """Tick-driven pressure sampler + brownout ladder walker.

    ``sources`` maps signal name -> zero-arg callable returning the
    current reading (None = signal unavailable this tick); thresholds
    come from the config block.  The governor itself is synchronous —
    :meth:`tick` is called by the asyncio runner in ``server.app`` and
    directly by tests (deterministic trajectories, no clock).
    """

    def __init__(self, config, actuators: Dict[str, StepActuator],
                 sources: Dict[str, Callable[[], Optional[float]]]):
        self.config = config
        self.ladder: Tuple[str, ...] = tuple(config.ladder)
        self.actuators = actuators
        self.sources = sources
        self.level = LEVEL_OK
        self.engaged = 0            # ladder prefix length
        self._hot_streak = 0
        self._ok_streak = 0
        self._signal_states: Dict[str, _SignalState] = {}
        # Set by the async runner (actual vs expected tick interval);
        # read back as the loop_lag_ms signal.
        self.loop_lag_ms = 0.0
        # Last published prefetch budget (change detection for the
        # flight event + gauge — the budget is a pure function of
        # level/ladder state, so publishing on transitions only keeps
        # the tape quiet).
        self._last_prefetch_budget = 1.0
        telemetry.PRESSURE.declare_steps(self.ladder)
        telemetry.PREFETCH.set_budget(1.0)

    # ---------------------------------------------------------- signals

    def _thresholds(self, name: str) -> Tuple[float, float]:
        c = self.config
        return {
            "hbm": (c.hbm_high, c.hbm_low),
            "host_rss_mb": (c.host_rss_high_mb, c.host_rss_low_mb),
            "disk": (c.disk_high, c.disk_low),
            "queue": (float(c.queue_high), float(c.queue_low)),
            "loop_lag_ms": (c.loop_lag_high_ms, c.loop_lag_low_ms),
        }.get(name, (0.0, 0.0))

    def _classify(self, name: str, value: float) -> int:
        """One signal's level with enter-high/exit-low hysteresis."""
        high, low = self._thresholds(name)
        if high <= 0:
            return LEVEL_OK           # signal disabled by config
        state = self._signal_states.setdefault(name, _SignalState())
        if value >= high * self.config.critical_factor:
            state.engaged = True
            return LEVEL_CRITICAL
        if value >= high:
            state.engaged = True
            return LEVEL_ELEVATED
        if state.engaged and value > low:
            # Between the watermarks: stays elevated until it falls
            # below low — the hysteresis that stops level flapping.
            return LEVEL_ELEVATED
        state.engaged = False
        return LEVEL_OK

    def sample(self) -> Dict[str, float]:
        samples: Dict[str, float] = {}
        for name, source in self.sources.items():
            try:
                value = source()
            except Exception:
                value = None
            if value is None:
                continue
            samples[name] = float(value)
            telemetry.PRESSURE.set_signal(name, float(value))
        return samples

    # ------------------------------------------------------------ ladder

    def _run_hook(self, step: str, hook: Optional[Callable]) -> None:
        if hook is None:
            return
        try:
            hook()
        except Exception:
            log.warning("pressure actuator %r failed", step,
                        exc_info=True)

    def _engage_next(self) -> None:
        step = self.ladder[self.engaged]
        self.engaged += 1
        actuator = self.actuators.get(step)
        if actuator is not None:
            self._run_hook(step, actuator.engage)
        telemetry.PRESSURE.set_step(step, True)
        telemetry.FLIGHT.record("pressure.step", step=step,
                                action="engage", engaged=self.engaged)
        log.warning("pressure brownout: engaged ladder step %r "
                    "(%d/%d)", step, self.engaged, len(self.ladder))

    def _release_last(self) -> None:
        self.engaged -= 1
        step = self.ladder[self.engaged]
        actuator = self.actuators.get(step)
        if actuator is not None:
            self._run_hook(step, actuator.release)
        telemetry.PRESSURE.set_step(step, False)
        telemetry.FLIGHT.record("pressure.step", step=step,
                                action="release", engaged=self.engaged)
        log.info("pressure recovered: released ladder step %r (%d/%d)",
                 step, self.engaged, len(self.ladder))

    def tick(self) -> int:
        """One governor evaluation; returns the folded level.  Called
        from the asyncio runner and directly by tests."""
        samples = self.sample()
        level = LEVEL_OK
        for name, value in samples.items():
            level = max(level, self._classify(name, value))
        if level != self.level:
            telemetry.FLIGHT.record(
                "pressure.level", level=LEVEL_NAMES[level],
                prev=LEVEL_NAMES[self.level],
                **{k: round(v, 3) for k, v in samples.items()})
            log.log(logging.WARNING if level > self.level
                    else logging.INFO,
                    "pressure level %s -> %s (%s)",
                    LEVEL_NAMES[self.level], LEVEL_NAMES[level],
                    {k: round(v, 2) for k, v in samples.items()})
        self.level = level
        telemetry.PRESSURE.set_level(level)
        if level >= LEVEL_ELEVATED:
            self._ok_streak = 0
            self._hot_streak += 1
            hold = (1 if level == LEVEL_CRITICAL
                    else self.config.step_hold_ticks)
            if (self.engaged < len(self.ladder)
                    and self._hot_streak >= hold):
                self._engage_next()
                self._hot_streak = 0
        else:
            self._hot_streak = 0
            self._ok_streak += 1
            if (self.engaged > 0
                    and self._ok_streak >= self.config.release_hold_ticks):
                self._release_last()
                self._ok_streak = 0
        # Re-apply sustained-effect steps (eviction) while engaged.
        for i in range(self.engaged):
            actuator = self.actuators.get(self.ladder[i])
            if actuator is not None and actuator.while_engaged:
                self._run_hook(self.ladder[i], actuator.while_engaged)
        # Publish the continuous prefetch budget on transitions: the
        # budget scales DOWN with the level before the binary
        # ``pause_prefetch`` step ever engages, and restores in exact
        # reverse on release (the pause/release pair is just the
        # budget's floor).
        budget = self.prefetch_budget()
        if budget != self._last_prefetch_budget:
            telemetry.PREFETCH.set_budget(budget)
            telemetry.FLIGHT.record(
                "prefetch.budget", scale=budget,
                prev=self._last_prefetch_budget,
                level=LEVEL_NAMES[level],
                paused=self.step_engaged("pause_prefetch"))
            self._last_prefetch_budget = budget
        return level

    # ------------------------------------------------- consumer queries

    def step_engaged(self, step: str) -> bool:
        try:
            return self.ladder.index(step) < self.engaged
        except ValueError:
            return False

    def engaged_steps(self) -> List[str]:
        return list(self.ladder[:self.engaged])

    def quality_cap(self) -> Optional[int]:
        """JPEG quality ceiling for interactive tiles while
        ``drop_quality`` is engaged; None = no cap."""
        if self.step_engaged("drop_quality"):
            return self.config.quality_cap
        return None

    def admission_scale(self) -> float:
        """Multiplier on the admission queue bound (``<= 1``);
        1.0 while ``tighten_admission`` is not engaged."""
        if self.step_engaged("tighten_admission"):
            return self.config.admission_scale
        return 1.0

    def bulk_shed_active(self) -> bool:
        return self.step_engaged("shed_bulk")

    def prefetch_budget(self) -> float:
        """The continuous prefetch budget scale in [0, 1]: a pure
        function of the folded level and the ``pause_prefetch`` ladder
        state, so it is symmetric by construction — whatever path the
        level took down, the identical path back up restores the
        identical budgets in reverse.

        * ok        -> 1.0
        * elevated  -> ``prefetch-budget-elevated`` (default 0.5)
        * critical  -> ``prefetch-budget-critical`` (default 0.25)
        * ``pause_prefetch`` engaged -> 0.0 (the ladder's binary pause
          is now the budget's floor, not a separate mechanism)

        Consumers (``services.prefetch.TilePrefetcher``) multiply this
        into their ``max_pending``, so speculative staging shrinks
        smoothly as the service starts drowning instead of running at
        full tilt until the ladder slams it off.
        """
        if self.step_engaged("pause_prefetch"):
            return 0.0
        if self.level >= LEVEL_CRITICAL:
            return getattr(self.config, "prefetch_budget_critical",
                           0.25)
        if self.level >= LEVEL_ELEVATED:
            return getattr(self.config, "prefetch_budget_elevated",
                           0.5)
        return 1.0

    def summary(self) -> str:
        """One-line /readyz annotation."""
        if self.engaged == 0 and self.level == LEVEL_OK:
            return "ok"
        steps = ",".join(self.engaged_steps()) or "-"
        return f"{LEVEL_NAMES[self.level]}; steps={steps}"

    # ------------------------------------------------------------ runner

    async def run(self) -> None:
        """Asyncio tick loop; measures its own scheduling lag as the
        ``loop_lag_ms`` signal (a loop that cannot keep a sleep on
        schedule is a loop that cannot keep responses on schedule)."""
        import asyncio

        interval = max(0.05, self.config.interval_s)
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(interval)
            lag_ms = max(0.0,
                         (time.monotonic() - t0 - interval) * 1000.0)
            # EWMA so one GC pause doesn't read as sustained lag.
            self.loop_lag_ms += 0.3 * (lag_ms - self.loop_lag_ms)
            self.tick()


def is_bulk(ctx) -> bool:
    """Bulk/projection classification for ``shed_bulk``: z-projection
    jobs and full-plane (no tile, no region) renders — the work class
    the ladder sheds FIRST, before any interactive degradation.

    Shape-mask requests (``ShapeMaskCtx``, identified by their
    ``shape_id``) are interactive: a mask overlay is part of the
    viewer's pan loop, and it draws 1 fairness token like a tile (it
    has no tile and no region, and would otherwise read as bulk)."""
    if getattr(ctx, "shape_id", None) is not None:
        return False
    return ctx.projection is not None or (
        ctx.tile is None and ctx.region is None)


def shed_bulk_under_pressure(ctx) -> None:
    """Brownout ladder "shed_bulk": while engaged, full-plane and
    z-projection work sheds with 503 + Retry-After before any read or
    staging cost: bulk work is the first availability sacrifice, always
    ahead of interactive tiles (the ladder-order invariant validated at
    config load)."""
    governor = active()
    if governor is None or not governor.bulk_shed_active() \
            or not is_bulk(ctx):
        return
    from .errors import OverloadedError
    telemetry.RESILIENCE.count_shed("pressure-bulk")
    telemetry.FLIGHT.record("admission.shed", reason="pressure-bulk",
                            image=ctx.image_id)
    raise OverloadedError(
        "bulk/projection work shed under resource pressure",
        retry_after_s=5.0)


def pressure_quality(quality: int, ctx) -> int:
    """Brownout ladder "drop_quality": cap interactive tile JPEG quality
    while engaged (bulk work is the shed step's).  A capped render marks
    the ctx, so the byte-cache write-back is skipped and the response
    carries no ETag (``Cache-Control: no-store``): lower-quality bytes
    must never be cached under the full-quality key and outlive the
    brownout.  The group runs K3 with the capped quality's tables, and
    under ``jpeg-engine: huffman`` the Huffman tables tuned for it."""
    governor = active()
    if governor is None or ctx.tile is None:
        return quality
    cap = governor.quality_cap()
    if cap is not None and quality > cap:
        ctx._pressure_quality_capped = True
        return cap
    return quality


def build_sources(services=None, governor_ref: Optional[list] = None,
                  router=None) -> Dict[str, Callable[[], Optional[float]]]:
    """The standard signals over a service stack; each is None-safe, so a
    missing subsystem drops its signal.  With a fleet ``router`` the
    queue is the router's."""
    raw_cache = getattr(services, "raw_cache", None)
    disk = getattr(getattr(services, "caches", None), "disk", None)
    renderer = getattr(services, "renderer", None)

    def hbm() -> Optional[float]:
        if raw_cache is None or not getattr(raw_cache, "max_bytes", 0):
            return None
        return raw_cache.size_bytes / raw_cache.max_bytes

    def disk_frac() -> Optional[float]:
        if disk is None or not getattr(disk, "max_bytes", 0):
            return None
        return disk.size_bytes / disk.max_bytes

    def queue() -> Optional[float]:
        if router is not None:
            return float(router.queue_depth())
        if not hasattr(renderer, "queue_depth"):
            return None
        return float(renderer.queue_depth())

    def loop_lag() -> Optional[float]:
        if governor_ref:
            return governor_ref[0].loop_lag_ms
        return None

    return {
        "hbm": hbm,
        "host_rss_mb": lambda: read_rss_mb(),
        "disk": disk_frac,
        "queue": queue,
        "loop_lag_ms": loop_lag,
    }


def build_actuators(config, services=None,
                    router=None) -> Dict[str, StepActuator]:
    """The standard actuators.  The flag steps (``drop_quality``,
    ``shed_bulk``, ``tighten_admission``) have none: their consumers ask
    the governor.  A fleet ``router`` has its hot routes' replicas
    demoted first by ``evict_caches``."""
    prefetcher = getattr(services, "prefetcher", None)
    warmstate = getattr(services, "warmstate", None)
    raw_cache = getattr(services, "raw_cache", None)
    disk = getattr(getattr(services, "caches", None), "disk", None)
    renderer = getattr(services, "renderer", None)
    actuators: Dict[str, StepActuator] = {}

    def flag(target, paused: bool):
        def hook():
            target.paused = paused
        return hook

    if prefetcher is not None:
        actuators["pause_prefetch"] = StepActuator(
            engage=flag(prefetcher, True), release=flag(prefetcher, False))
    if warmstate is not None:
        actuators["pause_snapshots"] = StepActuator(
            engage=flag(warmstate, True), release=flag(warmstate, False))

    def evict():
        if router is not None:
            try:
                router.shed_replicas()
            except Exception:
                log.debug("replica shed failed", exc_info=True)
        frac = config.evict_to_frac
        if raw_cache is not None:
            raw_cache.evict_to_fraction(frac)
        if disk is not None:
            disk.evict_to_fraction(frac)

    if raw_cache is not None or disk is not None or router is not None:
        actuators["evict_caches"] = StepActuator(
            engage=evict, while_engaged=evict)

    if hasattr(renderer, "set_lane_cap"):
        actuators["cap_lanes"] = StepActuator(
            engage=lambda: renderer.set_lane_cap(config.lane_cap),
            release=lambda: renderer.set_lane_cap(0))

    return actuators


# ------------------------------------------------------- module global

_INSTALLED: Optional[PressureGovernor] = None


def install(governor: Optional[PressureGovernor]
            ) -> Optional[PressureGovernor]:
    """Install the process-global governor (None uninstalls)."""
    global _INSTALLED
    _INSTALLED = governor
    return _INSTALLED


def uninstall() -> None:
    global _INSTALLED
    _INSTALLED = None


def active() -> Optional[PressureGovernor]:
    return _INSTALLED
