"""Live perf-regression sentinel: the service checks its own latency.

Counterpart of the JAX package's ``server/sentinel.py``, on by default as
there (``sentinel.enabled``).  An always-on engine that

1. **learns what normal is**: per-(route class, shape bucket) latency
   quantiles in fixed-size mergeable rank sketches
   (``utils.sketch.RankSketch``; the insert is two operations, no lock),
   and a rolling p50/p99 baseline learned tick over tick and kept in the
   warm-state manifest (``services.warmstate``), so a restart does not
   forget it;
2. **confirms before it fires**: a breach (window p99 over baseline p99 x
   ``drift_ratio``) must hold ``confirm_ticks`` consecutive windows of at
   least ``min_samples`` observations, so one slow request or one quiet
   minute never pages anyone; ``recover_ticks`` clean windows clear it;
3. **captures the evidence**: on a confirmed drift, one incident bundle,
   a directory holding the flight ring, the top-K cost ledgers, the
   drifted sketch against its baseline, the exemplar trace ids and a
   device profile (``telemetry.capture_profile``: ``torch.profiler`` with
   CUDA activity on a card), its manifest written last and atomically,
   announced as ``sentinel.drift`` / ``sentinel.capture`` flight events
   and a ``kind=sentinel`` decision-ledger record, capped by a retention
   sweep.

**Watermarks.**  The JAX engine also judges live traffic against the
repo's committed best-ever marks, read through ``scripts/bench_gate.py``
from the ``BENCH_r*.json`` and ``MULTICHIP_r*.json`` families.  Those are
the JAX package's TPU and CPU records: a floor from them would judge the
card against another machine.  The port's loader
(:func:`load_repo_watermarks`) reads no record and loads no script; it
returns ``{}`` until the port has records of its own, so the port's
sentinel learns from live traffic alone, as the JAX one does in a repo
without records.  ``sentinel.records-dir`` is accepted for the JAX
config's sake.  An engine given watermarks (``watermarks=``) uses them
as the JAX one does.

The tick runs on a worker thread (:meth:`SentinelEngine.run`), so the
bundle's profile never blocks the event loop.  Fleet posture: every
member process (combined app, sidecar) runs its own engine, and in a
federation each host's tick summary rides its gossip answers into
``telemetry.SENTINEL`` (:meth:`~..utils.telemetry.SentinelStats.ingest`),
so ``GET /debug/sentinel`` answers one merged view over the hosts and
``/readyz`` carries the annotation-only ``sentinel`` note.  Best effort:
no sentinel failure fails a request, a tick or the boot.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import decisions, telemetry
from ..utils.sketch import RankSketch

log = logging.getLogger("omero_ms_image_region_tpu_torch.sentinel")

# Closed vocabularies: anything unknown maps to the overflow class
# instead of minting a series.
ROUTE_CLASSES = ("render_image_region", "render_image",
                 "render_birds_eye_view", "shape_mask", "other")
# Response size bucket, a power-of-4 ladder from 4 KB: latency scales with
# the payload, and the bucket keeps one route's thumbnails from hiding its
# full-tile drift.
SHAPE_BUCKETS = ("s4k", "s16k", "s64k", "s256k", "s1m", "s4m", "sbig")

_BUNDLE_PREFIX = "sentinel-"
_BUNDLE_SEQ = itertools.count(1)


def shape_bucket(nbytes: int) -> str:
    lim = 4096
    for name in SHAPE_BUCKETS[:-1]:
        if nbytes <= lim:
            return name
        lim *= 4
    return SHAPE_BUCKETS[-1]


def route_class(route: str) -> str:
    return route if route in ROUTE_CLASSES else "other"


def load_repo_watermarks(root: str) -> dict:
    """The committed best-ever marks the drift floors come from: ``{}``.
    The repo's records under ``root`` are the JAX package's TPU and CPU
    runs, which say nothing of the card, so none is read."""
    return {}


class _KeyState:
    """Per-(route, shape) tracking: the current tick-window sketch,
    the long-lived epoch sketch (bundle diffs + fleet summaries), the
    learned baseline and the confirmation streaks."""

    __slots__ = ("cur", "epoch", "baseline_p50", "baseline_p99",
                 "baseline_ticks", "breach_streak", "ok_streak",
                 "drifting", "last_p50", "last_p99", "last_n")

    def __init__(self):
        self.cur = RankSketch()
        self.epoch = RankSketch()
        self.baseline_p50: Optional[float] = None
        self.baseline_p99: Optional[float] = None
        self.baseline_ticks = 0
        self.breach_streak = 0
        self.ok_streak = 0
        self.drifting = False
        self.last_p50: Optional[float] = None
        self.last_p99: Optional[float] = None
        self.last_n = 0


class SentinelEngine:
    """One member's always-on drift engine.  ``observe`` is the hot
    path (a dict probe + one sketch insert); everything else runs at
    tick cadence under ``_lock``.  The clock, tick driver and every
    capture dependency are injectable — the induced-drift drill runs
    the whole confirm/capture/recover cycle on a virtual clock."""

    def __init__(self, member: str = "local",
                 tick_interval_s: float = 5.0,
                 confirm_ticks: int = 3,
                 recover_ticks: int = 3,
                 min_samples: int = 32,
                 warmup_ticks: int = 3,
                 drift_ratio: float = 1.5,
                 baseline_alpha: float = 0.2,
                 throughput_floor_ratio: float = 0.5,
                 bundle_dir: str = "",
                 max_bundles: int = 8,
                 profile_ms: int = 200,
                 watermarks: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic,
                 profile_fn: Optional[Callable] = None,
                 flight_fn: Optional[Callable] = None,
                 costs_fn: Optional[Callable] = None,
                 exemplars_fn: Optional[Callable] = None):
        self.member = member
        self.tick_interval_s = tick_interval_s
        self.confirm_ticks = max(1, confirm_ticks)
        self.recover_ticks = max(1, recover_ticks)
        self.min_samples = max(1, min_samples)
        self.warmup_ticks = max(1, warmup_ticks)
        self.drift_ratio = drift_ratio
        self.baseline_alpha = baseline_alpha
        self.throughput_floor_ratio = throughput_floor_ratio
        self.bundle_dir = bundle_dir
        self.max_bundles = max(1, max_bundles)
        self.profile_ms = profile_ms
        self.watermarks = watermarks or {}
        self.clock = clock
        self._profile_fn = profile_fn
        self._flight_fn = flight_fn
        self._costs_fn = costs_fn
        self._exemplars_fn = exemplars_fn

        self._lock = threading.Lock()
        self._keys: Dict[Tuple[str, str], _KeyState] = {}
        self._stop = threading.Event()
        # Single-flight + budget for the capture path: one bundle per
        # confirmed incident, never two concurrently, never more than
        # one per confirm window (the cooldown is the confirm window
        # itself — a still-drifting verdict does not re-fire).
        self._capture_lock = threading.Lock()
        self.ticks = 0
        self.observations = 0
        self._last_tick_t: Optional[float] = None
        self.tiles_per_s: Optional[float] = None
        self.last_bundle: Optional[str] = None
        # The last ticked verdict ("ok"|"drifting") — what /readyz's
        # annotation-only note reads without taking the lock.
        self.verdict = "ok"

    # ------------------------------------------------------------- hot

    def observe(self, route: str, nbytes: int, duration_ms: float,
                trace_id: Optional[str] = None) -> None:
        """Per-request accounting: bounded-vocabulary key, one sketch
        insert.  Keys are created under the lock exactly once per
        (route, shape) — at most ``len(ROUTE_CLASSES) *
        len(SHAPE_BUCKETS)`` times per process life."""
        key = (route_class(route), shape_bucket(nbytes))
        state = self._keys.get(key)
        if state is None:
            with self._lock:
                state = self._keys.setdefault(key, _KeyState())
        state.cur.add(duration_ms)
        self.observations += 1

    # ------------------------------------------------------------ tick

    def _watermark_latency_floor(self) -> Optional[float]:
        """The committed p50 service-latency mark (ms), if any — a
        live p99 under it can never be drift, whatever the learned
        baseline says (absolute floor against over-sensitive
        baselines learned during an unusually fast era)."""
        mark = (self.watermarks.get("bench") or {}).get(
            "p50_service_tile_ms_ex_rtt")
        if isinstance(mark, dict) and isinstance(
                mark.get("value"), (int, float)):
            return float(mark["value"])
        return None

    def _watermark_tiles_per_s(self) -> Optional[float]:
        mark = (self.watermarks.get("bench") or {}).get(
            "service_tiles_per_sec")
        if isinstance(mark, dict) and isinstance(
                mark.get("value"), (int, float)):
            return float(mark["value"])
        return None

    def tick(self) -> dict:
        """One drift evaluation; returns the tick summary (also
        pushed to ``telemetry.SENTINEL``).  Called from the asyncio
        runner and directly by tests/the drill.  Transitions (flight
        events, ledger records, the bundle capture) fire OUTSIDE the
        lock — the SloEngine contract: forensics must never block the
        hot path's key-creation probe."""
        now = self.clock()
        with self._lock:
            summary, newly_confirmed, recovered = \
                self._tick_locked(now)
        if newly_confirmed:
            for _ in newly_confirmed:
                telemetry.SENTINEL.count_drift()
            telemetry.FLIGHT.record(
                "sentinel.drift", member=self.member,
                keys=newly_confirmed,
                tiles_per_s=round(self.tiles_per_s or 0.0, 2))
            decisions.LEDGER.record(
                "sentinel", "drift", member=self.member,
                detail={"keys": newly_confirmed,
                        "tiles_per_s":
                            round(self.tiles_per_s or 0.0, 2)})
            self._capture_bundle(summary)
            summary = dict(summary, last_bundle=self.last_bundle)
        if recovered:
            for _ in recovered:
                telemetry.SENTINEL.count_recovery()
            telemetry.FLIGHT.record(
                "sentinel.recovered", member=self.member,
                keys=recovered)
            decisions.LEDGER.record(
                "sentinel", "recovered", member=self.member,
                detail={"keys": recovered})
        self.verdict = summary.get("verdict", "ok")
        telemetry.SENTINEL.set_local(summary)
        return summary

    def _tick_locked(self, now: float):
        self.ticks += 1
        elapsed = (now - self._last_tick_t
                   if self._last_tick_t is not None
                   else self.tick_interval_s)
        self._last_tick_t = now
        elapsed = max(1e-6, elapsed)

        window_total = 0
        newly_confirmed: List[str] = []
        recovered: List[str] = []
        lat_floor = self._watermark_latency_floor()
        for (route, shape), st in self._keys.items():
            window = st.cur
            st.cur = RankSketch()       # rotate; inserts land in new
            n = window.n
            window_total += n
            st.last_n = n
            if n < self.min_samples:
                # Quiet window: no verdict either way (a lull must
                # neither confirm a drift nor fake a recovery), no
                # baseline update (it would dilute toward noise).
                st.epoch.merge(window)
                continue
            p50 = window.quantile(0.50)
            p99 = window.quantile(0.99)
            st.last_p50, st.last_p99 = p50, p99
            st.epoch.merge(window)
            warmed = (st.baseline_p99 is not None
                      and st.baseline_ticks >= self.warmup_ticks)
            breach = bool(
                warmed and p99 is not None
                and p99 > st.baseline_p99 * self.drift_ratio
                and (lat_floor is None or p99 > lat_floor))
            if breach:
                st.breach_streak += 1
                st.ok_streak = 0
                if (not st.drifting
                        and st.breach_streak >= self.confirm_ticks):
                    st.drifting = True
                    newly_confirmed.append(f"{route}|{shape}")
            else:
                st.ok_streak += 1
                st.breach_streak = 0
                if st.drifting and st.ok_streak >= self.recover_ticks:
                    st.drifting = False
                    recovered.append(f"{route}|{shape}")
                # The baseline only learns from windows that are NOT
                # breaching — a drifted era must not teach the
                # baseline that slow is the new normal.
                a = self.baseline_alpha
                if st.baseline_p50 is None:
                    st.baseline_p50, st.baseline_p99 = p50, p99
                else:
                    st.baseline_p50 += a * (p50 - st.baseline_p50)
                    st.baseline_p99 += a * (p99 - st.baseline_p99)
                st.baseline_ticks += 1

        # Served-tiles/s against the committed watermark: the floor
        # the repo PROMISED, judged only while there is real traffic
        # (idle is not drift).
        self.tiles_per_s = window_total / elapsed
        wm_tps = self._watermark_tiles_per_s()
        throughput_drift = bool(
            wm_tps and window_total >= self.min_samples
            and self.tiles_per_s < wm_tps
            * self.throughput_floor_ratio)

        drifting_keys = sorted(
            f"{route}|{shape}"
            for (route, shape), st in self._keys.items()
            if st.drifting)
        verdict = ("drifting" if drifting_keys or throughput_drift
                   else "ok")
        summary = self._summary_locked(verdict, drifting_keys,
                                       throughput_drift, wm_tps)
        return summary, newly_confirmed, recovered

    def _summary_locked(self, verdict: str,
                        drifting_keys: List[str],
                        throughput_drift: bool,
                        wm_tps: Optional[float]) -> dict:
        routes: Dict[str, dict] = {}
        keys: Dict[str, dict] = {}
        for (route, shape), st in self._keys.items():
            key_doc = {
                "n": st.last_n,
                "p50_ms": st.last_p50, "p99_ms": st.last_p99,
                "baseline_p50_ms": st.baseline_p50,
                "baseline_p99_ms": st.baseline_p99,
                "baseline_ticks": st.baseline_ticks,
                "drifting": st.drifting,
                "breach_streak": st.breach_streak,
            }
            keys[f"{route}|{shape}"] = key_doc
            agg = routes.setdefault(route, {
                "n": 0, "p99_ms": None, "baseline_p99_ms": None})
            agg["n"] += st.last_n
            for field, value in (("p99_ms", st.last_p99),
                                 ("baseline_p99_ms",
                                  st.baseline_p99)):
                if value is not None and (
                        agg[field] is None or value > agg[field]):
                    agg[field] = value
        return {
            "member": self.member,
            "verdict": verdict,
            "ticks": self.ticks,
            "observations": self.observations,
            "drifting": drifting_keys,
            "throughput_drift": throughput_drift,
            "tiles_per_s": (round(self.tiles_per_s, 3)
                            if self.tiles_per_s is not None else None),
            "watermark_tiles_per_s": wm_tps,
            "routes": routes,
            "keys": keys,
            "last_bundle": self.last_bundle,
        }

    def summary(self) -> dict:
        """The current view without advancing the tick clock (debug
        endpoints between ticks)."""
        with self._lock:
            drifting_keys = sorted(
                f"{route}|{shape}"
                for (route, shape), st in self._keys.items()
                if st.drifting)
            return self._summary_locked(
                "drifting" if drifting_keys else "ok",
                drifting_keys, False,
                self._watermark_tiles_per_s())

    # --------------------------------------------------------- bundle

    def _capture_bundle(self, summary: dict) -> Optional[str]:
        """One forensic incident bundle; never raises (forensics must
        never fail the tick), never concurrent (single-flight)."""
        if not self.bundle_dir:
            return None
        if not self._capture_lock.acquire(blocking=False):
            telemetry.SENTINEL.count_bundle(error=True)
            return None
        try:
            return self._capture_bundle_locked(summary)
        except Exception:
            telemetry.SENTINEL.count_bundle(error=True)
            log.warning("sentinel bundle capture failed",
                        exc_info=True)
            return None
        finally:
            self._capture_lock.release()

    def _capture_bundle_locked(self, summary: dict) -> Optional[str]:
        seq = next(_BUNDLE_SEQ)
        name = time.strftime(
            f"{_BUNDLE_PREFIX}%Y%m%d-%H%M%S-{os.getpid()}-{seq:04d}")
        directory = os.path.join(self.bundle_dir, name)
        os.makedirs(directory, exist_ok=True)
        files: Dict[str, Optional[str]] = {}

        def write_json(fname: str, doc) -> Optional[str]:
            try:
                with open(os.path.join(directory, fname), "w") as f:
                    json.dump(doc, f, indent=1, default=str)
                return fname
            except Exception:
                return None

        # 1. Flight dump — fleet-merged when the topology injected a
        # merge callable, the local ring otherwise.
        flight_doc = None
        try:
            flight_doc = (self._flight_fn()
                          if self._flight_fn is not None
                          else {"member": self.member,
                                "events": telemetry.FLIGHT.snapshot()})
        except Exception:
            pass
        files["flight"] = (write_json("flight.json", flight_doc)
                           if flight_doc is not None else None)

        # 2. Top-K cost ledgers — the most expensive recent requests.
        try:
            costs_doc = (self._costs_fn()
                         if self._costs_fn is not None
                         else telemetry.COST_TOPK.snapshot())
        except Exception:
            costs_doc = None
        files["costs"] = (write_json("costs.json", costs_doc)
                          if costs_doc is not None else None)

        # 3. Drifted sketch vs baseline.
        with self._lock:
            diff = {
                key: {
                    "state": doc,
                    "epoch_sketch":
                        self._keys[tuple(key.split("|", 1))]
                        .epoch.to_doc()
                        if tuple(key.split("|", 1)) in self._keys
                        else None,
                }
                for key, doc in (summary.get("keys") or {}).items()
            }
        files["sketch_diff"] = write_json("sketch_diff.json", {
            "member": self.member,
            "drifting": summary.get("drifting"),
            "keys": diff,
        })

        # 4. p99 exemplar trace ids — the requests to go pull traces
        # for.
        try:
            exemplars = (self._exemplars_fn()
                         if self._exemplars_fn is not None
                         else request_exemplars())
        except Exception:
            exemplars = None
        files["exemplars"] = (write_json("exemplars.json", exemplars)
                              if exemplars is not None else None)

        # 5. Device profile — single-flight by its own lock; a capture
        # already in flight (or no device stack) leaves a null entry,
        # never a failed bundle.
        profile_doc = None
        try:
            if self._profile_fn is not None:
                profile_doc = self._profile_fn(directory,
                                               self.profile_ms)
            else:
                profile_doc = telemetry.capture_profile(
                    directory, self.profile_ms)
        except Exception:
            profile_doc = None
        if isinstance(profile_doc, dict) and profile_doc.get("dir"):
            profile_doc = dict(profile_doc)
            profile_doc["dir"] = os.path.relpath(
                profile_doc["dir"], directory)
        files["profile"] = (write_json("profile.json", profile_doc)
                            if profile_doc is not None else None)

        # 6. Manifest LAST, atomically: a manifest's presence is the
        # bundle-complete signal readers key on.
        manifest = {
            "version": 1,
            "kind": "sentinel_incident",
            "member": self.member,
            "ts": round(time.time(), 3),
            "drifting": summary.get("drifting"),
            "throughput_drift": summary.get("throughput_drift"),
            "tiles_per_s": summary.get("tiles_per_s"),
            "watermark_tiles_per_s":
                summary.get("watermark_tiles_per_s"),
            "files": files,
        }
        tmp = os.path.join(directory,
                           f"manifest.json.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(directory, "manifest.json"))

        self.last_bundle = directory
        telemetry.SENTINEL.count_bundle()
        telemetry.FLIGHT.record(
            "sentinel.capture", member=self.member, dir=name,
            files=sorted(k for k, v in files.items() if v))
        self._sweep_bundles()
        return directory

    def _sweep_bundles(self) -> None:
        """Retention: oldest bundles beyond ``max_bundles`` go (the
        FlightRecorder ``_prune`` posture — forensics must not fill
        the disk)."""
        try:
            names = sorted(
                n for n in os.listdir(self.bundle_dir)
                if n.startswith(_BUNDLE_PREFIX)
                and os.path.isdir(os.path.join(self.bundle_dir, n)))
            for n in names[:-self.max_bundles]:
                shutil.rmtree(os.path.join(self.bundle_dir, n),
                              ignore_errors=True)
        except OSError:
            pass

    # ------------------------------------------------ persist/restore

    def export_baseline(self) -> dict:
        """The learned baselines for the warm-state manifest — what a
        restart must not forget (re-learning takes ``warmup_ticks``
        of live traffic during which drift is invisible)."""
        with self._lock:
            return {
                "version": 1,
                "baselines": {
                    f"{route}|{shape}": {
                        "p50": st.baseline_p50,
                        "p99": st.baseline_p99,
                        "ticks": st.baseline_ticks,
                    }
                    for (route, shape), st in self._keys.items()
                    if st.baseline_p99 is not None
                },
            }

    def load_baseline(self, doc) -> int:
        """Rehydrate learned baselines (best-effort parse-or-skip, the
        warmstate posture).  Returns how many keys restored."""
        if not isinstance(doc, dict) or doc.get("version") != 1:
            return 0
        restored = 0
        with self._lock:
            for key, entry in dict(doc.get("baselines") or {}).items():
                try:
                    route, shape = key.split("|", 1)
                    if (route not in ROUTE_CLASSES
                            or shape not in SHAPE_BUCKETS):
                        continue
                    p50 = entry.get("p50")
                    p99 = entry.get("p99")
                    if not isinstance(p99, (int, float)):
                        continue
                    st = self._keys.setdefault((route, shape),
                                               _KeyState())
                    st.baseline_p50 = (float(p50)
                                       if isinstance(p50, (int, float))
                                       else None)
                    st.baseline_p99 = float(p99)
                    st.baseline_ticks = max(
                        int(entry.get("ticks") or 0),
                        self.warmup_ticks)
                    restored += 1
                except (AttributeError, TypeError, ValueError):
                    continue
        if restored:
            log.info("sentinel baselines rehydrated for %d keys",
                     restored)
        return restored

    # ---------------------------------------------------------- runner

    async def run(self) -> None:
        """Asyncio tick loop, cancellation-clean; a tick that throws is
        logged, never fatal.  Each tick runs on a worker thread: a
        confirmed drift captures its bundle there, the device profile
        included, and the event loop keeps serving meanwhile."""
        import asyncio
        while not self._stop.is_set():
            await asyncio.sleep(self.tick_interval_s)
            try:
                await asyncio.to_thread(self.tick)
            except Exception:
                log.warning("sentinel tick failed", exc_info=True)

    def close(self) -> None:
        self._stop.set()


def request_exemplars() -> dict:
    """The request histogram's per-bucket exemplars (the trace id and
    provenance tier of the last request in each latency bucket, per
    route): the slowest buckets are where a drift investigation starts
    (the ``/debug/exemplars`` document)."""
    return telemetry.REQUEST_HIST.exemplar_docs()


# ------------------------------------------------------ module global
# Request paths pay one ``is None`` probe when the sentinel is off.

_INSTALLED: Optional[SentinelEngine] = None


def install(engine: Optional[SentinelEngine]
            ) -> Optional[SentinelEngine]:
    global _INSTALLED
    _INSTALLED = engine
    return _INSTALLED


def uninstall() -> None:
    global _INSTALLED
    _INSTALLED = None


def active() -> Optional[SentinelEngine]:
    return _INSTALLED


def engine_from_config(cfg, member: str,
                       watermarks: Optional[dict] = None,
                       **overrides) -> SentinelEngine:
    """An engine from a validated ``SentinelConfig`` (``server.config``);
    ``overrides`` inject capture callables and clocks."""
    kwargs = dict(
        member=member,
        tick_interval_s=cfg.tick_interval_s,
        confirm_ticks=cfg.confirm_ticks,
        recover_ticks=cfg.recover_ticks,
        min_samples=cfg.min_samples,
        warmup_ticks=cfg.warmup_ticks,
        drift_ratio=cfg.drift_ratio,
        baseline_alpha=cfg.baseline_alpha,
        throughput_floor_ratio=cfg.throughput_floor_ratio,
        bundle_dir=cfg.bundle_dir,
        max_bundles=cfg.max_bundles,
        profile_ms=cfg.profile_ms,
        watermarks=(watermarks if watermarks is not None
                    else load_repo_watermarks(cfg.records_dir)),
    )
    kwargs.update(overrides)
    return SentinelEngine(**kwargs)
