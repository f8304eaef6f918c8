"""Open-loop load model: seeded viewer sessions whose arrivals do not wait.

Counterpart of the JAX package's ``services/loadmodel.py``, a copy of its
arithmetic: the same seed and arguments give the same event stream, field
for field (``tests/test_torch_loadmodel.py`` holds the two packages' streams
equal, and their knee and diurnal fits).  A closed loop (a fixed set of
workers that each wait for their last answer) slows its own offered load
when the service slows; millions of independent viewers do not, so a
closed-loop latency curve stays flat exactly where an open system
collapses.  This module makes the open arrival process a deterministic
object:

* :class:`LoadModel`: 10^4..10^6 simulated viewer sessions with
  lognormal think times and session lengths, pan/zoom trajectories on the
  tile lattice the viewport model predicts, a half-sine diurnal intensity,
  a zipf image-popularity skew and an interactive / bulk / mask / pyramid /
  animation class mix.  ``iter_events`` heap-merges per-session streams,
  so a million sessions never materialise at once.
* :func:`run_open_loop`: each arrival fires as its own task at its
  scheduled offset, whatever the completions; one fired more than 25 ms
  behind schedule counts as ``late``.
* :func:`run_closed_loop`: the same arrivals through a fixed worker pool
  that waits for completions, the flattering comparison leg.
* :func:`find_knee`: the highest offered load whose p99 meets the SLO and
  whose shed rate stays under its bound.
* :class:`DiurnalEstimator`: a single-tone harmonic fit over observed
  arrivals, the autoscaler's diurnal demand multiplier.

A shed is the port's ``server.errors.OverloadedError``; the counters are
``utils.telemetry.LOADMODEL``'s (``imageregion_loadmodel_*``).  Nothing is
left out.  Nothing here imports ``torch``: the model drives a fleet on the
card through the app's handler (``chip_smoke.py``'s ``autoscale:`` phase).
"""

from __future__ import annotations

import asyncio
import bisect
import heapq
import math
import random
import time
from dataclasses import dataclass, field
from typing import (Awaitable, Callable, Dict, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

from ..utils import telemetry

# The request-class vocabulary — the SAME classification the QoS tier
# serves (pressure.is_bulk: interactive tile vs bulk full-plane), plus
# the mask endpoint (QoS-classed interactive, but its own route and
# fairness surface), the pyramid build and the animation strip.
CLASSES = ("interactive", "bulk", "mask", "pyramid", "animation")

# Pan velocities a viewer trajectory may run with (same lattice steps
# the viewport predictor extrapolates).
_VELOCITIES = ((1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, -1))


@dataclass(frozen=True)
class Arrival:
    """One scheduled request of one simulated session.

    ``t`` is the offset in seconds from the window start on the
    model's NATURAL timeline; :meth:`LoadModel.schedule` rescales it
    to a target offered rate.  ``x``/``y``/``level`` address the tile
    lattice for interactive arrivals (bulk renders the full plane;
    masks address ``shape_id = step``-derived ids).  ``image`` is the
    POPULARITY RANK of the image the session browses (0 = hottest),
    drawn once per session from the model's zipf skew — the hot-key
    storm input; 0 for every arrival
    when the model is unskewed (the pre-skew single-image stream)."""

    t: float
    session: str
    cls: str
    step: int
    x: int = 0
    y: int = 0
    level: int = 0
    image: int = 0


class LoadModel:
    """Deterministic seeded open-loop session generator."""

    def __init__(self, viewers: int = 100, seed: int = 1234,
                 duration_s: float = 60.0, grid: int = 8,
                 think_time_median_ms: float = 350.0,
                 think_time_sigma: float = 1.0,
                 session_length_median: float = 24.0,
                 session_length_sigma: float = 1.2,
                 diurnal_amplitude: float = 0.6,
                 bulk_fraction: float = 0.0,
                 mask_fraction: float = 0.0,
                 pyramid_fraction: float = 0.0,
                 animation_fraction: float = 0.0,
                 zoom_fraction: float = 0.05,
                 max_level: int = 0,
                 skew: float = 0.0,
                 image_population: int = 1):
        if viewers < 1:
            raise ValueError("loadmodel viewers must be >= 1")
        if duration_s <= 0:
            raise ValueError("loadmodel duration_s must be > 0")
        if grid < 1:
            raise ValueError("loadmodel grid must be >= 1")
        if think_time_median_ms <= 0 or session_length_median <= 0:
            raise ValueError("loadmodel medians must be > 0")
        if think_time_sigma < 0 or session_length_sigma < 0:
            raise ValueError("loadmodel sigmas must be >= 0")
        if not 0.0 <= diurnal_amplitude < 1.0:
            raise ValueError(
                "loadmodel diurnal_amplitude must be in [0, 1)")
        for name, frac in (("bulk_fraction", bulk_fraction),
                           ("mask_fraction", mask_fraction),
                           ("pyramid_fraction", pyramid_fraction),
                           ("animation_fraction", animation_fraction),
                           ("zoom_fraction", zoom_fraction)):
            if not 0.0 <= frac <= 1.0:
                raise ValueError(f"loadmodel {name} must be in [0, 1]")
        if (bulk_fraction + mask_fraction + pyramid_fraction
                + animation_fraction) > 1.0:
            raise ValueError("loadmodel class fractions (bulk + mask + "
                             "pyramid + animation) must sum to <= 1")
        if skew < 0:
            raise ValueError("loadmodel skew must be >= 0")
        if image_population < 1:
            raise ValueError("loadmodel image_population must be >= 1")
        self.viewers = int(viewers)
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.grid = int(grid)
        self.think_time_median_ms = float(think_time_median_ms)
        self.think_time_sigma = float(think_time_sigma)
        self.session_length_median = float(session_length_median)
        self.session_length_sigma = float(session_length_sigma)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.bulk_fraction = float(bulk_fraction)
        self.mask_fraction = float(mask_fraction)
        self.pyramid_fraction = float(pyramid_fraction)
        self.animation_fraction = float(animation_fraction)
        self.zoom_fraction = float(zoom_fraction)
        self.max_level = int(max_level)
        self.skew = float(skew)
        self.image_population = int(image_population)
        # Popularity CDF over image ranks: zipf weights 1/(k+1)^s
        # (rank 0 hottest; s=0 degenerates to uniform).  Precomputed
        # once — a million sessions bisect the same table.
        self._image_cdf: Optional[List[float]] = None
        if self.image_population > 1:
            weights = [1.0 / (k + 1) ** self.skew
                       for k in range(self.image_population)]
            total = sum(weights)
            acc, cdf = 0.0, []
            for w in weights:
                acc += w / total
                cdf.append(acc)
            cdf[-1] = 1.0
            self._image_cdf = cdf

    @classmethod
    def from_config(cls, config, **structural) -> "LoadModel":
        """Build from a ``loadmodel:`` config block
        (``server.config.LoadModelConfig`` — the validated knob
        surface operators tune); ``structural`` carries the
        deployment-shape parameters the block deliberately does not
        own (duration_s, grid, max_level) plus any per-leg overrides
        (a capacity sweep pins viewers/diurnal for determinism)."""
        kwargs = dict(
            viewers=config.viewers, seed=config.seed,
            think_time_median_ms=config.think_time_median_ms,
            think_time_sigma=config.think_time_sigma,
            session_length_median=config.session_length_median,
            session_length_sigma=config.session_length_sigma,
            diurnal_amplitude=config.diurnal_amplitude,
            bulk_fraction=config.bulk_fraction,
            mask_fraction=config.mask_fraction,
            pyramid_fraction=config.pyramid_fraction,
            animation_fraction=config.animation_fraction,
            zoom_fraction=config.zoom_fraction,
            skew=config.skew,
            image_population=config.image_population)
        kwargs.update(structural)
        return cls(**kwargs)

    # ------------------------------------------------------- diurnal warp

    def _intensity_cdf(self, t: float) -> float:
        """Cumulative mass of the diurnal intensity
        ``1 + A * sin(pi * t / T)`` on [0, T] — a half-sine "day"
        rising to its peak at T/2 and falling back, so one run
        exercises a full ramp-up AND ramp-down (what the elasticity
        drill needs from a single window)."""
        T, A = self.duration_s, self.diurnal_amplitude
        mass = t + A * T / math.pi * (1.0 - math.cos(math.pi * t / T))
        total = T + 2.0 * A * T / math.pi
        return mass / total

    def _warp(self, u: float) -> float:
        """Inverse-CDF of the diurnal intensity: a uniform position
        ``u`` in [0, 1) -> a session start time in [0, T) bunched
        toward the diurnal peak.  Deterministic bisection (no
        closed-form inverse; 40 halvings are exact far past float
        resolution)."""
        lo, hi = 0.0, self.duration_s
        for _ in range(40):
            mid = (lo + hi) / 2.0
            if self._intensity_cdf(mid) < u:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2.0

    # --------------------------------------------------------- generation

    def _session_stream(self, i: int) -> Iterator[Arrival]:
        """One viewer's arrivals, time-ordered.  Every draw comes from
        a per-session ``random.Random`` seeded from (model seed, i) so
        the stream is identical run to run AND independent of how many
        other sessions are interleaved around it."""
        rng = random.Random((self.seed << 20) ^ i)
        session = f"sim-{i}"
        # The session's image rank comes from a SEPARATE derived RNG:
        # turning the skew knob must not shift the trajectory/timing
        # stream (pinned: same seed -> byte-identical arrivals modulo
        # the ``image`` field), and population==1 consumes no draw at
        # all so the pre-skew stream stays bit-exact.
        image = 0
        if self._image_cdf is not None:
            u = random.Random(f"img|{self.seed}|{i}").random()
            image = bisect.bisect_left(self._image_cdf, u)
        t = self._warp(rng.random())
        n = max(1, int(rng.lognormvariate(
            math.log(self.session_length_median),
            self.session_length_sigma)))
        x = rng.randrange(self.grid)
        y = rng.randrange(self.grid)
        level = 0
        vx, vy = rng.choice(_VELOCITIES)
        run_left = rng.randrange(3, 9)
        for step in range(n):
            draw = rng.random()
            b = self.bulk_fraction
            m = b + self.mask_fraction
            p = m + self.pyramid_fraction
            a = p + self.animation_fraction
            if draw < b:
                cls = "bulk"
            elif draw < m:
                cls = "mask"
            elif draw < p:
                cls = "pyramid"
            elif draw < a:
                cls = "animation"
            else:
                cls = "interactive"
            yield Arrival(t=t, session=session, cls=cls, step=step,
                          x=x, y=y, level=level, image=image)
            # Advance the viewport: constant-velocity pan runs with
            # occasional turns (the trajectory shape the viewport
            # predictor reads), rare zoom level changes.
            if rng.random() < self.zoom_fraction and self.max_level:
                level = min(self.max_level,
                            max(0, level + rng.choice((-1, 1))))
            run_left -= 1
            if run_left <= 0:
                vx, vy = rng.choice(_VELOCITIES)
                run_left = rng.randrange(3, 9)
            x = (x + vx) % self.grid
            y = (y + vy) % self.grid
            t += rng.lognormvariate(
                math.log(self.think_time_median_ms / 1000.0),
                self.think_time_sigma)

    def iter_events(self) -> Iterator[Arrival]:
        """ALL sessions' arrivals merged in time order — lazy: a
        heap-merge over per-session generators, so a 10^6-session
        stream holds one pending arrival per session, never the whole
        tape.  Arrivals past the window (a heavy-tailed session that
        outlives the day) are clipped."""
        streams = (self._session_stream(i) for i in range(self.viewers))
        for arrival in heapq.merge(*streams, key=lambda a: a.t):
            if arrival.t < self.duration_s:
                yield arrival

    def events(self) -> List[Arrival]:
        return list(self.iter_events())

    def natural_rate_tps(self, events: Optional[Sequence[Arrival]] = None
                         ) -> float:
        """The model's own aggregate arrival rate (events per second
        over the window) — what :meth:`schedule` rescales from."""
        evs = self.events() if events is None else events
        if not evs:
            return 0.0
        return len(evs) / self.duration_s

    def schedule(self, offered_tps: float,
                 events: Optional[Sequence[Arrival]] = None
                 ) -> List[Arrival]:
        """The event stream time-compressed to a target offered rate:
        the same session mix, trajectories and relative spacing, with
        every timestamp scaled by ``natural_rate / offered_tps`` — the
        standard open-loop replay sweep (compressing the day, not
        changing the users)."""
        if offered_tps <= 0:
            raise ValueError("offered_tps must be > 0")
        evs = list(self.events() if events is None else events)
        natural = self.natural_rate_tps(evs)
        if natural <= 0:
            return []
        scale = natural / offered_tps
        return [Arrival(t=a.t * scale, session=a.session, cls=a.cls,
                        step=a.step, x=a.x, y=a.y, level=a.level,
                        image=a.image)
                for a in evs]

    def window(self, offered_tps: float, window_s: float,
               events: Optional[Sequence[Arrival]] = None
               ) -> List[Arrival]:
        """A STATIONARY measurement window at a target offered rate.

        :meth:`schedule` rescales the whole day, but the day's edges
        are thin — sessions ramp in after t=0 and drain out before
        t=T, so the first ``window_s`` of a compressed schedule
        carries a fraction of the nominal rate (measured: 0.45x asked
        came out 0.1x).  The capacity sweep instead samples the
        STREAM'S STEADY STATE: the central slice between the 30th and
        70th percentile event times (widened when a high rate needs
        more events), re-zeroed and rescaled so the slice's own rate
        equals ``offered_tps``, cut at ``window_s``.  Raises when the
        model simply has too few events for the asked window —
        silently under-offering would corrupt the knee."""
        if offered_tps <= 0 or window_s <= 0:
            raise ValueError("offered_tps and window_s must be > 0")
        evs = list(self.events() if events is None else events)
        needed = int(math.ceil(offered_tps * window_s))
        if len(evs) < needed:
            raise ValueError(
                f"load model has {len(evs)} events but the window "
                f"needs {needed}: raise viewers (or duration)")
        n = len(evs)
        frac = 0.2
        while True:
            lo_i = int((0.5 - frac) * n)
            hi_i = max(lo_i + 2, int((0.5 + frac) * n))
            mid = evs[lo_i:min(hi_i, n)]
            if len(mid) >= needed or frac >= 0.5:
                break
            frac = min(0.5, frac * 1.5)
        # Exactly ``needed`` events rescaled so the last lands at the
        # window edge: the in-window average rate is then the target
        # BY CONSTRUCTION (a slice-average rescale under-offers when
        # the slice's local density varies), while the heavy-tailed
        # relative spacing — the arrival bunching the knee feels — is
        # preserved.
        take = mid[:needed]
        t_lo = take[0].t
        if needed < 2:
            return [Arrival(t=0.0, session=take[0].session,
                            cls=take[0].cls, step=take[0].step,
                            x=take[0].x, y=take[0].y,
                            level=take[0].level,
                            image=take[0].image)]
        scale = window_s / max(take[-1].t - t_lo, 1e-9)
        return [Arrival(t=(a.t - t_lo) * scale, session=a.session,
                        cls=a.cls, step=a.step, x=a.x, y=a.y,
                        level=a.level, image=a.image)
                for a in take]


# ------------------------------------------------------------- execution

@dataclass
class LoadReport:
    """One load leg's outcome: per-class latencies, sheds, errors and
    schedule slip.  ``late_ms`` is the worst behind-schedule fire —
    the open-loop integrity number (a generator that cannot keep its
    own schedule is measuring itself, not the service)."""

    offered_tps: float = 0.0
    window_s: float = 0.0
    latencies_ms: Dict[str, List[float]] = field(default_factory=dict)
    served: int = 0
    sheds: int = 0
    errors: List[str] = field(default_factory=list)
    late_fires: int = 0
    late_ms: float = 0.0

    def all_latencies(self) -> List[float]:
        out: List[float] = []
        for vals in self.latencies_ms.values():
            out.extend(vals)
        return out

    def p99_ms(self) -> Optional[float]:
        vals = sorted(self.all_latencies())
        if not vals:
            return None
        return vals[int(0.99 * (len(vals) - 1))]

    def shed_rate(self) -> float:
        total = self.served + self.sheds
        return self.sheds / total if total else 0.0

    def as_point(self) -> dict:
        return {
            "offered_tps": round(self.offered_tps, 1),
            "p99_ms": (round(self.p99_ms(), 1)
                       if self.p99_ms() is not None else None),
            "shed_rate": round(self.shed_rate(), 4),
            "served": self.served,
            "sheds": self.sheds,
            "late_ms": round(self.late_ms, 1),
        }


# A fire more than this far behind schedule counts as late (scheduler
# jitter under it is noise, not an integrity problem).
_LATE_TOLERANCE_S = 0.025


async def _one(submit, arrival: Arrival, report: LoadReport,
               shed_types: tuple) -> None:
    t0 = time.perf_counter()
    try:
        await submit(arrival)
    except shed_types:
        report.sheds += 1
        telemetry.LOADMODEL.count_shed()
        return
    except Exception as e:     # noqa: BLE001 — the drill's gate input
        report.errors.append(repr(e)[:200])
        return
    report.latencies_ms.setdefault(arrival.cls, []).append(
        (time.perf_counter() - t0) * 1000.0)
    report.served += 1
    telemetry.LOADMODEL.count_completed(arrival.cls)


def _shed_types() -> tuple:
    from ..server.errors import OverloadedError
    return (OverloadedError,)


async def run_open_loop(submit: Callable[[Arrival], Awaitable],
                        arrivals: Iterable[Arrival],
                        offered_tps: float = 0.0,
                        stop: Optional[asyncio.Event] = None
                        ) -> LoadReport:
    """Fire each arrival on schedule REGARDLESS of completions.

    ``submit`` is the service seam (an async callable raising
    ``OverloadedError`` on a shed); every arrival becomes its own
    task at its scheduled offset from the window start — a slow
    service changes nothing about when the next arrival fires, which
    is the entire point.  ``stop`` (optional) aborts the remaining
    schedule early (the elasticity drill's phase boundary)."""
    shed_types = _shed_types()
    report = LoadReport(offered_tps=offered_tps)
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    tasks: List[asyncio.Task] = []
    last_t = 0.0
    for arrival in arrivals:
        if stop is not None and stop.is_set():
            break
        delay = arrival.t - (loop.time() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        elif -delay > _LATE_TOLERANCE_S:
            report.late_fires += 1
            report.late_ms = max(report.late_ms, -delay * 1000.0)
            telemetry.LOADMODEL.count_late()
        telemetry.LOADMODEL.count_offered(arrival.cls)
        tasks.append(loop.create_task(
            _one(submit, arrival, report, shed_types)))
        last_t = arrival.t
    if tasks:
        await asyncio.gather(*tasks)
    report.window_s = max(last_t, loop.time() - t0, 1e-6)
    return report


async def run_closed_loop(submit: Callable[[Arrival], Awaitable],
                          arrivals: Sequence[Arrival],
                          concurrency: int = 8) -> LoadReport:
    """The SAME arrival list, closed-loop: a fixed worker pool pulls
    the next arrival only after its previous one COMPLETED.  The
    schedule timestamps are ignored by construction — that is the
    flattering lie this leg exists to demonstrate: past the capacity
    knee the workers self-throttle to exactly the service rate, so
    queues never build and the reported p99 stays near the service
    time while the open-loop p99 (same offered load) collapses."""
    shed_types = _shed_types()
    report = LoadReport(
        offered_tps=(len(arrivals) / max(arrivals[-1].t, 1e-6)
                     if arrivals else 0.0))
    queue: "asyncio.Queue[Arrival]" = asyncio.Queue()
    for arrival in arrivals:
        queue.put_nowait(arrival)

    async def worker() -> None:
        while True:
            try:
                arrival = queue.get_nowait()
            except asyncio.QueueEmpty:
                return
            telemetry.LOADMODEL.count_offered(arrival.cls)
            await _one(submit, arrival, report, shed_types)

    t0 = asyncio.get_running_loop().time()
    await asyncio.gather(*(worker()
                           for _ in range(max(1, concurrency))))
    report.window_s = max(asyncio.get_running_loop().time() - t0, 1e-6)
    return report


# ------------------------------------------------------------ knee math

def find_knee(points: Sequence[dict], slo_ms: float,
              max_shed_rate: float = 0.05
              ) -> Tuple[Optional[float], Optional[float], bool]:
    """The capacity knee of one fleet size's measured curve.

    ``points`` is an offered-load-ascending list of
    ``{offered_tps, p99_ms, shed_rate}``; the knee is the HIGHEST
    offered load whose p99 still meets the SLO and whose shed rate
    stays under ``max_shed_rate``.  Returns ``(knee_tps,
    p99_at_knee_ms, censored)`` — ``censored`` means every measured
    point passed, so the true knee lies past the sweep (the curve
    must be re-run wider before the number is trusted); a first point
    that already violates returns ``(None, None, False)`` (the knee
    lies below the sweep — equally loud)."""
    knee = None
    p99_at_knee = None
    violated = False
    for point in points:
        p99 = point.get("p99_ms")
        shed = point.get("shed_rate", 0.0)
        ok = (p99 is not None and p99 <= slo_ms
              and shed <= max_shed_rate)
        if ok and not violated:
            knee = float(point["offered_tps"])
            p99_at_knee = float(p99)
        elif not ok:
            violated = True
    return knee, p99_at_knee, not violated


# ----------------------------------------------------- diurnal estimate

class DiurnalEstimator:
    """Diurnal-phase demand estimate fitted from OBSERVED arrivals.

    The autoscaler's flat demand signal (viewport-tracked sessions x a
    steady per-session rate) is blind to WHERE in the day the fleet
    sits, so a scale decision at the morning ramp provisions for the
    quiet minute it was measured in.  This estimator adds the phase:
    :meth:`observe` bins arrival timestamps (O(1) per
    request, bounded ring of bins), and :meth:`fit` runs a single-tone
    harmonic regression

        ``rate(t) ~= a + b*sin(w t) + c*cos(w t)``,  ``w = 2*pi/T``

    over the held bins — the closed-form least squares of the model's
    own half-sine day (``LoadModel`` intensity ``1 + A sin(pi t/T)``
    is exactly one half-period of a tone with period ``2T``, so the
    fit recovers the generator's amplitude/phase).  :meth:`multiplier` then answers
    ``rate(now + horizon) / mean_rate`` clamped to a sane band — the
    factor the autoscaler multiplies its session-demand estimate by,
    so shrink decisions inside a rising ramp see the demand the
    shrink completes INTO.

    Deliberately conservative: unfit (too few bins, too little time
    span, or a fitted amplitude within noise) multiplies by exactly
    1.0 — the estimator can only ever ADD phase awareness, never
    subtract the flat signal's floor.
    """

    #: Clamp band for the multiplier: a fit can at most quarter or
    #: quadruple the flat demand estimate (a wild fit from a sparse
    #: tape must not park the fleet or slam it to the ceiling).
    MIN_MULT, MAX_MULT = 0.25, 4.0

    def __init__(self, period_s: float = 86400.0,
                 bin_s: Optional[float] = None,
                 min_bins: int = 8,
                 min_span_fraction: float = 0.25,
                 clock: Callable[[], float] = time.time):
        if period_s <= 0:
            raise ValueError("diurnal period_s must be > 0")
        self.period_s = float(period_s)
        self.bin_s = float(bin_s) if bin_s else self.period_s / 48.0
        if self.bin_s <= 0:
            raise ValueError("diurnal bin_s must be > 0")
        # Hold up to two periods of bins: enough span for a stable
        # tone fit, bounded forever.
        self.max_bins = max(int(min_bins),
                            int(2 * self.period_s / self.bin_s) + 1)
        self.min_bins = int(min_bins)
        self.min_span_fraction = float(min_span_fraction)
        self.clock = clock
        # bin index -> count; insertion-ordered so eviction drops the
        # oldest observation window first.
        self._bins: "Dict[int, int]" = {}
        self._fit: Optional[Tuple[float, float, float]] = None
        self._fit_at_bin: Optional[int] = None

    # ------------------------------------------------------- observation

    def observe(self, t: Optional[float] = None) -> None:
        """Record one arrival (ns-scale: one dict bump)."""
        t = self.clock() if t is None else float(t)
        b = int(t // self.bin_s)
        if b in self._bins:
            self._bins[b] += 1
            return
        self._bins[b] = 1
        while len(self._bins) > self.max_bins:
            self._bins.pop(next(iter(self._bins)))

    # -------------------------------------------------------------- fit

    def fit(self) -> Optional[Tuple[float, float, float]]:
        """(a, b, c) of the harmonic regression over CLOSED bins (the
        live bin is still filling — including it would read every
        fresh bin as a demand cliff), or None when the tape is too
        short.  Closed form via the 3x3 normal equations — no numpy,
        this module stays import-light."""
        now_bin = int(self.clock() // self.bin_s)
        observed = [(b, n) for b, n in self._bins.items()
                    if b < now_bin]
        if len(observed) < self.min_bins:
            return None
        # The regression must see the TROUGH too: a bin inside the
        # observed span that received no arrivals is a true zero-rate
        # point, not a missing one — leaving it out regresses only
        # over the busy phase and systematically flattens the fitted
        # amplitude (the overnight blind spot this estimator exists
        # to close).  Zero-filled across [oldest, newest] observed
        # closed bins, bounded to the ring's own two periods.
        last = min(max(b for b, _ in observed) + 1, now_bin)
        first = max(min(b for b, _ in observed),
                    last - self.max_bins)
        closed = [(b, self._bins.get(b, 0))
                  for b in range(first, last)]
        span = len(closed) * self.bin_s
        if span < self.min_span_fraction * self.period_s:
            return None          # a flat sliver fits anything
        w = 2.0 * math.pi / self.period_s
        # Normal equations for y ~ a + b sin + c cos.
        s = [[0.0] * 3 for _ in range(3)]
        v = [0.0, 0.0, 0.0]
        for b, n in closed:
            t = (b + 0.5) * self.bin_s
            row = (1.0, math.sin(w * t), math.cos(w * t))
            y = n / self.bin_s          # rate, not count
            for i in range(3):
                v[i] += row[i] * y
                for j in range(3):
                    s[i][j] += row[i] * row[j]
        # Gaussian elimination with partial pivoting (3x3).
        m = [s[i] + [v[i]] for i in range(3)]
        for col in range(3):
            piv = max(range(col, 3), key=lambda r: abs(m[r][col]))
            if abs(m[piv][col]) < 1e-12:
                return None             # degenerate design (all bins
                # at one phase): no tone is identifiable
            m[col], m[piv] = m[piv], m[col]
            for r in range(3):
                if r == col:
                    continue
                f = m[r][col] / m[col][col]
                for c in range(col, 4):
                    m[r][c] -= f * m[col][c]
        a, bb, cc = (m[i][3] / m[i][i] for i in range(3))
        if a <= 0:
            return None
        self._fit = (a, bb, cc)
        self._fit_at_bin = now_bin
        return self._fit

    @property
    def amplitude(self) -> Optional[float]:
        """Fitted relative amplitude sqrt(b^2+c^2)/a — comparable to
        the LoadModel's ``diurnal_amplitude`` on a matching period."""
        if self._fit is None:
            return None
        a, b, c = self._fit
        return math.hypot(b, c) / a

    @property
    def phase_s(self) -> Optional[float]:
        """Fitted phase offset in seconds: where the tone's upward
        zero-crossing sits relative to t=0 of the clock."""
        if self._fit is None:
            return None
        a, b, c = self._fit
        w = 2.0 * math.pi / self.period_s
        return math.atan2(c, b) / w

    # -------------------------------------------------------- prediction

    def multiplier(self, at: Optional[float] = None,
                   horizon_s: float = 0.0) -> float:
        """``rate(at + horizon) / mean_rate`` under the current fit,
        clamped to [MIN_MULT, MAX_MULT]; exactly 1.0 while unfit.  The
        fit is refreshed lazily at most once per closed bin."""
        now_bin = int(self.clock() // self.bin_s)
        if self._fit is None or self._fit_at_bin != now_bin:
            self.fit()
        if self._fit is None:
            return 1.0
        a, b, c = self._fit
        t = (self.clock() if at is None else float(at)) \
            + float(horizon_s)
        w = 2.0 * math.pi / self.period_s
        rate = a + b * math.sin(w * t) + c * math.cos(w * t)
        if rate <= 0:
            return self.MIN_MULT
        return max(self.MIN_MULT, min(self.MAX_MULT, rate / a))

    def reset(self) -> None:
        self._bins.clear()
        self._fit = None
        self._fit_at_bin = None
