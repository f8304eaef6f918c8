"""Request traces, bucketed histograms and the ``/metrics`` exposition.

Counterpart of the request half of the JAX package's ``utils/telemetry.py``:

* **Traces.**  Every HTTP request gets a trace id; a span recorded anywhere
  below it (handler, batcher dispatcher, a lane thread rendering a group)
  lands on that request's trace through a ``contextvars`` context.  A lane
  thread renders a group under :func:`group_trace`, so its spans land on
  every member's trace.
* **Histograms.**  Fixed log-scale buckets (0.25 ms .. ~32.8 s), the JAX
  package's bounds, so the two packages' series align bucket for bucket.
* **Counters** of the front: sheds by reason and deadline cancellations
  (:class:`Resilience`), watchdog fires by action (:class:`WatchdogStats`),
  conditional-HTTP answers (:class:`HttpCacheStats`), the mask, overlay
  and animation routes (:class:`WorkloadStats`).
* **The cost ledger.**  Each trace accumulates numeric costs
  (:meth:`Trace.add_cost`, :func:`add_cost`, :func:`add_costs`) written
  by the layer that did the work: the batcher's device-execute and stage
  ms shared pro rata over a group, the raw cache's staged bytes.
  :func:`assemble_ledger` merges them with the span-derived fields when
  the request finishes; :func:`observe_request_cost` feeds the per-route
  ``imageregion_request_cost_*`` histograms (:data:`COST_HISTS`), and
  :data:`COST_TOPK` keeps the most expensive recent requests.  The
  access log (``server.app``) writes them on its JSON line.
* **Provenance counters** (:class:`ProvenanceStats`): responses by byte
  source tier and member, and routing flags, over the closed vocabularies
  of ``utils.provenance``.
* **Readiness** (:data:`READINESS`): the startup prewarm's state behind
  ``/readyz`` (``server.prewarm``).
* **The flight recorder** (:data:`FLIGHT`): a bounded ring of structured
  events (sheds, formed groups, watchdog fires, pyramid steps, cache
  evictions, warm-state snapshots, build-store loads) that dumps to
  ``telemetry.flight-recorder-dir`` on SIGTERM (``server.shutdown``) or on
  ``/debug/flightrecorder?dump=1``.
* **Warm-state persistence** (:data:`PERSIST`): the disk byte tier's
  writes, drops and corrupt entries (``services.diskcache``), the
  manifest snapshots and the boot rehydrate's progress
  (``services.warmstate``), and the build store's corrupt entries
  (``server.execcache``).
* **The forensics plane**: exemplars on the request-duration buckets
  (:func:`exemplars_snapshot`, and OpenMetrics tails on a negotiated
  scrape), the SLO engine (:data:`SLO`, whose breach dumps the flight
  recorder), the per-shape device cost (:data:`SHAPE_COSTS`), slow-request
  waterfalls (:func:`dump_slow_trace`), ``torch.profiler`` captures
  (:func:`capture_profile`), and the control plane's accounting: the
  pressure governor (:data:`PRESSURE`), the decision ledger
  (:data:`DECISIONS`) and the perf sentinel (:data:`SENTINEL`).
* **The exposition**: :func:`request_metric_lines`, :func:`span_lines`
  (``utils.stopwatch``), :func:`resilience_metric_lines`,
  :func:`device_metric_lines`, :func:`cost_metric_lines`, joined by
  :func:`finalize_exposition`, which writes one ``# TYPE`` header per
  family (and, with ``openmetrics``, the strict OpenMetrics form).

The family names, label keys and types are the JAX package's, so one
dashboard and one cardinality budget (``conf/metrics_budget.json``) read
both.  Not ported: ``imageregion_compile_*`` and ``imageregion_link_*``
(XLA compile events and TPU-link fetch rates: an eager CUDA launch has no
compile step, and the card sits on PCIe in the same host).  The
federation's (``parallel.federation``) are here: :data:`FEDERATION`
(manifest, agreements, gossip, ``shard_transfer`` planes), :data:`QUORUM`
(the quorum verdict, fence refusals, injected link partitions),
:data:`FED_SLO` (the fleet SLO burn over peers' gossiped SLO buckets) and
the gossiped sentinel rows (:meth:`SentinelStats.ingest`).  The fleet's are here
(``parallel.fleet``): :data:`FLEET` (routed, stolen and failed-over renders
by member), :data:`HOTKEY` (hot-plane replication), :data:`DRAIN` (drain
states and the handoff's planes), the peer byte fetch's counters in
:data:`HTTPCACHE`, :func:`fleet_metric_lines` (with a live router, the
per-member gauges) and the flight recorder's member stamp
(:meth:`FlightRecorder.set_member`, set by a sidecar's ``hello``).  The
elastic control plane's: :data:`AUTOSCALER` (``server.autoscaler``: members
active, the floor and ceiling, transitions, refusals) in the resilience
families, and :data:`LOADMODEL` (``services.loadmodel``: arrivals offered,
completed, shed and late) in the session families, as in JAX.  The shape-cost estimate is the port's own
kernel count, not XLA's ``cost_analysis()`` (:class:`ShapeCostModel`).

Nothing here imports ``torch`` at module level (:func:`capture_profile`
imports ``torch.profiler`` when called).
"""

from __future__ import annotations

import contextvars
import itertools
import json
import logging
import os
import threading
import time
import uuid
from bisect import bisect_left
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Mapping, Optional, Tuple

log = logging.getLogger("omero_ms_image_region_tpu_torch.telemetry")

# Fixed log-scale bucket bounds (ms): 0.25 ms .. ~32.8 s, ratio 2.
BUCKET_BOUNDS_MS: Tuple[float, ...] = tuple(0.25 * 2 ** i
                                            for i in range(18))


def _fmt(v: float) -> str:
    return "%g" % v


class Histogram:
    """Cumulative log-bucket histogram (not thread-safe on its own; the
    owner holds its lock around :meth:`add`).

    With ``exemplars=True`` each bucket also keeps its most recent
    observation's exemplar, ``(trace_id, tier)`` from the caller, written
    as one list-slot assignment, and :meth:`series` can write them in
    OpenMetrics exemplar syntax: the p99 bucket then names a trace."""

    __slots__ = ("bounds", "counts", "sum", "count", "exemplars")

    def __init__(self, bounds: Tuple[float, ...] = BUCKET_BOUNDS_MS,
                 exemplars: bool = False):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)     # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        # bucket index -> (trace_id, tier, value, wall ts) or None.
        self.exemplars = ([None] * (len(bounds) + 1) if exemplars
                          else None)

    def add(self, value: float,
            exemplar: Optional[Tuple[str, str]] = None) -> None:
        self.sum += value
        self.count += 1
        idx = bisect_left(self.bounds, value)
        self.counts[idx] += 1
        if self.exemplars is not None and exemplar is not None:
            # Last writer wins: the bucket's most recent trace.
            self.exemplars[idx] = (exemplar[0], exemplar[1], value,
                                   time.time())

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-resolution estimate: the upper bound of the bucket that
        holds the q-th sample."""
        if not self.count:
            return 0.0
        target = max(1, int(q * self.count + 0.5))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return (self.bounds[i] if i < len(self.bounds)
                        else self.bounds[-1] * 2)
        return self.bounds[-1] * 2

    def _exemplar_suffix(self, idx: int, enabled: bool) -> str:
        """The OpenMetrics exemplar tail of one bucket line, ``# {trace_id=
        ..,tier=..} value ts`` (empty without one, or on a plain scrape)."""
        if not enabled or self.exemplars is None:
            return ""
        ex = self.exemplars[idx]
        if ex is None:
            return ""
        trace_id, tier, value, ts = ex
        return (f' # {{trace_id="{trace_id}",tier="{tier}"}} '
                f"{round(value, 3)} {round(ts, 3)}")

    def series(self, name: str, labels: str = "",
               exemplars: bool = False) -> List[str]:
        """``_bucket``/``_sum``/``_count`` lines; ``labels`` is the inner
        label body without braces, ``le`` composes after it.
        ``exemplars`` adds the exemplar tails: only for a scrape that asked
        for ``application/openmetrics-text`` (the plain text parser refuses
        them)."""
        sep = "," if labels else ""
        cum = self.cumulative()
        lines = [f'{name}_bucket{{{labels}{sep}le="{_fmt(b)}"}} {c}'
                 f"{self._exemplar_suffix(i, exemplars)}"
                 for i, (b, c) in enumerate(zip(self.bounds, cum))]
        lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {cum[-1]}'
                     f"{self._exemplar_suffix(len(self.bounds), exemplars)}")
        suffix = f"{{{labels}}}" if labels else ""
        lines.append(f"{name}_sum{suffix} {round(self.sum, 3)}")
        lines.append(f"{name}_count{suffix} {self.count}")
        return lines

    def exemplar_docs(self) -> List[dict]:
        """The live exemplars as JSON documents (``/debug/exemplars``):
        bucket upper bound, trace, tier, value and time."""
        if self.exemplars is None:
            return []
        docs = []
        for i, ex in enumerate(list(self.exemplars)):
            if ex is None:
                continue
            le = (_fmt(self.bounds[i]) if i < len(self.bounds)
                  else "+Inf")
            docs.append({"le": le, "trace": ex[0], "tier": ex[1],
                         "value_ms": round(ex[2], 3),
                         "ts": round(ex[3], 3)})
        return docs


class HistogramVec:
    """Thread-safe histogram family keyed by one label value."""

    def __init__(self, label: str, exemplars: bool = False):
        self.label = label
        self.exemplars = exemplars
        self._lock = threading.Lock()
        self._hists: Dict[str, Histogram] = {}

    def observe(self, label_value: str, value: float,
                exemplar: Optional[Tuple[str, str]] = None) -> None:
        with self._lock:
            h = self._hists.get(label_value)
            if h is None:
                h = self._hists[label_value] = Histogram(
                    exemplars=self.exemplars)
            h.add(value, exemplar=exemplar)

    def get(self, label_value: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(label_value)

    def series(self, name: str, exemplars: bool = False) -> List[str]:
        with self._lock:
            lines = []
            for lv, h in sorted(self._hists.items()):
                lines += h.series(name, f'{self.label}="{lv}"',
                                  exemplars=exemplars)
            return lines

    def exemplar_docs(self) -> Dict[str, List[dict]]:
        """{label value: [bucket exemplar documents]}."""
        with self._lock:
            items = sorted(self._hists.items())
        return {lv: docs for lv, h in items
                if (docs := h.exemplar_docs())}

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


# End-to-end request latency by route, and request totals by status.  The
# latency buckets keep exemplars: each names the last trace id (and its
# provenance tier) that landed in it.
REQUEST_HIST = HistogramVec("route", exemplars=True)
_REQ_LOCK = threading.Lock()
_REQ_TOTALS: Dict[tuple, int] = {}


def count_request(route: str, status: int) -> None:
    with _REQ_LOCK:
        key = (route, int(status))
        _REQ_TOTALS[key] = _REQ_TOTALS.get(key, 0) + 1


def request_totals() -> Dict[tuple, int]:
    with _REQ_LOCK:
        return dict(_REQ_TOTALS)


# ------------------------------------------------------------------ traces

def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class Trace:
    """One request's spans: ``{"name", "start_ms", "dur_ms"}`` dicts, with
    ``start_ms`` relative to the trace's start; and its cost ledger,
    numeric accumulators written under ``lock`` by the layers that did
    the work (batcher lane threads, the raw cache)."""

    __slots__ = ("trace_id", "route", "t0", "wall_ts", "spans", "costs",
                 "lock")

    def __init__(self, trace_id: str, route: str = ""):
        self.trace_id = trace_id
        self.route = route
        self.t0 = time.perf_counter()
        self.wall_ts = time.time()
        self.spans: List[dict] = []
        self.costs: Dict[str, float] = {}
        self.lock = threading.Lock()

    def add_cost(self, key: str, value: float) -> None:
        with self.lock:
            self.costs[key] = self.costs.get(key, 0.0) + float(value)

    def add_costs(self, items: Mapping[str, float]) -> None:
        """Several ledger fields under one lock acquisition (a group
        flushes its fields at once)."""
        with self.lock:
            costs = self.costs
            for key, value in items.items():
                costs[key] = costs.get(key, 0.0) + float(value)

    def export_costs(self) -> Dict[str, float]:
        """A copy of the ledger."""
        with self.lock:
            return dict(self.costs)

    def export_spans(self) -> List[dict]:
        """A copy of the spans (plain JSON dicts, ``start_ms`` relative to
        this trace's start): what a sidecar sends back on the wire."""
        return [dict(s) for s in list(self.spans)]

    def add_span(self, name: str, t_start: float, dur_ms: float,
                 **meta) -> None:
        """``meta`` (a federation hop's ``host``, ``member``, ``kind``)
        rides on the span's dict."""
        span = {"name": name,
                "start_ms": round((t_start - self.t0) * 1e3, 3),
                "dur_ms": round(dur_ms, 3)}
        if meta:
            span.update(meta)
        # list.append is atomic under the GIL; readers copy the list first.
        self.spans.append(span)

    def span_ms(self, *names: str) -> Optional[float]:
        """Total duration of the spans with one of the exact ``names``
        (None when the request never reached those stages)."""
        total, seen = 0.0, False
        for s in list(self.spans):
            if s["name"] in names:
                total += s["dur_ms"]
                seen = True
        return total if seen else None

    def to_json(self, total_ms: Optional[float] = None,
                status: Optional[int] = None) -> dict:
        """The waterfall document (the JAX ``Trace.to_json``): spans by
        start, the cost ledger, the wall time and the status."""
        spans = sorted(list(self.spans), key=lambda s: s["start_ms"])
        with self.lock:
            costs = dict(self.costs)
        doc = {"trace_id": self.trace_id, "route": self.route,
               "ts": self.wall_ts, "spans": spans}
        if costs:
            doc["cost"] = {k: round(v, 3) for k, v in costs.items()}
        if total_ms is not None:
            doc["total_ms"] = round(total_ms, 3)
        if status is not None:
            doc["status"] = status
        return doc


class TraceRegistry:
    """Active traces by id, bounded, and the most recent finished ones.

    A span may arrive after its request finished: a lane thread records
    its group's execute span when the group ends, and a JPEG request is
    answered as soon as its own tile is coded.  Such a span lands on the
    finished trace while it is among the recent ones.  (The JAX registry
    opens a new, orphan trace for it instead.)"""

    def __init__(self, max_active: int = 4096, recent: int = 64):
        self._lock = threading.Lock()
        self._active: Dict[str, Trace] = {}
        self._max_active = max_active
        self._recent: "OrderedDict[str, Trace]" = OrderedDict()
        self._max_recent = recent

    def _evict(self) -> None:
        while len(self._active) > self._max_active:
            self._active.pop(next(iter(self._active)))

    def start(self, trace_id: str, route: str = "") -> Trace:
        trace = Trace(trace_id, route)
        with self._lock:
            self._active[trace_id] = trace
            self._evict()
        return trace

    def get_or_create(self, trace_id: str) -> Trace:
        trace = self._active.get(trace_id)     # GIL-atomic fast path
        if trace is not None:
            return trace
        with self._lock:
            trace = (self._active.get(trace_id)
                     or self._recent.get(trace_id))
            if trace is None:
                trace = self._active[trace_id] = Trace(trace_id)
                self._evict()
            return trace

    def is_active(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._active

    def finish(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            trace = self._active.pop(trace_id, None)
            if trace is not None:
                self._recent[trace_id] = trace
                while len(self._recent) > self._max_recent:
                    self._recent.popitem(last=False)
        return trace

    def recent(self) -> List[Trace]:
        """The most recent finished traces, oldest first."""
        with self._lock:
            return list(self._recent.values())

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._recent.clear()


TRACES = TraceRegistry()

# The trace ids the current execution context works for: one for a
# request, every member's for a lane thread rendering a group.
_TRACE_IDS: contextvars.ContextVar[Tuple[str, ...]] = \
    contextvars.ContextVar("imageregion_trace_ids", default=())

# Values recorded through the stopwatch registry that are not durations.
_NON_SPAN_NAMES = frozenset({"batcher.groupTiles"})


def current_trace_id() -> Optional[str]:
    ids = _TRACE_IDS.get()
    return ids[0] if ids else None


def current_trace_ids() -> Tuple[str, ...]:
    """Every trace id the current context records for (the fleet router
    captures them at enqueue and re-adopts them in its lane)."""
    return _TRACE_IDS.get()


def clear_context() -> None:
    """Detach the current context from any trace.  A long-lived task
    spawned inside a request (the batcher's dispatcher loops) calls this,
    or every span it records would land on the spawning request."""
    _TRACE_IDS.set(())


@contextmanager
def trace_scope(trace_id: str, route: str = ""):
    """One request's root scope: registers the trace and makes it the
    context's recording target; the caller finishes it."""
    trace = TRACES.start(trace_id, route)
    token = _TRACE_IDS.set((trace_id,))
    try:
        yield trace
    finally:
        _TRACE_IDS.reset(token)


@contextmanager
def adopt_trace(trace_id: Optional[str]):
    """Join an existing trace (the sidecar's side of the wire): spans
    recorded inside land on ``trace_id``'s waterfall.  No-op for None."""
    if not trace_id:
        yield None
        return
    trace = TRACES.get_or_create(trace_id)
    token = _TRACE_IDS.set((trace_id,))
    try:
        yield trace
    finally:
        _TRACE_IDS.reset(token)


@contextmanager
def group_trace(trace_ids: Tuple[str, ...]):
    """Recording target of a lane thread rendering a group: its spans land
    on every member's trace."""
    token = _TRACE_IDS.set(tuple(trace_ids))
    try:
        yield
    finally:
        _TRACE_IDS.reset(token)


def record_span(name: str, t_start: float, dur_ms: float,
                trace_ids: Optional[Tuple[str, ...]] = None,
                **meta) -> None:
    """Attach a span to ``trace_ids`` (default: the context's traces)."""
    ids = trace_ids if trace_ids is not None else _TRACE_IDS.get()
    for tid in ids:
        TRACES.get_or_create(tid).add_span(name, t_start, dur_ms, **meta)


def observe_span(name: str, dur_ms: float) -> None:
    """The stopwatch registry's hook: a recorded stage duration becomes a
    span on the context's traces."""
    if name in _NON_SPAN_NAMES:
        return
    ids = _TRACE_IDS.get()
    if ids:
        record_span(name, time.perf_counter() - dur_ms / 1000.0, dur_ms,
                    trace_ids=ids)


def add_cost(key: str, value: float,
             trace_ids: Optional[Tuple[str, ...]] = None) -> None:
    """Accumulate a cost onto the context's trace ledger(s).  Pro-rata
    shares are the caller's: a lane thread rendering a group under
    :func:`group_trace` passes its execute ms over the group size, and
    every member's ledger gets that share.  No-op outside a trace
    (prefetch, prewarm)."""
    ids = trace_ids if trace_ids is not None else _TRACE_IDS.get()
    for tid in ids:
        TRACES.get_or_create(tid).add_cost(key, value)


def merge_costs(trace_id: str, costs: Mapping[str, float]) -> None:
    """Add a ledger sent back by the sidecar onto a trace (a malformed
    field is dropped)."""
    trace = TRACES.get_or_create(trace_id)
    for key, value in costs.items():
        try:
            trace.add_cost(str(key), float(value))
        except (TypeError, ValueError):
            pass


def add_costs(items: Mapping[str, float],
              trace_ids: Optional[Tuple[str, ...]] = None) -> None:
    """:func:`add_cost` of a whole mapping, one lock per trace."""
    ids = trace_ids if trace_ids is not None else _TRACE_IDS.get()
    if not ids or not items:
        return
    for tid in ids:
        TRACES.get_or_create(tid).add_costs(items)


# ------------------------------------------------------------ cost ledger

# Per-route cost histograms: one family per ledger field.  Byte fields
# are observed in KB so the fixed ms-scale log buckets still resolve them.
_COST_HIST_FIELDS = {
    "device_ms": "imageregion_request_cost_device_ms",
    "read_ms": "imageregion_request_cost_read_ms",
    "stage_ms": "imageregion_request_cost_stage_ms",
    "queue_ms": "imageregion_request_cost_queue_ms",
    "encode_ms": "imageregion_request_cost_encode_ms",
    "staged_kb": "imageregion_request_cost_staged_kb",
    "wire_kb": "imageregion_request_cost_wire_kb",
}

COST_HISTS: Dict[str, HistogramVec] = {
    f: HistogramVec("route") for f in _COST_HIST_FIELDS}


class CostTopK:
    """Bounded ledger of the most expensive recent requests (by wall
    ``total_ms``), evicting the cheapest.  Thread-safe."""

    def __init__(self, k: int = 16):
        self.k = k
        self._lock = threading.Lock()
        self._entries: List[dict] = []   # sorted descending by total_ms
        self.observed = 0

    def offer(self, doc: dict) -> None:
        score = float(doc.get("total_ms") or 0.0)
        with self._lock:
            self.observed += 1
            if (len(self._entries) >= self.k and score <= float(
                    self._entries[-1].get("total_ms") or 0.0)):
                return
            self._entries.append(doc)
            self._entries.sort(key=lambda d: -(d.get("total_ms") or 0.0))
            del self._entries[self.k:]

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self._entries]

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self.observed = 0


COST_TOPK = CostTopK()


def assemble_ledger(trace: Trace, total_ms: float,
                    nbytes: int) -> Tuple[Dict[str, float], str]:
    """(ledger, cache class) of a finished request: the accumulated costs
    with the span-derived fields (queue wait, read, encode), the response
    size and the wall time.  The cache class is where the bytes came
    from: ``byte-cache`` (no pipeline ran), ``coalesced`` (a
    single-flight follower), else ``render``."""
    ledger = trace.export_costs()
    queue_ms = trace.span_ms("batcher.queueWait")
    if queue_ms is not None:
        ledger["queue_ms"] = round(queue_ms, 3)
    read_ms = trace.span_ms("PixelsService.readRegion")
    if read_ms is not None:
        ledger["read_ms"] = round(read_ms, 3)
    encode_ms = trace.span_ms("encodeImage", "jfif.encodeBatch")
    if encode_ms is not None:
        ledger["encode_ms"] = round(encode_ms, 3)
    ledger["wire_bytes"] = int(nbytes)
    ledger["total_ms"] = round(total_ms, 3)
    if trace.span_ms("cache.hit") is not None:
        cache_class = "byte-cache"
    elif trace.span_ms("dedup.coalesced") is not None:
        cache_class = "coalesced"
    else:
        cache_class = "render"
    return ledger, cache_class


def observe_request_cost(route: str, ledger: Dict[str, float]) -> None:
    """Feed the per-route cost histograms from a finished ledger."""
    for name, hist in COST_HISTS.items():
        if name == "staged_kb":
            value = ledger.get("staged_bytes")
        elif name == "wire_kb":
            value = ledger.get("wire_bytes")
        else:
            value = ledger.get(name)
        if value is None:
            continue
        if name.endswith("_kb"):
            value = float(value) / 1024.0
        hist.observe(route, float(value))


def cost_metric_lines() -> List[str]:
    """The cost histograms and the provenance counters."""
    lines: List[str] = []
    for name, hist in COST_HISTS.items():
        lines += hist.series(_COST_HIST_FIELDS[name])
    return lines + PROVENANCE.metric_lines()


# -------------------------------------------------------------- counters

class Resilience:
    """Sheds by reason, deadline cancellations, the sidecar client's
    retries and attempts by op, degraded renders and supervisor restarts
    (thread-safe: the batcher's dispatcher, the admission controller and
    the supervisor's thread all count here)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.shed: Dict[str, int] = {}
        self.retries: Dict[str, int] = {}
        self.deadline_cancelled = 0
        self.degraded_renders = 0
        self.supervisor_restarts = 0
        # Attempts a sidecar call took, by op.
        self.attempts_hist = HistogramVec("op")

    def count_shed(self, reason: str = "queue-full") -> None:
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1

    def count_retry(self, op: str) -> None:
        with self._lock:
            self.retries[op] = self.retries.get(op, 0) + 1

    def count_deadline_cancelled(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_cancelled += n

    def count_degraded_render(self) -> None:
        with self._lock:
            self.degraded_renders += 1

    def count_supervisor_restart(self) -> None:
        with self._lock:
            self.supervisor_restarts += 1

    def observe_attempts(self, op: str, attempts: int) -> None:
        self.attempts_hist.observe(op, float(attempts))

    def reset(self) -> None:
        with self._lock:
            self.shed.clear()
            self.retries.clear()
            self.deadline_cancelled = 0
            self.degraded_renders = 0
            self.supervisor_restarts = 0
        self.attempts_hist.reset()


RESILIENCE = Resilience()


class WatchdogStats:
    """Watchdog fires by healing action (a closed vocabulary:
    requeue-group, escalate)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fires: Dict[str, int] = {}

    def count_fire(self, action: str) -> None:
        with self._lock:
            self.fires[action] = self.fires.get(action, 0) + 1

    def totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.fires)

    def metric_lines(self) -> List[str]:
        with self._lock:
            return [f'imageregion_watchdog_fires_total{{action="{a}"}} '
                    f"{self.fires[a]}" for a in sorted(self.fires)]

    def reset(self) -> None:
        with self._lock:
            self.fires.clear()


WATCHDOG = WatchdogStats()


class WireStats:
    """The sidecar wire v3's accounting: vectored flushes, the shared-memory
    ring, ring negotiations and chunk streams (thread-safe)."""

    _FIELDS = ("flushes", "frames_flushed", "flush_bytes", "ring_hits",
               "ring_fallbacks", "ring_bytes", "ring_negotiated",
               "ring_declined", "streams", "chunks")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def observe_flush(self, frames: int, nbytes: int) -> None:
        with self._lock:
            self.flushes += 1
            self.frames_flushed += int(frames)
            self.flush_bytes += int(nbytes)

    def count_ring(self, nbytes: int, hit: bool) -> None:
        with self._lock:
            if hit:
                self.ring_hits += 1
                self.ring_bytes += int(nbytes)
            else:
                self.ring_fallbacks += 1

    def count_negotiation(self, ring: bool) -> None:
        with self._lock:
            if ring:
                self.ring_negotiated += 1
            else:
                self.ring_declined += 1

    def count_stream(self, chunks: int) -> None:
        with self._lock:
            self.streams += 1
            self.chunks += int(chunks)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}

    def metric_lines(self) -> List[str]:
        with self._lock:
            fpf = (self.frames_flushed / self.flushes
                   if self.flushes else 0.0)
            return [
                f"imageregion_wire_flushes_total {self.flushes}",
                f"imageregion_wire_frames_total {self.frames_flushed}",
                f"imageregion_wire_flush_bytes_total {self.flush_bytes}",
                f"imageregion_wire_frames_per_flush {round(fpf, 3)}",
                f"imageregion_wire_ring_hits_total {self.ring_hits}",
                "imageregion_wire_ring_fallbacks_total "
                f"{self.ring_fallbacks}",
                f"imageregion_wire_ring_bytes_total {self.ring_bytes}",
                "imageregion_wire_ring_negotiated_total "
                f"{self.ring_negotiated}",
                "imageregion_wire_ring_declined_total "
                f"{self.ring_declined}",
                f"imageregion_wire_streams_total {self.streams}",
                f"imageregion_wire_chunks_total {self.chunks}",
            ]

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0)


WIRE = WireStats()


class _MemberCounts:
    """Per-member counters with the JAX bound on distinct member names
    (``_overflow`` past it): names come from config, the bound guards
    against a caller minting names per request."""

    _MAX_MEMBERS = 64

    def __init__(self):
        self._lock = threading.Lock()

    def _bump(self, table: Dict[str, int], member: str, n: int = 1) -> None:
        with self._lock:
            if member not in table and len(table) >= self._MAX_MEMBERS:
                member = "_overflow"
            table[member] = table.get(member, 0) + n


class FleetStats(_MemberCounts):
    """The fleet router's renders by member: routed (at dispatch), stolen
    (by the thief, which renders without adopting the plane) and failed
    over (by the hash-ring-next member that adopted a dead or draining
    member's work)."""

    def __init__(self):
        super().__init__()
        self.routed: Dict[str, int] = {}
        self.stolen: Dict[str, int] = {}
        self.failed_over: Dict[str, int] = {}

    def count_routed(self, member: str) -> None:
        self._bump(self.routed, member)

    def count_stolen(self, member: str) -> None:
        self._bump(self.stolen, member)

    def count_failed_over(self, member: str) -> None:
        self._bump(self.failed_over, member)

    def totals(self) -> Dict[str, int]:
        with self._lock:
            return {"routed": sum(self.routed.values()),
                    "stolen": sum(self.stolen.values()),
                    "failed_over": sum(self.failed_over.values())}

    def metric_lines(self) -> List[str]:
        lines: List[str] = []
        with self._lock:
            for fam, table in (
                    ("imageregion_fleet_routed_total", self.routed),
                    ("imageregion_fleet_stolen_total", self.stolen),
                    ("imageregion_fleet_failed_over_total",
                     self.failed_over)):
                lines += [f'{fam}{{member="{m}"}} {table[m]}'
                          for m in sorted(table)]
        return lines

    def reset(self) -> None:
        with self._lock:
            self.routed.clear()
            self.stolen.clear()
            self.failed_over.clear()


FLEET = FleetStats()


class HotkeyStats(_MemberCounts):
    """Hot-plane replication: promotions, demotions, replica planes
    staged, the never-double-stage counter (held at 0), balanced reads by
    the non-owner replica that served them, and the hot-route and
    replica-pressure gauges (the latter the autoscaler's signal, set by
    ``FleetRouter.replica_pressure``)."""

    def __init__(self):
        super().__init__()
        self.promoted = 0
        self.demoted = 0
        self.staged = 0
        self.duplicate_staged = 0
        self.balanced: Dict[str, int] = {}
        self.hot_routes = 0
        self.replica_pressure = 0.0

    def _add(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def count_promoted(self) -> None:
        self._add("promoted")

    def count_demoted(self) -> None:
        self._add("demoted")

    def count_staged(self, n: int = 1) -> None:
        self._add("staged", int(n))

    def count_duplicate_staged(self) -> None:
        self._add("duplicate_staged")

    def count_balanced(self, member: str) -> None:
        self._bump(self.balanced, member)

    def set_hot_routes(self, n: int) -> None:
        with self._lock:
            self.hot_routes = int(n)

    def set_pressure(self, value: float) -> None:
        with self._lock:
            self.replica_pressure = float(value)

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return {"promoted": self.promoted, "demoted": self.demoted,
                    "staged": self.staged,
                    "duplicate_staged": self.duplicate_staged,
                    "balanced": sum(self.balanced.values()),
                    "hot_routes": self.hot_routes,
                    "replica_pressure": self.replica_pressure}

    def metric_lines(self) -> List[str]:
        with self._lock:
            if not (self.promoted or self.demoted or self.staged
                    or self.duplicate_staged or self.balanced
                    or self.hot_routes or self.replica_pressure):
                return []          # the tier never engaged: no series
            return [
                f"imageregion_hotkey_promotions_total {self.promoted}",
                f"imageregion_hotkey_demotions_total {self.demoted}",
                f"imageregion_hotkey_replica_staged_total {self.staged}",
                "imageregion_hotkey_duplicate_staged_total "
                f"{self.duplicate_staged}",
                f"imageregion_hotkey_hot_routes {self.hot_routes}",
                "imageregion_hotkey_replica_pressure "
                f"{self.replica_pressure:.3f}",
            ] + [f'imageregion_hotkey_balanced_total{{member="{m}"}} '
                 f"{self.balanced[m]}" for m in sorted(self.balanced)]

    def reset(self) -> None:
        with self._lock:
            self.promoted = self.demoted = 0
            self.staged = self.duplicate_staged = 0
            self.balanced.clear()
            self.hot_routes = 0
            self.replica_pressure = 0.0


HOTKEY = HotkeyStats()


class DrainStats(_MemberCounts):
    """Rolling drains: each member's state (0 active, 1 draining, 2
    drained), its transitions, the handoff's prestaged planes and the
    drains finished."""

    STATES = ("active", "draining", "drained")

    def __init__(self):
        super().__init__()
        self.state: Dict[str, int] = {}
        self.transitions: Dict[str, int] = {}
        self.prestaged_planes = 0
        self.drains_total = 0

    def set_state(self, member: str, state: str) -> None:
        idx = self.STATES.index(state)
        with self._lock:
            if member not in self.state \
                    and len(self.state) >= self._MAX_MEMBERS:
                member = "_overflow"
            if self.state.get(member) != idx:
                self.transitions[member] = \
                    self.transitions.get(member, 0) + 1
            self.state[member] = idx
            if state == "drained":
                self.drains_total += 1

    def count_prestaged(self, n: int) -> None:
        with self._lock:
            self.prestaged_planes += n

    def metric_lines(self) -> List[str]:
        with self._lock:
            return ([
                "imageregion_drain_prestaged_planes_total "
                f"{self.prestaged_planes}",
                f"imageregion_drains_total {self.drains_total}"]
                + [f'imageregion_drain_state{{member="{m}"}} '
                   f"{self.state[m]}" for m in sorted(self.state)]
                + [f'imageregion_drain_transitions_total{{member="{m}"}} '
                   f"{self.transitions[m]}"
                   for m in sorted(self.transitions)])

    def reset(self) -> None:
        with self._lock:
            self.state.clear()
            self.transitions.clear()
            self.prestaged_planes = 0
            self.drains_total = 0


DRAIN = DrainStats()


class AutoscalerStats:
    """The elastic autoscaler (``server.autoscaler``): the active-member
    gauge and the floor and ceiling, transitions by direction and refused
    decisions by reason.  Both label sets are closed: ``action`` is up or
    down, ``reason`` one of ``autoscaler.BLOCKED_REASONS``.  Quiet until
    an autoscaler is live."""

    def __init__(self):
        self._lock = threading.Lock()
        self.active = 0
        self.floor = 0
        self.ceiling = 0
        self.transitions: Dict[str, int] = {}
        self.blocked: Dict[str, int] = {}

    def set_active(self, n: int) -> None:
        with self._lock:
            self.active = int(n)

    def set_bounds(self, floor: int, ceiling: int) -> None:
        with self._lock:
            self.floor = int(floor)
            self.ceiling = int(ceiling)

    def count_transition(self, action: str) -> None:
        with self._lock:
            self.transitions[action] = self.transitions.get(action, 0) + 1

    def count_blocked(self, reason: str) -> None:
        with self._lock:
            self.blocked[reason] = self.blocked.get(reason, 0) + 1

    def metric_lines(self) -> List[str]:
        with self._lock:
            if not (self.active or self.transitions or self.blocked):
                return []
            return ([
                f"imageregion_autoscaler_active_members {self.active}",
                f"imageregion_autoscaler_floor {self.floor}",
                f"imageregion_autoscaler_ceiling {self.ceiling}"]
                + [f'imageregion_autoscaler_transitions_total'
                   f'{{action="{a}"}} {self.transitions[a]}'
                   for a in sorted(self.transitions)]
                + [f'imageregion_autoscaler_blocked_total'
                   f'{{reason="{r}"}} {self.blocked[r]}'
                   for r in sorted(self.blocked)])

    def reset(self) -> None:
        with self._lock:
            self.active = self.floor = self.ceiling = 0
            self.transitions.clear()
            self.blocked.clear()


AUTOSCALER = AutoscalerStats()


class LoadModelStats:
    """The open-loop load model (``services.loadmodel``): arrivals offered
    and completed by request class (the closed ``loadmodel.CLASSES``),
    sheds, and arrivals fired behind schedule (the open-loop integrity
    counter).  Quiet until a process replays arrivals."""

    def __init__(self):
        self._lock = threading.Lock()
        self.offered: Dict[str, int] = {}
        self.completed: Dict[str, int] = {}
        self.sheds = 0
        self.late = 0

    def count_offered(self, cls: str) -> None:
        with self._lock:
            self.offered[cls] = self.offered.get(cls, 0) + 1

    def count_completed(self, cls: str) -> None:
        with self._lock:
            self.completed[cls] = self.completed.get(cls, 0) + 1

    def count_shed(self) -> None:
        with self._lock:
            self.sheds += 1

    def count_late(self) -> None:
        with self._lock:
            self.late += 1

    def metric_lines(self) -> List[str]:
        with self._lock:
            if not (self.offered or self.sheds or self.late):
                return []
            return ([f"imageregion_loadmodel_shed_total {self.sheds}",
                     f"imageregion_loadmodel_late_fires_total {self.late}"]
                    + [f'imageregion_loadmodel_offered_total'
                       f'{{class="{c}"}} {self.offered[c]}'
                       for c in sorted(self.offered)]
                    + [f'imageregion_loadmodel_completed_total'
                       f'{{class="{c}"}} {self.completed[c]}'
                       for c in sorted(self.completed)])

    def reset(self) -> None:
        with self._lock:
            self.offered.clear()
            self.completed.clear()
            self.sheds = self.late = 0


LOADMODEL = LoadModelStats()


class HttpCacheStats:
    """Conditional-HTTP answers (If-None-Match and If-Modified-Since-only
    arrivals, 304s and renderless HEADs) and the fleet's peer byte tier
    (``parallel.fleet``: the authority's probes, hits, fetched bodies,
    failed fetches and a thief's write-backs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.etag_requests = 0
        self.ims_requests = 0
        self.not_modified = 0
        self.head = 0
        self.peer_probes = 0
        self.peer_hits = 0
        self.peer_fetches = 0
        self.peer_fallbacks = 0
        self.peer_putbacks = 0

    def _bump(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def count_etag_request(self) -> None:
        self._bump("etag_requests")

    def count_ims_request(self) -> None:
        self._bump("ims_requests")

    def count_not_modified(self) -> None:
        self._bump("not_modified")

    def count_head(self) -> None:
        self._bump("head")

    def count_peer_probe(self) -> None:
        self._bump("peer_probes")

    def count_peer_hit(self) -> None:
        self._bump("peer_hits")

    def count_peer_fetch(self) -> None:
        self._bump("peer_fetches")

    def count_peer_fallback(self) -> None:
        self._bump("peer_fallbacks")

    def count_peer_putback(self) -> None:
        self._bump("peer_putbacks")

    def metric_lines(self) -> List[str]:
        with self._lock:
            if not (self.etag_requests or self.ims_requests
                    or self.not_modified or self.head or self.peer_probes
                    or self.peer_fetches or self.peer_fallbacks
                    or self.peer_putbacks):
                return []          # quiet until a conditional arrives
            return [
                "imageregion_httpcache_etag_requests_total "
                f"{self.etag_requests}",
                "imageregion_httpcache_ims_requests_total "
                f"{self.ims_requests}",
                f"imageregion_httpcache_304_total {self.not_modified}",
                f"imageregion_httpcache_head_total {self.head}",
                f"imageregion_httpcache_peer_probes_total {self.peer_probes}",
                f"imageregion_httpcache_peer_hits_total {self.peer_hits}",
                "imageregion_httpcache_peer_fetches_total "
                f"{self.peer_fetches}",
                "imageregion_httpcache_peer_fallbacks_total "
                f"{self.peer_fallbacks}",
                "imageregion_httpcache_peer_putbacks_total "
                f"{self.peer_putbacks}",
            ]

    def reset(self) -> None:
        with self._lock:
            self.etag_requests = self.ims_requests = 0
            self.not_modified = self.head = 0
            self.peer_probes = self.peer_hits = self.peer_fetches = 0
            self.peer_fallbacks = self.peer_putbacks = 0


HTTPCACHE = HttpCacheStats()


class WorkloadStats:
    """The workload routes: requests by kind (a closed vocabulary:
    ``mask_device`` / ``mask_host``, the rasterizer that served a mask,
    ``overlay``, ``animation``), pyramid jobs by lifecycle action
    (``submitted``, ``resumed``, ``completed``, ``failed``, ``cancelled``),
    the jobs running and the levels committed, animation streams, frames
    and cancellations, and the last stream's first-frame latency."""

    REQUEST_KINDS = ("mask_device", "mask_host", "overlay", "animation")

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: Dict[str, int] = {}
        self.jobs: Dict[str, int] = {}
        self.jobs_active = 0
        self.levels_committed = 0
        self.streams = 0
        self.frames = 0
        self.stream_cancels = 0
        self.first_frame_ms: Optional[float] = None

    def count_request(self, kind: str) -> None:
        with self._lock:
            self.requests[kind] = self.requests.get(kind, 0) + 1

    def count_job(self, action: str) -> None:
        with self._lock:
            self.jobs[action] = self.jobs.get(action, 0) + 1

    def job_started(self) -> None:
        with self._lock:
            self.jobs_active += 1

    def job_finished(self) -> None:
        with self._lock:
            self.jobs_active = max(0, self.jobs_active - 1)

    def count_level_committed(self) -> None:
        with self._lock:
            self.levels_committed += 1

    def count_stream(self) -> None:
        with self._lock:
            self.streams += 1

    def count_frames(self, n: int = 1) -> None:
        with self._lock:
            self.frames += n

    def count_stream_cancelled(self) -> None:
        with self._lock:
            self.stream_cancels += 1

    def observe_first_frame_ms(self, ms: float) -> None:
        with self._lock:
            self.first_frame_ms = ms

    def metric_lines(self) -> List[str]:
        with self._lock:
            if not (self.requests or self.jobs or self.jobs_active
                    or self.levels_committed or self.streams):
                return []          # quiet until a workload request
            lines = [f'imageregion_workload_requests_total{{kind="{k}"}} '
                     f"{self.requests[k]}" for k in sorted(self.requests)]
            lines += [f'imageregion_pyramid_jobs_total{{action="{a}"}} '
                      f"{self.jobs[a]}" for a in sorted(self.jobs)]
            lines += [
                f"imageregion_pyramid_jobs_active {self.jobs_active}",
                "imageregion_pyramid_levels_committed_total "
                f"{self.levels_committed}",
                f"imageregion_animation_streams_total {self.streams}",
                f"imageregion_animation_frames_total {self.frames}",
                "imageregion_animation_cancelled_total "
                f"{self.stream_cancels}",
            ]
            if self.first_frame_ms is not None:
                lines.append("imageregion_animation_first_frame_ms "
                             f"{_fmt(self.first_frame_ms)}")
        return lines

    def reset(self) -> None:
        with self._lock:
            self.requests.clear()
            self.jobs.clear()
            self.jobs_active = self.levels_committed = 0
            self.streams = self.frames = self.stream_cancels = 0
            self.first_frame_ms = None


WORKLOADS = WorkloadStats()


class SessionStats:
    """The session model (``services.viewport``): the sessions the
    viewport tracker holds, the tile observations that fed it and its LRU
    evictions.  No per-session label: sessions are unbounded."""

    def __init__(self):
        self._lock = threading.Lock()
        self.tracked = 0
        self.observations = 0
        self.evicted = 0

    def set_tracked(self, n: int) -> None:
        with self._lock:
            self.tracked = int(n)

    def count_observation(self) -> None:
        with self._lock:
            self.observations += 1

    def count_evicted(self) -> None:
        with self._lock:
            self.evicted += 1

    def metric_lines(self) -> List[str]:
        with self._lock:
            return [f"imageregion_session_tracked {self.tracked}",
                    "imageregion_session_observations_total "
                    f"{self.observations}",
                    f"imageregion_session_evictions_total {self.evicted}"]

    def reset(self) -> None:
        with self._lock:
            self.tracked = self.observations = self.evicted = 0


SESSIONS = SessionStats()


class PrefetchStats:
    """Predictive prefetch (``services.prefetch``): predictions made, loads
    scheduled and staged, foreground hits on staged planes, skips by
    reason (a closed vocabulary: ``budget``, ``paused``) and the live
    budget scale the pressure governor sets."""

    def __init__(self):
        self._lock = threading.Lock()
        self.predicted = 0
        self.scheduled = 0
        self.staged = 0
        self.hits = 0
        self.skipped: Dict[str, int] = {}
        self.budget_scale = 1.0

    def count_predicted(self, n: int = 1) -> None:
        with self._lock:
            self.predicted += n

    def count_scheduled(self) -> None:
        with self._lock:
            self.scheduled += 1

    def count_staged(self) -> None:
        with self._lock:
            self.staged += 1

    def count_hit(self) -> None:
        with self._lock:
            self.hits += 1

    def count_skipped(self, reason: str) -> None:
        with self._lock:
            self.skipped[reason] = self.skipped.get(reason, 0) + 1

    def set_budget(self, scale: float) -> None:
        """The pressure governor's live prefetch budget scale."""
        with self._lock:
            self.budget_scale = float(scale)

    def metric_lines(self) -> List[str]:
        with self._lock:
            lines = [
                f"imageregion_prefetch_predicted_total {self.predicted}",
                f"imageregion_prefetch_scheduled_total {self.scheduled}",
                f"imageregion_prefetch_staged_total {self.staged}",
                f"imageregion_prefetch_hits_total {self.hits}",
                "imageregion_prefetch_budget_scale "
                f"{_fmt(self.budget_scale)}",
            ]
            lines += [f'imageregion_prefetch_skipped_total{{reason="{r}"}} '
                      f"{self.skipped[r]}" for r in sorted(self.skipped)]
        return lines

    def reset(self) -> None:
        with self._lock:
            self.predicted = self.scheduled = self.staged = self.hits = 0
            self.skipped.clear()
            self.budget_scale = 1.0


PREFETCH = PrefetchStats()


class QosStats:
    """Tiered-QoS accounting (the JAX ``QosStats``): the fairness sheds of
    ``server.admission`` by QoS class (``interactive`` or ``bulk``, the
    two values of ``pressure.is_bulk``).  The dequeue and jump counters
    are the fleet router's; they stay 0 until it is ported, and their
    lines appear only once counted, as in JAX."""

    CLASSES = ("interactive", "bulk")

    def __init__(self):
        self._lock = threading.Lock()
        self.shed: Dict[str, int] = {}
        self.dequeued: Dict[str, int] = {}
        self.jumps = 0

    def count_shed(self, cls: str) -> None:
        with self._lock:
            self.shed[cls] = self.shed.get(cls, 0) + 1

    def metric_lines(self) -> List[str]:
        with self._lock:
            lines = [f"imageregion_qos_interactive_jumps_total "
                     f"{self.jumps}"]
            lines += [f'imageregion_qos_shed_total{{class="{c}"}} '
                      f"{self.shed[c]}" for c in sorted(self.shed)]
            lines += [f'imageregion_qos_dequeued_total{{class="{c}"}} '
                      f"{self.dequeued[c]}" for c in sorted(self.dequeued)]
        return lines

    def reset(self) -> None:
        with self._lock:
            self.shed.clear()
            self.dequeued.clear()
            self.jumps = 0


QOS = QosStats()


class ProvenanceStats:
    """Responses by byte-source tier and serving member, and the routing
    flags (``utils.provenance``).  Both label sets are closed: ``tier``
    is ``provenance.TIERS`` (a drifted tier counts as ``render_cold``),
    ``member`` at most 64 names, ``flag`` ``provenance.FLAGS``."""

    _MAX_MEMBERS = 64

    def __init__(self):
        self._lock = threading.Lock()
        self.by_tier_member: Dict[Tuple[str, str], int] = {}
        self.flags: Dict[str, int] = {}
        self._members: set = set()

    def count(self, record: Mapping) -> None:
        from .provenance import FLAGS, TIERS
        tier = record.get("tier")
        if tier not in TIERS:
            tier = "render_cold"
        member = str(record.get("member") or "-")
        with self._lock:
            if member not in self._members:
                if len(self._members) >= self._MAX_MEMBERS:
                    member = "_overflow"
                self._members.add(member)
            key = (tier, member)
            self.by_tier_member[key] = self.by_tier_member.get(key, 0) + 1
            for flag in FLAGS:
                if record.get(flag):
                    self.flags[flag] = self.flags.get(flag, 0) + 1

    def totals(self) -> Dict[str, int]:
        """Responses by tier."""
        with self._lock:
            out: Dict[str, int] = {}
            for (tier, _member), n in self.by_tier_member.items():
                out[tier] = out.get(tier, 0) + n
            return out

    def metric_lines(self) -> List[str]:
        with self._lock:
            lines = [f'imageregion_provenance_total{{tier="{tier}",'
                     f'member="{member}"}} '
                     f"{self.by_tier_member[(tier, member)]}"
                     for tier, member in sorted(self.by_tier_member)]
            lines += [f'imageregion_provenance_flags_total{{flag="{f}"}} '
                      f"{self.flags[f]}" for f in sorted(self.flags)]
        return lines

    def reset(self) -> None:
        with self._lock:
            self.by_tier_member.clear()
            self.flags.clear()
            self._members.clear()


PROVENANCE = ProvenanceStats()


class Readiness:
    """The process's state behind ``/readyz``: whether the startup
    prewarm (``server.prewarm``) is still running, and why it failed if
    it did (a failed build or launch keeps the process unready)."""

    def __init__(self):
        self.prewarm_pending = False
        self.prewarm_failed: Optional[str] = None

    def reset(self) -> None:
        self.prewarm_pending = False
        self.prewarm_failed = None


READINESS = Readiness()


# ------------------------------------------------------ flight recorder

# Monotone sequence of dump names: two dumps in one wall-clock second get
# two names (next() is atomic on CPython).
_ARTIFACT_SEQ = itertools.count(1)


class FlightRecorder:
    """The black box: a bounded ring of structured events, the JAX
    package's ``FlightRecorder``.

    ``record`` appends to a ``deque`` with a ``maxlen`` (atomic under the
    GIL), so lane threads, the admission path and the signal path record
    without a lock.  ``dump`` writes the ring as one JSON document and
    never raises: a full disk must not turn a shutdown into a crash."""

    # Dumps past this many are pruned oldest first on each write.
    MAX_DUMPS = 64

    def __init__(self, maxlen: int = 512):
        from collections import deque
        self._ring = deque(maxlen=maxlen)
        self.events_total = 0
        self.dumps_written = 0
        # The fleet member this process is (a sidecar learns it from its
        # frontend's hello): every event carries it unless it names a
        # member of its own (a drain phase, a steal).
        self.member: Optional[str] = None

    def configure(self, maxlen: int) -> None:
        from collections import deque
        if maxlen != self._ring.maxlen:
            self._ring = deque(self._ring, maxlen=max(16, maxlen))

    def set_member(self, member: Optional[str]) -> None:
        self.member = member

    def record(self, kind: str, **fields) -> None:
        event = {"ts": round(time.time(), 3), "kind": kind}
        if self.member is not None and "member" not in fields:
            event["member"] = self.member
        event.update(fields)
        self._ring.append(event)
        self.events_total += 1     # a benign race: a count, not a key

    def snapshot(self) -> List[dict]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, directory: str, reason: str) -> Optional[str]:
        """Write the ring to ``directory`` as
        ``flight-<date>-<time>-<pid>-<seq>-<reason>.json``; the path, or
        None when the write failed (logged, never raised)."""
        try:
            events = self.snapshot()
            os.makedirs(directory, exist_ok=True)
            seq = next(_ARTIFACT_SEQ)
            path = os.path.join(
                directory,
                time.strftime(f"flight-%Y%m%d-%H%M%S-{os.getpid()}"
                              f"-{seq:04d}-{reason}.json"))
            doc = {"flight_recorder": True, "reason": reason,
                   "ts": round(time.time(), 3), "pid": os.getpid(),
                   "events": events}
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
            self.dumps_written += 1
            self._prune(directory)
            return path
        except Exception:
            try:
                log.warning("flight-recorder dump to %s failed",
                            directory, exc_info=True)
            except Exception:
                pass
            return None

    def _prune(self, directory: str) -> None:
        dumps = sorted(
            os.path.join(directory, name)
            for name in os.listdir(directory)
            if name.startswith("flight-") and name.endswith(".json"))
        for stale in dumps[:-self.MAX_DUMPS]:
            try:
                os.unlink(stale)
            except OSError:
                pass

    def metric_lines(self) -> List[str]:
        return [f"imageregion_flight_events {len(self)}",
                f"imageregion_flight_events_total {self.events_total}",
                f"imageregion_flight_dumps_total {self.dumps_written}"]

    def reset(self) -> None:
        self._ring.clear()
        self.events_total = 0
        self.dumps_written = 0
        self.member = None


FLIGHT = FlightRecorder()


# ------------------------------------------------------ warm persistence

class Persistence:
    """Warm-state accounting, the JAX package's ``Persistence``: the disk
    byte tier (``services.diskcache``), the manifest snapshots and the
    boot rehydrate (``services.warmstate``), and, the port's own, the
    build store's corrupt entries (``server.execcache``; its hit, miss,
    load and save series come from the store).
    Thread-safe: the write-behind worker, the snapshot timer and the
    rehydrator count here; a scrape only reads."""

    _FIELDS = {
        "diskcache_writes": 0, "diskcache_write_errors": 0,
        "diskcache_write_dropped": 0, "diskcache_corrupt": 0,
        "diskcache_bytes": 0, "diskcache_entries": 0,
        "snapshots": 0, "snapshot_errors": 0, "snapshot_last_ts": 0.0,
        "snapshot_duration_ms": 0.0,
        "rehydrate_running": False, "rehydrate_items_total": 0,
        "rehydrate_items_done": 0, "rehydrate_errors": 0,
        "rehydrate_aborted": False, "rehydrate_duration_ms": 0.0,
        "rehydrate_bytes_promoted": 0, "rehydrate_planes_restaged": 0,
        "rehydrate_executables_loaded": 0, "execcache_corrupt": 0,
    }

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    # ------------------------------------------------------- disk tier

    def count_disk_write(self, error: bool = False,
                         dropped: bool = False) -> None:
        with self._lock:
            if dropped:
                self.diskcache_write_dropped += 1
            elif error:
                self.diskcache_write_errors += 1
            else:
                self.diskcache_writes += 1

    def count_disk_corrupt(self) -> None:
        with self._lock:
            self.diskcache_corrupt += 1
        FLIGHT.record("diskcache.corrupt")

    def set_disk_size(self, nbytes: int, entries: int) -> None:
        with self._lock:
            self.diskcache_bytes = int(nbytes)
            self.diskcache_entries = int(entries)

    # ------------------------------------------------------ build store

    def count_exec_corrupt(self) -> None:
        with self._lock:
            self.execcache_corrupt += 1

    # -------------------------------------------------------- snapshot

    def count_snapshot(self, duration_ms: float,
                       error: bool = False) -> None:
        with self._lock:
            if error:
                self.snapshot_errors += 1
                return
            self.snapshots += 1
            self.snapshot_last_ts = time.time()
            self.snapshot_duration_ms = float(duration_ms)

    # ------------------------------------------------------- rehydrate

    def rehydrate_begin(self, items_total: int) -> None:
        with self._lock:
            self.rehydrate_running = True
            self.rehydrate_aborted = False
            self.rehydrate_items_total = int(items_total)
            self.rehydrate_items_done = 0

    def rehydrate_step(self, kind: str = "", nbytes: int = 0,
                       error: bool = False) -> None:
        with self._lock:
            self.rehydrate_items_done += 1
            if error:
                self.rehydrate_errors += 1
                return
            if kind == "byte":
                self.rehydrate_bytes_promoted += int(nbytes)
            elif kind == "plane":
                self.rehydrate_planes_restaged += 1
            elif kind == "executable":
                self.rehydrate_executables_loaded += 1

    def rehydrate_end(self, duration_ms: float,
                      aborted: bool = False) -> None:
        with self._lock:
            self.rehydrate_running = False
            self.rehydrate_aborted = bool(aborted)
            self.rehydrate_duration_ms = float(duration_ms)

    def rehydrate_summary(self) -> str:
        """The ``/readyz`` annotation: ``idle``, ``running N/M``,
        ``aborted N/M`` or ``done N/M`` (never a readiness failure)."""
        with self._lock:
            if self.rehydrate_running:
                return (f"running {self.rehydrate_items_done}"
                        f"/{self.rehydrate_items_total}")
            if self.rehydrate_aborted:
                return (f"aborted {self.rehydrate_items_done}"
                        f"/{self.rehydrate_items_total}")
            if self.rehydrate_items_total:
                return (f"done {self.rehydrate_items_done}"
                        f"/{self.rehydrate_items_total}")
        return "idle"

    def metric_lines(self) -> List[str]:
        """The JAX families, unlabelled."""
        with self._lock:
            age_s = (time.time() - self.snapshot_last_ts
                     if self.snapshot_last_ts else 0.0)
            return [
                f"imageregion_diskcache_writes_total {self.diskcache_writes}",
                "imageregion_diskcache_write_errors_total "
                f"{self.diskcache_write_errors}",
                "imageregion_diskcache_write_dropped_total "
                f"{self.diskcache_write_dropped}",
                "imageregion_diskcache_corrupt_total "
                f"{self.diskcache_corrupt}",
                f"imageregion_diskcache_bytes {self.diskcache_bytes}",
                f"imageregion_diskcache_entries {self.diskcache_entries}",
                f"imageregion_warmstate_snapshots_total {self.snapshots}",
                "imageregion_warmstate_snapshot_errors_total "
                f"{self.snapshot_errors}",
                "imageregion_warmstate_snapshot_age_seconds "
                f"{round(age_s, 3)}",
                "imageregion_warmstate_snapshot_duration_ms "
                f"{round(self.snapshot_duration_ms, 3)}",
                "imageregion_rehydrate_running "
                f"{1 if self.rehydrate_running else 0}",
                "imageregion_rehydrate_items_total "
                f"{self.rehydrate_items_total}",
                "imageregion_rehydrate_items_done "
                f"{self.rehydrate_items_done}",
                "imageregion_rehydrate_errors_total "
                f"{self.rehydrate_errors}",
                "imageregion_rehydrate_duration_ms "
                f"{round(self.rehydrate_duration_ms, 3)}",
                "imageregion_rehydrate_bytes_promoted_total "
                f"{self.rehydrate_bytes_promoted}",
                "imageregion_rehydrate_planes_restaged_total "
                f"{self.rehydrate_planes_restaged}",
                "imageregion_rehydrate_executables_loaded_total "
                f"{self.rehydrate_executables_loaded}",
            ]

    def reset(self) -> None:
        with self._lock:
            for name, value in self._FIELDS.items():
                setattr(self, name, value)


PERSIST = Persistence()


# ------------------------------------------------------------ SLO engine

class SloEngine:
    """Config-declared service objectives evaluated as multi-window burn
    rates (the JAX ``SloEngine``): error rate over error budget in a fast
    and a slow window; both over the threshold is a breach.

    * ``availability``: the fraction of requests answering below 500
      (sheds and deadline 504s spend the budget);
    * ``latency``: the fraction of successful requests under
      ``latency_ms``.

    Time is bucketed (``BUCKET_S``), so the windows cost O(window /
    bucket) memory and :meth:`record` is a dict increment; disabled (the
    default: no target) it costs one boolean test.  A breach transition
    calls ``on_breach`` once per episode (the app's flight-recorder dump).
    The clock is injectable (tests run it virtual)."""

    BUCKET_S = 5.0

    def __init__(self):
        self._lock = threading.Lock()
        self._clock = time.monotonic
        self.enabled = False
        self.availability_target = 0.0
        self.latency_ms = 0.0
        self.latency_target = 0.99
        self.fast_window_s = 60.0
        self.slow_window_s = 600.0
        self.breach_burn_rate = 14.4
        self.on_breach = None
        self.breached: Dict[str, bool] = {}
        self.breaches_total = 0
        self._buckets: Dict[int, Dict[str, int]] = {}

    def configure(self, availability_target: float = 0.0,
                  latency_ms: float = 0.0,
                  latency_target: float = 0.99,
                  fast_window_s: float = 60.0,
                  slow_window_s: float = 600.0,
                  breach_burn_rate: float = 14.4,
                  on_breach=None, clock=time.monotonic) -> None:
        with self._lock:
            self.availability_target = availability_target
            self.latency_ms = latency_ms
            self.latency_target = latency_target
            self.fast_window_s = fast_window_s
            self.slow_window_s = max(slow_window_s, fast_window_s)
            self.breach_burn_rate = breach_burn_rate
            self.on_breach = on_breach
            self._clock = clock
            self.enabled = bool(availability_target or latency_ms)
            self._buckets.clear()
            self.breached = {}

    def _bucket(self, now: float) -> Dict[str, int]:
        idx = int(now // self.BUCKET_S)
        b = self._buckets.get(idx)
        if b is None:
            b = self._buckets[idx] = {"ok": 0, "err": 0,
                                      "fast": 0, "slow": 0}
            floor = idx - int(self.slow_window_s // self.BUCKET_S) - 1
            for old in [i for i in self._buckets if i < floor]:
                del self._buckets[old]
        return b

    def record(self, status: int, dur_ms: float) -> None:
        if not self.enabled:
            return
        breach_cbs = []
        with self._lock:
            b = self._bucket(self._clock())
            if status >= 500:
                b["err"] += 1
            else:
                b["ok"] += 1
                if self.latency_ms:
                    if dur_ms <= self.latency_ms:
                        b["fast"] += 1
                    else:
                        b["slow"] += 1
            for objective, (fast, slow) in \
                    self._burn_rates_locked().items():
                now_breached = (fast >= self.breach_burn_rate
                                and slow >= self.breach_burn_rate)
                was = self.breached.get(objective, False)
                self.breached[objective] = now_breached
                if now_breached and not was:
                    self.breaches_total += 1
                    breach_cbs.append((objective, fast, slow))
        if self.on_breach is not None:
            for cb in breach_cbs:
                try:
                    self.on_breach(*cb)
                except Exception:   # forensics never fails a request
                    log.warning("SLO on_breach hook failed",
                                exc_info=True)

    def _window_counts(self, window_s: float) -> Dict[str, int]:
        floor = int((self._clock() - window_s) // self.BUCKET_S)
        out = {"ok": 0, "err": 0, "fast": 0, "slow": 0}
        for idx, b in self._buckets.items():
            if idx >= floor:
                for k in out:
                    out[k] += b[k]
        return out

    def _burn_rates_locked(self) -> Dict[str, Tuple[float, float]]:
        def burn(bad: int, total: int, target: float) -> float:
            if total == 0:
                return 0.0
            return (bad / total) / max(1e-9, 1.0 - target)

        pair = [self._window_counts(w)
                for w in (self.fast_window_s, self.slow_window_s)]
        rates: Dict[str, Tuple[float, float]] = {}
        if self.availability_target:
            rates["availability"] = tuple(
                burn(c["err"], c["ok"] + c["err"],
                     self.availability_target) for c in pair)
        if self.latency_ms:
            rates["latency"] = tuple(
                burn(c["slow"], c["fast"] + c["slow"],
                     self.latency_target) for c in pair)
        return rates

    def burn_rates(self) -> Dict[str, Tuple[float, float]]:
        """{objective: (fast burn, slow burn)}."""
        with self._lock:
            return self._burn_rates_locked()

    def any_breached(self) -> bool:
        with self._lock:
            return any(self.breached.values())

    def summary(self) -> str:
        """The ``/readyz`` annotation."""
        with self._lock:
            rates = self._burn_rates_locked()
            breached = [o for o, v in self.breached.items() if v]
        if not rates:
            return "disabled"
        parts = [f"{o} burn {fast:.1f}/{slow:.1f}"
                 for o, (fast, slow) in sorted(rates.items())]
        return ("BREACH " if breached else "ok ") + ", ".join(parts)

    def metric_lines(self) -> List[str]:
        if not self.enabled:
            return []
        with self._lock:
            rates = self._burn_rates_locked()
            breached = dict(self.breached)
            breaches = self.breaches_total
        lines = []
        for objective, (fast, slow) in sorted(rates.items()):
            for window, rate in (("fast", fast), ("slow", slow)):
                lines.append(
                    f'imageregion_slo_burn_rate{{slo="{objective}",'
                    f'window="{window}"}} {round(rate, 4)}')
            lines.append(
                f'imageregion_slo_breach{{slo="{objective}"}} '
                f'{1 if breached.get(objective) else 0}')
        lines.append(f"imageregion_slo_breaches_total {breaches}")
        return lines

    def export_buckets(self) -> dict:
        """The window state for the fleet aggregate (:class:`FleetSloStats`,
        over the gossip wire).  Bucket indices key off this process's
        monotonic clock, so buckets travel as ages (seconds before this
        export) and the ingesting host re-anchors them.  A disabled engine
        exports ``{}``."""
        with self._lock:
            if not self.enabled:
                return {}
            now = self._clock()
            buckets = [
                [round(now - idx * self.BUCKET_S, 3),
                 b["ok"], b["err"], b["fast"], b["slow"]]
                for idx, b in sorted(self._buckets.items())
            ]
            return {
                "bucket_s": self.BUCKET_S,
                "availability_target": self.availability_target,
                "latency_ms": self.latency_ms,
                "latency_target": self.latency_target,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "buckets": buckets,
            }
    def reset(self) -> None:
        with self._lock:
            self.enabled = False
            self.availability_target = 0.0
            self.latency_ms = 0.0
            self.on_breach = None
            self._clock = time.monotonic
            self._buckets.clear()
            self.breached = {}
            self.breaches_total = 0


SLO = SloEngine()


# ------------------------------------------------------ shape cost model

class ShapeCostModel:
    """Estimated against observed device cost per group shape (the JAX
    ``ShapeCostModel``).

    The batcher records each group's execute wall ms under its shape label
    (``B<n>x<C>x<H>x<W>``, ``jpeg:`` for a JPEG group), and once per shape
    the estimate: the bytes the group's kernels must move and the f32
    operations they do, counted from the kernel shapes the way PERF.md's
    bounds count them (``server.batcher._shape_estimate``).  The JAX
    package takes its estimate from XLA's ``cost_analysis()`` of the
    compiled program, which the port does not have, so the two packages'
    estimates differ by design; only the observed half (dispatches, ms) is
    held equal.  Label cardinality is bounded by the batch sizes and the
    buckets."""

    def __init__(self):
        self._lock = threading.Lock()
        self._shapes: Dict[str, dict] = {}
        self._claimed: set = set()

    def observe(self, shape: str, ms: float) -> None:
        with self._lock:
            s = self._shapes.get(shape)
            if s is None:
                s = self._shapes[shape] = {
                    "dispatches": 0, "ms_total": 0.0,
                    "est_flops": None, "est_bytes": None}
            s["dispatches"] += 1
            s["ms_total"] += ms

    def claim_estimate(self, shape: str) -> bool:
        """True exactly once per shape: concurrent first groups of one
        shape count its estimate once."""
        with self._lock:
            if shape in self._claimed:
                return False
            self._claimed.add(shape)
            return True

    def set_estimate(self, shape: str, flops: Optional[float],
                     nbytes: Optional[float]) -> None:
        with self._lock:
            s = self._shapes.setdefault(shape, {
                "dispatches": 0, "ms_total": 0.0,
                "est_flops": None, "est_bytes": None})
            s["est_flops"] = float(flops or 0.0)
            s["est_bytes"] = float(nbytes or 0.0)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._shapes.items()}

    def metric_lines(self) -> List[str]:
        with self._lock:
            items = sorted((k, dict(v)) for k, v in self._shapes.items())
        lines = []
        for shape, s in items:
            lb = f'{{shape="{shape}"}}'
            lines += [
                f"imageregion_shape_dispatches_total{lb} "
                f"{s['dispatches']}",
                f"imageregion_shape_device_ms_total{lb} "
                f"{round(s['ms_total'], 3)}",
            ]
            if s["dispatches"]:
                lines.append(
                    f"imageregion_shape_device_ms_mean{lb} "
                    f"{round(s['ms_total'] / s['dispatches'], 3)}")
            if s["est_flops"] is not None:
                lines += [
                    f"imageregion_shape_estimated_flops{lb} "
                    f"{_fmt(s['est_flops'])}",
                    f"imageregion_shape_estimated_bytes{lb} "
                    f"{_fmt(s['est_bytes'])}",
                ]
        return lines

    def reset(self) -> None:
        with self._lock:
            self._shapes.clear()
            self._claimed.clear()


SHAPE_COSTS = ShapeCostModel()


# ------------------------------------------------------ device profiling

class ProfileInProgressError(Exception):
    """A capture is already running (``/debug/profile`` answers 409)."""


_PROFILE_LOCK = threading.Lock()


def capture_profile(directory: str, ms: float) -> dict:
    """Run ``torch.profiler`` for ``ms`` milliseconds over whatever the
    process is doing, write a Chrome trace, and return the manifest (the
    JAX keys: ``dir``, ``ms``, ``requested_ms``, ``files``, ``bytes``).

    The JAX package wraps ``jax.profiler`` and writes XLA's xplane; the
    port records CPU activity and, where the process has a card, CUDA
    activity (CUPTI: every kernel and copy on the card in the window, from
    any thread), and writes ``trace.json`` under
    ``<directory>/profile-<date>-<time>-<seq>/``.  On a process with a card
    CUDA activity is required: a profiler that cannot record it raises,
    and the endpoint answers 503.  CUPTI is process-wide, so one capture
    runs at a time (:class:`ProfileInProgressError` otherwise).  Blocking:
    callers run it on a worker thread."""
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise ProfileInProgressError("a profile capture is already "
                                     "running")
    try:
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    supported_activities)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError("torch.profiler cannot record CUDA "
                                   "activity in this build")
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(directory, exist_ok=True)
        while True:
            # A name another process took in the same second is skipped.
            seq = next(_ARTIFACT_SEQ)
            path = os.path.join(directory, time.strftime(
                f"profile-%Y%m%d-%H%M%S-{seq:04d}"))
            try:
                os.mkdir(path)
                break
            except FileExistsError:
                continue
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            time.sleep(max(0.0, ms) / 1000.0)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
        files, total = [], 0
        for root, _dirs, names in os.walk(path):
            for name in names:
                full = os.path.join(root, name)
                files.append(os.path.relpath(full, path))
                try:
                    total += os.path.getsize(full)
                except OSError:
                    pass
        FLIGHT.record("profile.captured", dir=path, ms=round(ms, 1),
                      files=len(files))
        return {"dir": path,
                "ms": round((time.perf_counter() - t0) * 1000.0, 1),
                "requested_ms": ms, "files": sorted(files),
                "bytes": total}
    finally:
        _PROFILE_LOCK.release()


# ------------------------------------------------------ control plane

class PressureStats:
    """The pressure governor's accounting (``server.pressure``): the folded
    level, the raw signal readings, and the ladder's engaged steps and
    transitions.  Closed label sets: the sampler's fixed signals and the
    config-validated ladder."""

    LEVELS = ("ok", "elevated", "critical")

    def __init__(self):
        self._lock = threading.Lock()
        self.level = 0
        self.signals: Dict[str, float] = {}
        self.steps_engaged: Dict[str, int] = {}
        self.step_transitions: Dict[Tuple[str, str], int] = {}
        self.level_transitions = 0

    def set_level(self, level: int) -> None:
        with self._lock:
            if level != self.level:
                self.level_transitions += 1
            self.level = level

    def set_signal(self, name: str, value: float) -> None:
        with self._lock:
            self.signals[name] = float(value)

    def set_step(self, step: str, engaged: bool) -> None:
        with self._lock:
            self.steps_engaged[step] = 1 if engaged else 0
            key = (step, "engage" if engaged else "release")
            self.step_transitions[key] = \
                self.step_transitions.get(key, 0) + 1

    def declare_steps(self, steps) -> None:
        """Every ladder step's gauge exists from the first scrape."""
        with self._lock:
            for step in steps:
                self.steps_engaged.setdefault(step, 0)

    def metric_lines(self) -> List[str]:
        with self._lock:
            lines = [
                f"imageregion_pressure_level {self.level}",
                "imageregion_pressure_level_transitions_total "
                f"{self.level_transitions}",
                "imageregion_pressure_steps_engaged "
                f"{sum(self.steps_engaged.values())}",
            ]
            lines += [f'imageregion_pressure_signal{{signal="{name}"}} '
                      f"{_fmt(self.signals[name])}"
                      for name in sorted(self.signals)]
            lines += [f'imageregion_pressure_step_engaged{{step="{step}"}} '
                      f"{self.steps_engaged[step]}"
                      for step in sorted(self.steps_engaged)]
            lines += [f"imageregion_pressure_step_transitions_total"
                      f'{{step="{step}",action="{action}"}} '
                      f"{self.step_transitions[(step, action)]}"
                      for step, action in sorted(self.step_transitions)]
        return lines

    def reset(self) -> None:
        with self._lock:
            self.level = 0
            self.signals.clear()
            self.steps_engaged.clear()
            self.step_transitions.clear()
            self.level_transitions = 0


PRESSURE = PressureStats()


class DecisionStats:
    """The exposition half of the decision ledger (``utils.decisions``):
    records by (kind, verdict).  Both vocabularies are the JAX package's,
    closed and owned here."""

    KINDS = ("autoscaler", "epoch", "manifest", "gossip",
             "drain", "undrain", "handoff", "hotkey", "quorum",
             "sentinel")
    VERDICTS = ("up", "down", "blocked", "steady",
                "installed", "pending", "promoted", "demoted",
                "agreed", "stale", "split-brain", "unreachable",
                "legacy", "ok", "mismatch", "done", "failed",
                "fenced", "restored", "drift", "recovered")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[Tuple[str, str], int] = {}

    def count(self, kind: str, verdict: str) -> None:
        if kind not in self.KINDS or verdict not in self.VERDICTS:
            return                       # the ledger warned
        with self._lock:
            key = (kind, verdict)
            self.counts[key] = self.counts.get(key, 0) + 1

    def metric_lines(self) -> List[str]:
        with self._lock:
            return [f"imageregion_decision_total{{kind={json.dumps(k)},"
                    f"verdict={json.dumps(v)}}} {n}"
                    for (k, v), n in sorted(self.counts.items())]

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()


DECISIONS = DecisionStats()


class FederationStats:
    """The federation's accounting (``parallel.federation``): the active
    manifest's version and member count, join-time agreement outcomes,
    gossip-round outcomes, the warm planes shipped over ``shard_transfer``
    and the prestage hints sent to remote owners.  Both label sets are the
    closed vocabularies below."""

    AGREEMENT_REASONS = ("agreed", "pending", "stale", "split-brain",
                         "unreachable", "legacy")
    GOSSIP_REASONS = ("ok", "mismatch", "unreachable")

    def __init__(self):
        self._lock = threading.Lock()
        self.manifest_version = 0
        self.members = 0
        self.agreements: Dict[str, int] = {}
        self.gossip: Dict[str, int] = {}
        self.shard_transfers = 0
        self.transfer_bytes = 0
        self.remote_prestage = 0

    def set_manifest(self, version: int, members: int) -> None:
        with self._lock:
            self.manifest_version = int(version)
            self.members = int(members)

    def count_agreement(self, reason: str) -> None:
        if reason not in self.AGREEMENT_REASONS:
            reason = "unreachable"
        with self._lock:
            self.agreements[reason] = self.agreements.get(reason, 0) + 1

    def count_gossip(self, reason: str) -> None:
        if reason not in self.GOSSIP_REASONS:
            reason = "unreachable"
        with self._lock:
            self.gossip[reason] = self.gossip.get(reason, 0) + 1

    def count_transfer(self, nbytes: int) -> None:
        with self._lock:
            self.shard_transfers += 1
            self.transfer_bytes += int(nbytes)

    def count_remote_prestage(self, n: int = 1) -> None:
        with self._lock:
            self.remote_prestage += n

    def metric_lines(self) -> List[str]:
        with self._lock:
            if not (self.manifest_version or self.agreements
                    or self.gossip or self.shard_transfers
                    or self.remote_prestage):
                return []                # emit-when-live
            lines = [
                "imageregion_federation_manifest_version "
                f"{self.manifest_version}",
                f"imageregion_federation_members {self.members}",
                "imageregion_federation_shard_transfers_total "
                f"{self.shard_transfers}",
                "imageregion_federation_transfer_bytes_total "
                f"{self.transfer_bytes}",
                "imageregion_federation_remote_prestage_total "
                f"{self.remote_prestage}",
            ]
            lines += [f'imageregion_federation_agreements_total'
                      f'{{reason="{r}"}} {n}'
                      for r, n in sorted(self.agreements.items())]
            lines += [f'imageregion_federation_gossip_total'
                      f'{{reason="{r}"}} {n}'
                      for r, n in sorted(self.gossip.items())]
        return lines

    def reset(self) -> None:
        with self._lock:
            self.manifest_version = 0
            self.members = 0
            self.agreements.clear()
            self.gossip.clear()
            self.shard_transfers = 0
            self.transfer_bytes = 0
            self.remote_prestage = 0


FEDERATION = FederationStats()


class FleetSloStats:
    """Fleet-level SLO burn: every federated host exports its
    :class:`SloEngine` window buckets over the gossip wire
    (:meth:`SloEngine.export_buckets`, keyed by age, since bucket indices
    are process-local) and this host re-anchors them on its own clock, so
    one host's burning budget shows as ``imageregion_fleet_slo_*`` while
    the fleet mean looks healthy.  At most ``_MAX_HOSTS`` hosts are held;
    a new host past the bound is dropped and counted.  The strictest
    target seen wins."""

    _MAX_HOSTS = 16

    def __init__(self):
        self._lock = threading.Lock()
        self._clock = time.monotonic
        # host -> {"t": ingest instant, "export": the export document}
        self.hosts: Dict[str, dict] = {}
        self.dropped_hosts = 0

    def ingest(self, host: str, export) -> bool:
        if not host or not isinstance(export, dict) \
                or not export.get("buckets"):
            return False
        with self._lock:
            if host not in self.hosts \
                    and len(self.hosts) >= self._MAX_HOSTS:
                self.dropped_hosts += 1
                return False
            self.hosts[host] = {"t": self._clock(), "export": dict(export)}
        return True

    @staticmethod
    def _window_counts(export: dict, elapsed: float,
                       window_s: float) -> Dict[str, int]:
        out = {"ok": 0, "err": 0, "fast": 0, "slow": 0}
        bucket_s = float(export.get("bucket_s", 5.0))
        for row in export.get("buckets", ()):
            try:
                age, ok, err, fast, slow = row
            except (TypeError, ValueError):
                continue
            # ``age`` dates the bucket's start at export; a bucket counts
            # while any part of it overlaps the window.
            if float(age) + elapsed - bucket_s <= window_s:
                out["ok"] += int(ok)
                out["err"] += int(err)
                out["fast"] += int(fast)
                out["slow"] += int(slow)
        return out

    def _burns_locked(self) -> dict:
        """{"hosts": {host: {objective: {window: burn}}}, "fleet":
        {objective: {window: burn}}}."""
        now = self._clock()

        def burn(bad: int, total: int, target: float) -> float:
            if total == 0 or not target:
                return 0.0
            return (bad / total) / max(1e-9, 1.0 - target)

        per_host: Dict[str, dict] = {}
        fleet_counts: Dict[str, Dict[str, int]] = {}
        targets = {"availability": 0.0, "latency": 0.0}
        for host, entry in self.hosts.items():
            export = entry["export"]
            elapsed = max(0.0, now - entry["t"])
            targets["availability"] = max(
                targets["availability"],
                float(export.get("availability_target", 0.0)))
            targets["latency"] = max(
                targets["latency"],
                float(export.get("latency_target", 0.0))
                if export.get("latency_ms") else 0.0)
            host_doc: Dict[str, dict] = {}
            for window, window_s in (
                    ("fast", float(export.get("fast_window_s", 60.0))),
                    ("slow", float(export.get("slow_window_s", 600.0)))):
                c = self._window_counts(export, elapsed, window_s)
                agg = fleet_counts.setdefault(
                    window, {"ok": 0, "err": 0, "fast": 0, "slow": 0})
                for k in c:
                    agg[k] += c[k]
                if export.get("availability_target"):
                    host_doc.setdefault("availability", {})[window] = \
                        burn(c["err"], c["ok"] + c["err"],
                             float(export["availability_target"]))
                if export.get("latency_ms"):
                    host_doc.setdefault("latency", {})[window] = \
                        burn(c["slow"], c["fast"] + c["slow"],
                             float(export.get("latency_target", 0.99)))
            per_host[host] = host_doc
        fleet: Dict[str, dict] = {}
        for window, c in fleet_counts.items():
            if targets["availability"]:
                fleet.setdefault("availability", {})[window] = burn(
                    c["err"], c["ok"] + c["err"], targets["availability"])
            if targets["latency"]:
                fleet.setdefault("latency", {})[window] = burn(
                    c["slow"], c["fast"] + c["slow"], targets["latency"])
        return {"hosts": per_host, "fleet": fleet}

    def burns(self) -> dict:
        with self._lock:
            return self._burns_locked()

    def metric_lines(self) -> List[str]:
        with self._lock:
            if not self.hosts and not self.dropped_hosts:
                return []                # emit-when-live
            doc = self._burns_locked()
            lines = [f"imageregion_fleet_slo_hosts {len(self.hosts)}"]
            if self.dropped_hosts:
                lines.append("imageregion_fleet_slo_dropped_hosts_total "
                             f"{self.dropped_hosts}")
            for objective in sorted(doc["fleet"]):
                for window in sorted(doc["fleet"][objective]):
                    lines.append(
                        f'imageregion_fleet_slo_burn_rate{{slo="{objective}"'
                        f',window="{window}"}} '
                        f"{round(doc['fleet'][objective][window], 4)}")
            for host in sorted(doc["hosts"]):
                for objective in sorted(doc["hosts"][host]):
                    for window in sorted(doc["hosts"][host][objective]):
                        rate = doc["hosts"][host][objective][window]
                        lines.append(
                            f'imageregion_fleet_slo_host_burn_rate'
                            f'{{host="{host}",slo="{objective}",'
                            f'window="{window}"}} {round(rate, 4)}')
        return lines

    def reset(self) -> None:
        with self._lock:
            self._clock = time.monotonic
            self.hosts.clear()
            self.dropped_hosts = 0


FED_SLO = FleetSloStats()


class QuorumStats:
    """Partition tolerance: the quorum tracker's verdict
    (``parallel.federation.QuorumTracker``) and the link-partition fault
    injector (``utils.faultinject``).  Two families,
    ``imageregion_federation_quorum_*`` and ``imageregion_partition_*``,
    over closed vocabularies: transitions ``fenced``/``restored``, refusal
    :data:`ACTIONS`, partition :data:`MODES`."""

    ACTIONS = ("adoption", "write_authority", "promotion",
               "autoscaler", "transfer", "roll")
    MODES = ("drop", "deny")

    def __init__(self):
        self._lock = threading.Lock()
        # None: no tracker installed (emit-when-live).
        self.quorate: Optional[bool] = None
        self.reachable_hosts = 0
        self.total_hosts = 0
        self.transitions: Dict[str, int] = {}
        self.refusals: Dict[str, int] = {}
        self.partition_rules = 0
        self.partition_blocked: Dict[str, int] = {}

    def set_quorum(self, quorate: bool, reachable: int, total: int) -> None:
        with self._lock:
            self.quorate = bool(quorate)
            self.reachable_hosts = int(reachable)
            self.total_hosts = int(total)

    def count_transition(self, verdict: str) -> None:
        if verdict not in ("fenced", "restored"):
            return
        with self._lock:
            self.transitions[verdict] = self.transitions.get(verdict, 0) + 1

    def count_refusal(self, action: str) -> None:
        if action not in self.ACTIONS:
            return
        with self._lock:
            self.refusals[action] = self.refusals.get(action, 0) + 1

    def set_partition_rules(self, n: int) -> None:
        with self._lock:
            self.partition_rules = int(n)

    def count_partition_blocked(self, mode: str) -> None:
        if mode not in self.MODES:
            mode = "drop"
        with self._lock:
            self.partition_blocked[mode] = \
                self.partition_blocked.get(mode, 0) + 1

    def metric_lines(self) -> List[str]:
        with self._lock:
            lines: List[str] = []
            if self.quorate is not None:
                lines += [
                    "imageregion_federation_quorum_quorate "
                    f"{int(self.quorate)}",
                    "imageregion_federation_quorum_reachable_hosts "
                    f"{self.reachable_hosts}",
                    f"imageregion_federation_quorum_hosts {self.total_hosts}",
                ]
            lines += [f'imageregion_federation_quorum_transitions_total'
                      f'{{verdict="{v}"}} {n}'
                      for v, n in sorted(self.transitions.items())]
            lines += [f'imageregion_federation_quorum_refusals_total'
                      f'{{action="{a}"}} {n}'
                      for a, n in sorted(self.refusals.items())]
            if self.partition_rules or self.partition_blocked:
                lines.append(
                    f"imageregion_partition_rules {self.partition_rules}")
            lines += [f'imageregion_partition_blocked_total{{mode="{m}"}} '
                      f'{n}' for m, n in sorted(self.partition_blocked.items())]
        return lines

    def reset(self) -> None:
        with self._lock:
            self.quorate = None
            self.reachable_hosts = 0
            self.total_hosts = 0
            self.transitions.clear()
            self.refusals.clear()
            self.partition_rules = 0
            self.partition_blocked.clear()


QUORUM = QuorumStats()


class SentinelStats:
    """The exposition and fleet-merge half of the perf sentinel
    (``server.sentinel`` owns the sketches and the drift engine): the local
    engine's last tick summary (:meth:`set_local`), peers' summaries off
    the federation's gossip (:meth:`ingest`, at most ``_MAX_MEMBERS``, the
    :class:`FleetSloStats` bound), drift, recovery and bundle counts, and
    :meth:`merged`, the ``GET /debug/sentinel`` document."""

    _MAX_MEMBERS = 16

    def __init__(self):
        self._lock = threading.Lock()
        self._clock = time.monotonic
        # A member whose last summary is older is shown but not counted
        # drifting (a dead member must not pin the fleet red).
        self.stale_after_s = 120.0
        self.local: Optional[dict] = None
        # member -> {"t": ingest instant, "summary": tick summary}
        self.members: Dict[str, dict] = {}
        self.dropped_members = 0
        self.drifts = 0
        self.recoveries = 0
        self.bundles = 0
        self.bundle_errors = 0

    def set_local(self, summary) -> None:
        if isinstance(summary, dict):
            with self._lock:
                self.local = dict(summary)

    def count_drift(self) -> None:
        with self._lock:
            self.drifts += 1

    def count_recovery(self) -> None:
        with self._lock:
            self.recoveries += 1

    def count_bundle(self, error: bool = False) -> None:
        with self._lock:
            if error:
                self.bundle_errors += 1
            else:
                self.bundles += 1

    def export(self) -> Optional[dict]:
        """The local summary for the gossip wire (None before the first
        tick)."""
        with self._lock:
            return dict(self.local) if self.local else None

    def ingest(self, member: str, summary) -> bool:
        if not member or not isinstance(summary, dict) \
                or not summary.get("verdict"):
            return False
        with self._lock:
            if member not in self.members \
                    and len(self.members) >= self._MAX_MEMBERS:
                self.dropped_members += 1
                return False
            self.members[member] = {"t": self._clock(),
                                    "summary": dict(summary)}
        return True

    def merged(self) -> dict:
        """Per-member rows and one verdict: ``drifting`` while any fresh
        member reports a confirmed drift."""
        with self._lock:
            now = self._clock()
            rows: Dict[str, dict] = {}
            if self.local:
                name = str(self.local.get("member") or "local")
                rows[name] = {"age_s": 0.0, "summary": dict(self.local)}
            for member, entry in self.members.items():
                if member in rows:
                    continue
                rows[member] = {
                    "age_s": round(max(0.0, now - entry["t"]), 1),
                    "summary": dict(entry["summary"])}
            drifting = sorted(
                name for name, row in rows.items()
                if row["summary"].get("verdict") == "drifting"
                and row["age_s"] <= self.stale_after_s)
            return {
                "verdict": "drifting" if drifting else "ok",
                "drifting_members": drifting,
                "members": rows,
                "dropped_members": self.dropped_members,
                "drifts": self.drifts,
                "recoveries": self.recoveries,
                "bundles": self.bundles,
                "bundle_errors": self.bundle_errors,
            }

    def metric_lines(self) -> List[str]:
        with self._lock:
            if self.local is None and not self.members:
                return []                # until the first tick
            local = self.local or {}
            routes = local.get("routes") or {}
            lines = [
                "imageregion_sentinel_drift "
                f"{1 if local.get('verdict') == 'drifting' else 0}",
                f"imageregion_sentinel_keys {len(routes)}",
                "imageregion_sentinel_ticks_total "
                f"{int(local.get('ticks') or 0)}",
                "imageregion_sentinel_observations_total "
                f"{int(local.get('observations') or 0)}",
                f"imageregion_sentinel_drifts_total {self.drifts}",
                f"imageregion_sentinel_recoveries_total {self.recoveries}",
                f"imageregion_sentinel_bundles_total {self.bundles}",
                "imageregion_sentinel_bundle_errors_total "
                f"{self.bundle_errors}",
            ]
            for route in sorted(routes):
                doc = routes[route] or {}
                for key, family in (
                        ("p99_ms", "imageregion_sentinel_live_p99_ms"),
                        ("baseline_p99_ms",
                         "imageregion_sentinel_baseline_p99_ms")):
                    v = doc.get(key)
                    if isinstance(v, (int, float)):
                        lines.append(f'{family}{{route="{route}"}} '
                                     f"{round(float(v), 3)}")
            now = self._clock()
            for member in sorted(self.members):
                entry = self.members[member]
                if now - entry["t"] > self.stale_after_s:
                    continue
                v = 1 if entry["summary"].get("verdict") == "drifting" else 0
                lines.append("imageregion_sentinel_member_drift"
                             f"{{member={json.dumps(member)}}} {v}")
        return lines

    def reset(self) -> None:
        with self._lock:
            self._clock = time.monotonic
            self.stale_after_s = 120.0
            self.local = None
            self.members.clear()
            self.dropped_members = 0
            self.drifts = 0
            self.recoveries = 0
            self.bundles = 0
            self.bundle_errors = 0


SENTINEL = SentinelStats()


def exemplars_snapshot() -> Dict[str, List[dict]]:
    """The request-duration histogram's live exemplars per route (the
    ``/debug/exemplars`` document)."""
    return REQUEST_HIST.exemplar_docs()


def dump_slow_trace(trace: Trace, total_ms: float, status: int,
                    directory: str,
                    extra: Optional[dict] = None) -> Optional[str]:
    """Write a slow request's waterfall as ``<directory>/<trace id>.json``
    (``telemetry.slow-request-ms``); ``extra`` adds top-level fields (the
    provenance record).  Never raises: the path, or None."""
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{trace.trace_id}.json")
        doc = trace.to_json(total_ms=total_ms, status=status)
        if extra:
            doc.update(extra)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path
    except OSError:
        log.warning("slow-trace dump to %s failed", directory,
                    exc_info=True)
        return None


# ------------------------------------------------------------ exposition

METRIC_TYPES: Dict[str, str] = {
    "imageregion_span_count": "counter",
    "imageregion_span_mean_ms": "gauge",
    "imageregion_span_ms": "histogram",
    "imageregion_request_duration_ms": "histogram",
    "imageregion_requests_total": "counter",
    "imageregion_cache_hits": "counter",
    "imageregion_cache_misses": "counter",
    "imageregion_cache_evictions": "counter",
    "imageregion_rawcache_hits": "counter",
    "imageregion_rawcache_misses": "counter",
    "imageregion_rawcache_evictions": "counter",
    "imageregion_rawcache_bytes": "gauge",
    "imageregion_planecache_hits": "counter",
    "imageregion_planecache_misses": "counter",
    "imageregion_singleflight_hits": "counter",
    "imageregion_singleflight_misses": "counter",
    "imageregion_singleflight_inflight": "gauge",
    "imageregion_batches_dispatched": "counter",
    "imageregion_tiles_rendered": "counter",
    "imageregion_batcher_queue_depth": "gauge",
    "imageregion_pipeline_inflight": "gauge",
    "imageregion_batcher_max_batch": "gauge",
    "imageregion_batcher_queue_wait_max_ms": "gauge",
    "imageregion_shed_total": "counter",
    "imageregion_deadline_cancelled_total": "counter",
    "imageregion_breaker_state": "gauge",
    "imageregion_breaker_opens_total": "counter",
    "imageregion_retries_total": "counter",
    "imageregion_retry_attempts": "histogram",
    "imageregion_degraded_renders_total": "counter",
    "imageregion_supervisor_restarts_total": "counter",
    "imageregion_wire_flushes_total": "counter",
    "imageregion_wire_frames_total": "counter",
    "imageregion_wire_flush_bytes_total": "counter",
    "imageregion_wire_frames_per_flush": "gauge",
    "imageregion_wire_ring_hits_total": "counter",
    "imageregion_wire_ring_fallbacks_total": "counter",
    "imageregion_wire_ring_bytes_total": "counter",
    "imageregion_wire_ring_negotiated_total": "counter",
    "imageregion_wire_ring_declined_total": "counter",
    "imageregion_wire_streams_total": "counter",
    "imageregion_wire_chunks_total": "counter",
    "imageregion_watchdog_fires_total": "counter",
    "imageregion_httpcache_etag_requests_total": "counter",
    "imageregion_httpcache_ims_requests_total": "counter",
    "imageregion_httpcache_304_total": "counter",
    "imageregion_httpcache_head_total": "counter",
    "imageregion_httpcache_peer_probes_total": "counter",
    "imageregion_httpcache_peer_hits_total": "counter",
    "imageregion_httpcache_peer_fetches_total": "counter",
    "imageregion_httpcache_peer_fallbacks_total": "counter",
    "imageregion_httpcache_peer_putbacks_total": "counter",
    "imageregion_fleet_members": "gauge",
    "imageregion_fleet_members_healthy": "gauge",
    "imageregion_fleet_member_depth": "gauge",
    "imageregion_fleet_member_inflight": "gauge",
    "imageregion_fleet_member_healthy": "gauge",
    "imageregion_fleet_member_planes": "gauge",
    "imageregion_fleet_routed_total": "counter",
    "imageregion_fleet_stolen_total": "counter",
    "imageregion_fleet_failed_over_total": "counter",
    "imageregion_hotkey_promotions_total": "counter",
    "imageregion_hotkey_demotions_total": "counter",
    "imageregion_hotkey_replica_staged_total": "counter",
    "imageregion_hotkey_duplicate_staged_total": "counter",
    "imageregion_hotkey_balanced_total": "counter",
    "imageregion_hotkey_hot_routes": "gauge",
    "imageregion_hotkey_replica_pressure": "gauge",
    "imageregion_drain_state": "gauge",
    "imageregion_drain_transitions_total": "counter",
    "imageregion_drain_prestaged_planes_total": "counter",
    "imageregion_drains_total": "counter",
    "imageregion_workload_requests_total": "counter",
    "imageregion_pyramid_jobs_total": "counter",
    "imageregion_pyramid_jobs_active": "gauge",
    "imageregion_pyramid_levels_committed_total": "counter",
    "imageregion_animation_streams_total": "counter",
    "imageregion_animation_frames_total": "counter",
    "imageregion_animation_cancelled_total": "counter",
    "imageregion_animation_first_frame_ms": "gauge",
    "imageregion_session_tracked": "gauge",
    "imageregion_session_observations_total": "counter",
    "imageregion_session_evictions_total": "counter",
    "imageregion_prefetch_predicted_total": "counter",
    "imageregion_prefetch_scheduled_total": "counter",
    "imageregion_prefetch_staged_total": "counter",
    "imageregion_prefetch_hits_total": "counter",
    "imageregion_prefetch_skipped_total": "counter",
    "imageregion_qos_shed_total": "counter",
    "imageregion_qos_dequeued_total": "counter",
    "imageregion_qos_interactive_jumps_total": "counter",
    "imageregion_provenance_total": "counter",
    "imageregion_provenance_flags_total": "counter",
    "imageregion_flight_events": "gauge",
    "imageregion_flight_events_total": "counter",
    "imageregion_flight_dumps_total": "counter",
    "imageregion_diskcache_writes_total": "counter",
    "imageregion_diskcache_write_errors_total": "counter",
    "imageregion_diskcache_write_dropped_total": "counter",
    "imageregion_diskcache_corrupt_total": "counter",
    "imageregion_diskcache_bytes": "gauge",
    "imageregion_diskcache_entries": "gauge",
    "imageregion_warmstate_snapshots_total": "counter",
    "imageregion_warmstate_snapshot_errors_total": "counter",
    "imageregion_warmstate_snapshot_age_seconds": "gauge",
    "imageregion_warmstate_snapshot_duration_ms": "gauge",
    "imageregion_rehydrate_running": "gauge",
    "imageregion_rehydrate_items_total": "gauge",
    "imageregion_rehydrate_items_done": "gauge",
    "imageregion_rehydrate_errors_total": "counter",
    "imageregion_rehydrate_duration_ms": "gauge",
    "imageregion_rehydrate_bytes_promoted_total": "counter",
    "imageregion_rehydrate_planes_restaged_total": "counter",
    "imageregion_rehydrate_executables_loaded_total": "counter",
    "imageregion_execcache_hits": "counter",
    "imageregion_execcache_misses": "counter",
    "imageregion_execcache_loaded_total": "counter",
    "imageregion_execcache_saved_total": "counter",
    "imageregion_prefetch_budget_scale": "gauge",
    "imageregion_slo_burn_rate": "gauge",
    "imageregion_slo_breach": "gauge",
    "imageregion_slo_breaches_total": "counter",
    "imageregion_shape_dispatches_total": "counter",
    "imageregion_shape_device_ms_total": "counter",
    "imageregion_shape_device_ms_mean": "gauge",
    "imageregion_shape_estimated_flops": "gauge",
    "imageregion_shape_estimated_bytes": "gauge",
    "imageregion_pressure_level": "gauge",
    "imageregion_pressure_level_transitions_total": "counter",
    "imageregion_pressure_signal": "gauge",
    "imageregion_pressure_steps_engaged": "gauge",
    "imageregion_pressure_step_engaged": "gauge",
    "imageregion_pressure_step_transitions_total": "counter",
    "imageregion_decision_total": "counter",
    "imageregion_federation_manifest_version": "gauge",
    "imageregion_federation_members": "gauge",
    "imageregion_federation_agreements_total": "counter",
    "imageregion_federation_gossip_total": "counter",
    "imageregion_federation_shard_transfers_total": "counter",
    "imageregion_federation_transfer_bytes_total": "counter",
    "imageregion_federation_remote_prestage_total": "counter",
    "imageregion_federation_quorum_quorate": "gauge",
    "imageregion_federation_quorum_reachable_hosts": "gauge",
    "imageregion_federation_quorum_hosts": "gauge",
    "imageregion_federation_quorum_transitions_total": "counter",
    "imageregion_federation_quorum_refusals_total": "counter",
    "imageregion_partition_rules": "gauge",
    "imageregion_partition_blocked_total": "counter",
    "imageregion_fleet_slo_hosts": "gauge",
    "imageregion_fleet_slo_dropped_hosts_total": "counter",
    "imageregion_fleet_slo_burn_rate": "gauge",
    "imageregion_fleet_slo_host_burn_rate": "gauge",
    "imageregion_sentinel_member_drift": "gauge",
    "imageregion_sentinel_drift": "gauge",
    "imageregion_sentinel_keys": "gauge",
    "imageregion_sentinel_ticks_total": "counter",
    "imageregion_sentinel_observations_total": "counter",
    "imageregion_sentinel_drifts_total": "counter",
    "imageregion_sentinel_recoveries_total": "counter",
    "imageregion_sentinel_bundles_total": "counter",
    "imageregion_sentinel_bundle_errors_total": "counter",
    "imageregion_sentinel_live_p99_ms": "gauge",
    "imageregion_sentinel_baseline_p99_ms": "gauge",
    **{name: "histogram" for name in _COST_HIST_FIELDS.values()},
}

METRIC_HELP: Dict[str, str] = {
    "imageregion_batcher_queue_wait_max_ms":
        "High-water dispatched queue wait (cancelled waits excluded)",
    "imageregion_watchdog_fires_total":
        "Watchdog healings by action (requeue-group, drop-connection, "
        "escalate)",
    "imageregion_httpcache_304_total":
        "If-None-Match revalidations answered 304 with zero render/"
        "admission/token work",
    "imageregion_httpcache_head_total":
        "HEAD requests answered headers-only without a render",
    "imageregion_httpcache_ims_requests_total":
        "If-Modified-Since-only revalidation arrivals (ETag absent)",
    "imageregion_httpcache_peer_hits_total":
        "Authority byte-probes answered resident (peer has the bytes)",
    "imageregion_httpcache_peer_fetches_total":
        "Renders avoided by fetching bytes from a fleet peer's tier",
    "imageregion_httpcache_peer_fallbacks_total":
        "Peer probe/fetch failures that fell back to the render path",
    "imageregion_httpcache_peer_putbacks_total":
        "Stolen-render bytes written back to the shard authority",
    "imageregion_fleet_member_planes":
        "HBM-resident plane entries owned by the member (shard size)",
    "imageregion_fleet_stolen_total":
        "Renders the member stole from a backlogged peer (no cache "
        "adoption)",
    "imageregion_fleet_failed_over_total":
        "Dead-member shard work adopted hash-ring-next by the member",
    "imageregion_drain_state":
        "Fleet-member drain state (0 active, 1 draining, 2 drained)",
    "imageregion_drain_prestaged_planes_total":
        "Handoff planes pre-staged WARM onto ring successors by drains",
    "imageregion_workload_requests_total":
        "Device-workloads requests by kind (mask_device/mask_host = "
        "which rasterizer served the mask; overlay; animation)",
    "imageregion_pyramid_jobs_total":
        "Pyramid build job lifecycle transitions by action "
        "(submitted, resumed, completed, failed, cancelled)",
    "imageregion_pyramid_jobs_active":
        "Pyramid build jobs currently running",
    "imageregion_pyramid_levels_committed_total":
        "Pyramid levels atomically committed (tmp-dir os.replace)",
    "imageregion_animation_streams_total":
        "z/t animation streams started",
    "imageregion_animation_frames_total":
        "Animation frames written to clients",
    "imageregion_animation_cancelled_total":
        "Animation streams cancelled mid-flight (client disconnect "
        "or deadline) with remaining device work cancelled",
    "imageregion_animation_first_frame_ms":
        "Last animation stream's first-frame latency (the bounded "
        "first-frame-out contract's live gauge)",
    "imageregion_flight_events":
        "Events currently held in the flight-recorder ring",
    "imageregion_diskcache_corrupt_total":
        "Disk byte-cache entries rejected by checksum/format checks",
    "imageregion_warmstate_snapshot_age_seconds":
        "Seconds since the last warm-state manifest write (0 = never)",
    "imageregion_rehydrate_running":
        "1 while the boot rehydrator is replaying the warm-state "
        "manifest",
    "imageregion_rehydrate_bytes_promoted_total":
        "Disk byte-cache bytes promoted to the memory tier at boot",
    "imageregion_execcache_loaded_total":
        "Built kernel and codec libraries loaded from the build store",
    "imageregion_prefetch_budget_scale":
        "Live prefetch budget scale (1 full, 0 paused by the ladder)",
    "imageregion_qos_shed_total":
        "Per-session fairness sheds by QoS class (503 + Retry-After)",
    "imageregion_qos_dequeued_total":
        "Fleet-router dequeues by QoS class (weighted two-class queue)",
    "imageregion_qos_interactive_jumps_total":
        "Interactive dequeues that jumped a waiting bulk backlog",
    "imageregion_slo_burn_rate":
        "Error-budget burn rate per objective and window",
    "imageregion_slo_breach":
        "1 while the objective is in multi-window breach",
    "imageregion_shape_estimated_flops":
        "Kernel-count f32 operation estimate of the group shape's launches",
    "imageregion_shape_estimated_bytes":
        "Kernel-count byte estimate of the group shape's launches",
    "imageregion_pressure_level":
        "Folded resource-pressure level (0 ok, 1 elevated, 2 critical)",
    "imageregion_pressure_signal":
        "Raw pressure-signal reading (fraction of budget, or raw "
        "depth/ms)",
    "imageregion_pressure_steps_engaged":
        "Brownout ladder steps currently engaged (prefix of the "
        "configured ladder)",
    "imageregion_pressure_step_engaged":
        "1 while the named ladder step is engaged",
    "imageregion_pressure_step_transitions_total":
        "Ladder step engage/release transitions",
    "imageregion_decision_total":
        "Control-plane decision-ledger records by kind and verdict",
    "imageregion_federation_manifest_version":
        "Shard epoch of the agreed fleet manifest",
    "imageregion_federation_agreements_total":
        "Join-time manifest agreement outcomes by reason",
    "imageregion_federation_gossip_total":
        "Membership gossip round outcomes by reason",
    "imageregion_federation_shard_transfers_total":
        "Warm HBM planes shipped cross-host over shard_transfer",
    "imageregion_federation_remote_prestage_total":
        "Predicted-plane prestage hints sent to remote owners",
    "imageregion_federation_quorum_quorate":
        "1 while this host can gossip with a strict majority of "
        "manifest hosts, 0 while fenced",
    "imageregion_federation_quorum_reachable_hosts":
        "Manifest hosts (self included) heard from within "
        "suspect-after-s",
    "imageregion_federation_quorum_transitions_total":
        "Quorum fence/restore transitions by verdict",
    "imageregion_federation_quorum_refusals_total":
        "State-changing actions refused while fenced, by action",
    "imageregion_partition_rules":
        "Injected link-partition rules active in this process",
    "imageregion_partition_blocked_total":
        "Sidecar calls blocked by an injected link partition, by mode",
    "imageregion_fleet_slo_hosts":
        "Hosts currently contributing SLO window buckets to the "
        "fleet burn",
    "imageregion_fleet_slo_dropped_hosts_total":
        "SLO bucket ingests dropped by the host-cardinality bound",
    "imageregion_fleet_slo_burn_rate":
        "Fleet-aggregated error-budget burn per objective and window",
    "imageregion_fleet_slo_host_burn_rate":
        "Per-host error-budget burn per objective and window",
    "imageregion_sentinel_member_drift":
        "Per-member drift verdict off the gossip merge (1 = drifting)",
    "imageregion_sentinel_drift":
        "1 while the local perf sentinel holds a confirmed drift "
        "verdict",
    "imageregion_sentinel_keys":
        "Route classes the sentinel currently tracks quantiles for",
    "imageregion_sentinel_ticks_total":
        "Drift-evaluation windows the local sentinel has closed",
    "imageregion_sentinel_observations_total":
        "Requests the local sentinel has sketched",
    "imageregion_sentinel_drifts_total":
        "Per-key drift confirmations (confirm-ticks consecutive "
        "breaching windows)",
    "imageregion_sentinel_recoveries_total":
        "Per-key drift recoveries (recover-ticks consecutive clean "
        "windows)",
    "imageregion_sentinel_live_p99_ms":
        "Live windowed p99 latency per route class (sketch estimate)",
    "imageregion_sentinel_baseline_p99_ms":
        "Self-learned rolling-baseline p99 per route class",
    "imageregion_sentinel_bundles_total":
        "Forensic incident bundles written on confirmed drift",
    "imageregion_sentinel_bundle_errors_total":
        "Incident-bundle captures that failed (drift verdict stands)",
}

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_of(line: str) -> str:
    name = line.split("{", 1)[0].split(" ", 1)[0]
    for suffix in _HIST_SUFFIXES:
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if METRIC_TYPES.get(base) == "histogram":
                return base
    return name


def finalize_exposition(lines: List[str],
                        openmetrics: bool = False) -> str:
    """Series grouped by family (first seen first), one ``# HELP`` and one
    ``# TYPE`` line per family, free comments last.

    ``openmetrics=True`` makes a body a strict OpenMetrics parser accepts
    (the negotiated scrape that carries exemplars): free comments are
    dropped, ``untyped`` becomes ``unknown``, a counter family ending
    ``_total`` declares its metadata under the name without the suffix,
    and a counter that cannot (a legacy name, or one whose short name is a
    family of its own) is declared ``unknown``.  The caller appends
    ``# EOF``."""
    families: Dict[str, List[str]] = {}
    comments: List[str] = []
    for line in lines:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith("#"):
            if not line.startswith(("# TYPE", "# HELP")):
                comments.append(line)
            continue
        families.setdefault(_family_of(line), []).append(line)
    out: List[str] = []
    for fam, series in families.items():
        mtype = METRIC_TYPES.get(fam, "untyped")
        meta_name = fam
        if openmetrics:
            if mtype == "counter":
                base = fam[:-len("_total")] if fam.endswith("_total") \
                    else None
                if base and base not in families:
                    meta_name = base
                else:
                    mtype = "unknown"
            elif mtype == "untyped":
                mtype = "unknown"
        out.append(f"# HELP {meta_name} "
                   f"{METRIC_HELP.get(fam, fam.replace('_', ' '))}")
        out.append(f"# TYPE {meta_name} {mtype}")
        out += series
    if not openmetrics:
        out += comments
    return "\n".join(out) + "\n"


def request_metric_lines(exemplars: bool = False) -> List[str]:
    """The request histogram (with its exemplar tails when ``exemplars``:
    only for a scrape that asked for OpenMetrics) and totals, the
    conditional-HTTP counters, the SLO burn gauges, the sentinel's
    families and the flight recorder's ring state."""
    lines = REQUEST_HIST.series("imageregion_request_duration_ms",
                                exemplars=exemplars)
    for (route, status), n in sorted(request_totals().items()):
        lines.append(f'imageregion_requests_total{{route="{route}",'
                     f'status="{status}"}} {n}')
    return (lines + HTTPCACHE.metric_lines() + SLO.metric_lines()
            + SENTINEL.metric_lines() + FLIGHT.metric_lines())


def resilience_metric_lines(breaker=None) -> List[str]:
    """The sidecar client's breaker (``breaker``: a frontend's; None: no
    gauge), sheds by reason, the sidecar retries, deadline cancellations,
    degraded renders, supervisor restarts and the attempts histogram; the
    pressure governor's families, watchdog fires, the decision ledger's
    counts, the federation's (agreements, gossip, transfers, the quorum
    and the link partitions, the fleet SLO burn), the workload routes'
    counters and the wire's."""
    lines: List[str] = []
    if breaker is not None:
        # 0 closed, 1 half-open, 2 open (utils.transient).
        lines += [f"imageregion_breaker_state {breaker.state}",
                  f"imageregion_breaker_opens_total {breaker.opens}"]
    with RESILIENCE._lock:
        shed = sorted(RESILIENCE.shed.items())
        retries = sorted(RESILIENCE.retries.items())
        cancelled = RESILIENCE.deadline_cancelled
        degraded = RESILIENCE.degraded_renders
        restarts = RESILIENCE.supervisor_restarts
    lines += [f'imageregion_shed_total{{reason="{r}"}} {n}'
              for r, n in shed]
    lines += [f'imageregion_retries_total{{op="{op}"}} {n}'
              for op, n in retries]
    lines += [f"imageregion_deadline_cancelled_total {cancelled}",
              f"imageregion_degraded_renders_total {degraded}",
              f"imageregion_supervisor_restarts_total {restarts}"]
    lines += RESILIENCE.attempts_hist.series("imageregion_retry_attempts")
    return (lines + PRESSURE.metric_lines() + WATCHDOG.metric_lines()
            + DRAIN.metric_lines() + AUTOSCALER.metric_lines()
            + FEDERATION.metric_lines() + QUORUM.metric_lines()
            + DECISIONS.metric_lines() + FED_SLO.metric_lines()
            + WORKLOADS.metric_lines() + WIRE.metric_lines())


def fleet_metric_lines(router=None, single_flight=None) -> List[str]:
    """The fleet's families (JAX ``fleet_metric_lines``): the routed,
    stolen and failed-over counters and the hot-key families; the
    fleet-wide single-flight table (it moves above the router, off the
    services whose lines would carry it); and, with a live ``router``
    (``parallel.fleet.FleetRouter``, duck-typed), the member count, the
    healthy count and each member's depth, in-flight renders, health and
    resident planes."""
    lines = FLEET.metric_lines() + HOTKEY.metric_lines()
    if single_flight is not None:
        lines += [f"imageregion_singleflight_hits {single_flight.hits}",
                  f"imageregion_singleflight_misses {single_flight.misses}",
                  "imageregion_singleflight_inflight "
                  f"{single_flight.inflight()}"]
    if router is None:
        return lines
    lines += [f"imageregion_fleet_members {len(router.order)}",
              "imageregion_fleet_members_healthy "
              f"{len(router.healthy_members())}"]
    for name in router.order:
        member = router.members[name]
        label = f'{{member="{name}"}}'
        lines += [
            f"imageregion_fleet_member_depth{label} "
            f"{router.member_depth(name)}",
            f"imageregion_fleet_member_inflight{label} "
            f"{router.member_inflight(name)}",
            f"imageregion_fleet_member_healthy{label} "
            f"{1 if member.healthy else 0}",
            f"imageregion_fleet_member_planes{label} "
            f"{member.resident_planes()}"]
    return lines


def with_label(lines: List[str], label: str) -> List[str]:
    """``lines`` with ``label`` (``key="value"``) added to every series;
    comments dropped.  A sidecar's series carry ``process="sidecar"`` in
    a frontend's scrape."""
    out = []
    for line in lines:
        if not line or line.startswith("#"):
            continue
        name, sep, rest = line.partition("{")
        if sep:
            out.append(f"{name}{{{label},{rest}" if not rest.startswith("}")
                       else f"{name}{{{label}{rest}")
        else:
            name, _, value = line.partition(" ")
            out.append(f"{name}{{{label}}} {value}")
    return out


def session_metric_lines() -> List[str]:
    """The session model's, the prefetcher's and the QoS families, and the
    open-loop load model's counters (only a process replaying arrivals
    carries them)."""
    return (SESSIONS.metric_lines() + PREFETCH.metric_lines()
            + QOS.metric_lines() + LOADMODEL.metric_lines())


def device_metric_lines(services) -> List[str]:
    """The byte caches, raw cache, single-flight and batcher gauges of a
    handler's services (duck-typed: ``server.handler
    .ImageRegionServices``).  Each byte-cache tier with counters gives
    ``imageregion_cache_{hits,misses}`` (and ``_evictions`` where the tier
    counts them) under ``cache`` and ``tier``, as the JAX package
    exports them, whether the cache is enabled or not."""
    lines: List[str] = []
    for name in ("image_region", "pixels_metadata", "shape_mask"):
        stack = getattr(getattr(services, "caches", None), name, None)
        for i, tier in enumerate(getattr(stack, "tiers", ())):
            hits = getattr(tier, "hits", None)
            if hits is None:
                continue
            lb = f'{{cache="{name}",tier="{i}"}}'
            lines += [f"imageregion_cache_hits{lb} {hits}",
                      f"imageregion_cache_misses{lb} {tier.misses}"]
            evictions = getattr(tier, "evictions", None)
            if evictions is not None:
                lines.append(f"imageregion_cache_evictions{lb} {evictions}")
    cache = getattr(services, "raw_cache", None)
    if cache is not None:
        lines += [f"imageregion_rawcache_hits {cache.hits}",
                  f"imageregion_rawcache_misses {cache.misses}",
                  f"imageregion_rawcache_bytes {cache.size_bytes}",
                  f"imageregion_rawcache_evictions {cache.evictions}",
                  f"imageregion_planecache_hits {cache.plane_hits}",
                  f"imageregion_planecache_misses {cache.plane_misses}"]
    single_flight = getattr(services, "single_flight", None)
    if single_flight is not None:
        lines += [f"imageregion_singleflight_hits {single_flight.hits}",
                  f"imageregion_singleflight_misses {single_flight.misses}",
                  "imageregion_singleflight_inflight "
                  f"{single_flight.inflight()}"]
    renderer = getattr(services, "renderer", None)
    if hasattr(renderer, "queue_depth"):
        lines += [
            f"imageregion_batches_dispatched {renderer.batches_dispatched}",
            f"imageregion_tiles_rendered {renderer.tiles_rendered}",
            f"imageregion_batcher_queue_depth {renderer.queue_depth()}",
            f"imageregion_pipeline_inflight {renderer.inflight()}",
            f"imageregion_batcher_max_batch {renderer.max_batch}",
            "imageregion_batcher_queue_wait_max_ms "
            f"{round(renderer.queue_wait_max_ms, 3)}",
        ]
    lines += SHAPE_COSTS.metric_lines()
    # The warm-state families, always (as in JAX); the build store's only
    # where the app has one (persistence on).
    lines += PERSIST.metric_lines()
    store = getattr(renderer, "exec_cache", None)
    if store is not None:
        lines += [f"imageregion_execcache_hits {store.hits}",
                  f"imageregion_execcache_misses {store.misses}",
                  f"imageregion_execcache_loaded_total {store.loaded}",
                  f"imageregion_execcache_saved_total {store.saved}"]
    return lines


def reset() -> None:
    """Test isolation: clear every process-global accumulator."""
    TRACES.reset()
    REQUEST_HIST.reset()
    with _REQ_LOCK:
        _REQ_TOTALS.clear()
    RESILIENCE.reset()
    WATCHDOG.reset()
    WIRE.reset()
    HTTPCACHE.reset()
    FLEET.reset()
    HOTKEY.reset()
    DRAIN.reset()
    AUTOSCALER.reset()
    LOADMODEL.reset()
    WORKLOADS.reset()
    SESSIONS.reset()
    PREFETCH.reset()
    QOS.reset()
    for hist in COST_HISTS.values():
        hist.reset()
    COST_TOPK.reset()
    PROVENANCE.reset()
    READINESS.reset()
    FLIGHT.reset()
    PERSIST.reset()
    SLO.reset()
    SHAPE_COSTS.reset()
    PRESSURE.reset()
    DECISIONS.reset()
    FEDERATION.reset()
    FED_SLO.reset()
    QUORUM.reset()
    SENTINEL.reset()
    # The decision ledger imports this module; reset it from here so one
    # call isolates the whole forensics plane.
    from . import decisions
    decisions.LEDGER.reset()
