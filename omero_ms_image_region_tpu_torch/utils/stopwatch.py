"""Stage timing spans (the reference's perf4j ``Slf4JStopWatch``).

Counterpart of the JAX package's ``utils/stopwatch.py``.  The reference
wraps each pipeline stage in a named stopwatch (``ImageRegionVerticle.java
:148``, ``ImageRegionRequestHandler.java:189,303,343,502,522``); the span
names are kept verbatim, so dashboards built on either service's logs read
this one.  Each span keeps a log-bucket histogram
(``utils.telemetry.Histogram``) exposed on ``/metrics``, and each recorded
duration also lands on the context's request traces
(``telemetry.observe_span``).
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict

from .telemetry import Histogram, observe_span

log = logging.getLogger("omero_ms_image_region_tpu_torch.perf")


class SpanStats:
    __slots__ = ("count", "total_ms", "max_ms", "hist")

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self.hist = Histogram()

    def add(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms
        self.hist.add(ms)

    def as_dict(self) -> dict:
        """Count, mean and exact max; p50/p95/p99 at bucket resolution
        (the upper bound of the bucket holding the quantile)."""
        return {
            "count": self.count,
            "total_ms": round(self.total_ms, 3),
            "mean_ms": round(self.total_ms / self.count, 3)
            if self.count else 0.0,
            "p50_ms": round(self.hist.quantile(0.5), 3),
            "p95_ms": round(self.hist.quantile(0.95), 3),
            "p99_ms": round(self.hist.quantile(0.99), 3),
            "max_ms": round(self.max_ms, 3),
        }


class StopWatchRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Dict[str, SpanStats] = {}

    def record(self, name: str, ms: float) -> None:
        with self._lock:
            stats = self._spans.get(name)
            if stats is None:
                stats = self._spans[name] = SpanStats()
            stats.add(ms)
        observe_span(name, ms)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {name: s.as_dict() for name, s in self._spans.items()}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()


REGISTRY = StopWatchRegistry()


def span_lines(registry: StopWatchRegistry = REGISTRY) -> list:
    """Exposition lines for every span: the count and mean series and the
    ``imageregion_span_ms`` histogram."""
    lines = []
    with registry._lock:
        items = sorted((name, s.count, s.total_ms, s.hist)
                       for name, s in registry._spans.items())
        for name, count, total_ms, hist in items:
            body = f'span="{name}"'
            mean = round(total_ms / count, 3) if count else 0.0
            lines += [f"imageregion_span_count{{{body}}} {count}",
                      f"imageregion_span_mean_ms{{{body}}} {mean}"]
            lines += hist.series("imageregion_span_ms", body)
    return lines


@contextmanager
def stopwatch(name: str, registry: StopWatchRegistry = REGISTRY):
    """Time a stage under a reference span name, e.g.
    ``PixelsService.readRegion``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1000.0
        registry.record(name, ms)
        log.debug("time[%s] = %.3f ms", name, ms)
