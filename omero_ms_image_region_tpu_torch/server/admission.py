"""Admission control: a bounded queue in front of the render pipeline.

Counterpart of the JAX package's ``server/admission.py::
AdmissionController``.  The batcher queues without bound, so under overload
every request would wait toward a timeout.  The controller refuses work it
cannot finish with ``503 + Retry-After`` (``errors.OverloadedError``)
before any read or render is paid for, when

* the admitted-but-unfinished renders reach ``max_queue`` (reason
  ``queue-full``), or
* the estimated wait (in-flight renders x the EWMA service time / the
  renderer's device lanes) exceeds the caller's remaining deadline
  (reason ``deadline``): admitting would turn a 503 now into a 504 later
  that held a slot all along.

The handler claims a slot inside the single-flight producer, so a
coalesced follower claims none.  Not ported: the per-session token buckets
(``sessions.enabled``) and the pressure governor's scaling of the bound
(``pressure.enabled``); both are off in the JAX default, and the config
loader refuses them.

Event-loop confined (``admit``/``release`` run on the loop thread), so no
lock.
"""

from __future__ import annotations

import time
from typing import Optional

from ..utils import telemetry, transient
from .errors import OverloadedError


class AdmissionController:
    """Depth- and deadline-aware load shedding for the render path."""

    # EWMA weight of the per-render service time (seconds).
    ALPHA = 0.2

    def __init__(self, max_queue: int, renderer=None,
                 retry_after_s: float = 1.0):
        if max_queue < 1:
            raise ValueError("admission max_queue must be >= 1")
        self.max_queue = max_queue
        self.renderer = renderer          # duck-typed; lanes estimate
        self.retry_after_s = retry_after_s
        self.inflight = 0                 # admitted, not yet released
        self.ewma_s: Optional[float] = None
        self.admitted_total = 0
        self.shed_total = 0

    def _lanes(self) -> int:
        return max(1, getattr(self.renderer, "device_lanes", 1))

    def effective_max_queue(self) -> int:
        """The depth bound now: ``max_queue`` (the JAX controller scales
        it under the pressure governor, which the port does not have)."""
        return self.max_queue

    def estimated_wait_ms(self) -> float:
        """Expected queueing delay of a request admitted now."""
        if self.ewma_s is None:
            return 0.0
        return self.inflight * self.ewma_s * 1000.0 / self._lanes()

    def _shed(self, reason: str, message: str, wait_ms: float):
        self.shed_total += 1
        telemetry.RESILIENCE.count_shed(reason)
        raise OverloadedError(message, retry_after_s=max(
            self.retry_after_s, wait_ms / 1000.0))

    def admit(self) -> float:
        """Claim a slot or shed.  Returns the admission time to hand back
        to :meth:`release`."""
        max_queue = self.effective_max_queue()
        if self.inflight >= max_queue:
            self._shed("queue-full",
                       f"admission queue full ({self.inflight} renders "
                       f"in flight, bound {max_queue})",
                       self.estimated_wait_ms())
        remaining = transient.remaining_ms()
        if remaining is not None:
            est = self.estimated_wait_ms()
            if est > remaining:
                self._shed("deadline",
                           f"estimated wait {est:.0f} ms exceeds "
                           f"remaining deadline budget {remaining:.0f} ms",
                           est)
        self.inflight += 1
        self.admitted_total += 1
        return time.monotonic()

    def release(self, t_admit: float, completed: bool = True) -> None:
        """Free the slot; a completed render feeds the service-time EWMA
        (sheds and failures must not drag the estimate down)."""
        self.inflight = max(0, self.inflight - 1)
        if not completed:
            return
        dur = time.monotonic() - t_admit
        self.ewma_s = (dur if self.ewma_s is None
                       else self.ewma_s + self.ALPHA * (dur - self.ewma_s))
