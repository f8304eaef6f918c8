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
coalesced follower claims none.

With ``sessions.enabled`` a per-session fairness gate runs first
(:class:`SessionTokenBuckets`, :meth:`AdmissionController.admit_session`):
each caller, before single-flight (like the ACL check), draws a token from
its session's bucket, and a session over its budget is refused with a 503
of reason ``fairness`` while every other session's admission stays as it
was.  A request the global bound then refuses gets its token back.  A mask
GET draws a token too (it has no global leg).  While the pressure
governor's ``tighten_admission`` step is engaged (``server.pressure``), the
bound is scaled by ``pressure.admission-scale`` and its sheds have reason
``pressure``.  With ``qos.enabled`` a bulk request (``pressure.is_bulk``:
a projection or a full plane) draws ``qos.bulk-cost`` tokens, and its
refund and Retry-After use the same cost; each fairness shed is counted by
class in ``telemetry.QOS`` and recorded as a ``qos.shed`` flight event,
as in the JAX app.

Event-loop confined (``admit``/``release`` run on the loop thread), so no
lock.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional

from ..utils import telemetry, transient
from .errors import OverloadedError


class SessionTokenBuckets:
    """Per-session token buckets over the request ctx's session key.

    Each session holds at most ``burst`` tokens, refilled at
    ``refill_per_s``; an interactive request costs 1 token, a bulk one
    ``bulk_cost``.  The table is a bounded LRU
    (``max_sessions``): an evicted session starts again with a full burst.
    The key is ``ctx.omero_session_key`` as the session store resolved it
    (None: the shared anonymous bucket)."""

    ANONYMOUS = ""

    def __init__(self, refill_per_s: float, burst: float,
                 max_sessions: int = 4096, bulk_cost: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if refill_per_s <= 0:
            raise ValueError("bucket refill_per_s must be > 0")
        if burst < 1:
            raise ValueError("bucket burst must be >= 1")
        if max_sessions < 1:
            raise ValueError("bucket max_sessions must be >= 1")
        if bulk_cost < 1:
            raise ValueError("bucket bulk_cost must be >= 1")
        self.refill_per_s = float(refill_per_s)
        self.burst = float(burst)
        self.max_sessions = int(max_sessions)
        self.bulk_cost = float(bulk_cost)
        self.clock = clock
        # session -> [tokens, t_last]; event-loop confined.
        self._buckets: "OrderedDict[str, list]" = OrderedDict()
        self.taken_total = 0
        self.refused_total = 0

    def __len__(self) -> int:
        return len(self._buckets)

    def _bucket(self, session_key: Optional[str]) -> list:
        key = session_key if session_key else self.ANONYMOUS
        bucket = self._buckets.get(key)
        now = self.clock()
        if bucket is None:
            bucket = [self.burst, now]
            self._buckets[key] = bucket
            while len(self._buckets) > self.max_sessions:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(key)
            bucket[0] = min(self.burst,
                            bucket[0] + (now - bucket[1]) * self.refill_per_s)
            bucket[1] = now
        return bucket

    def try_take(self, session_key: Optional[str],
                 cost: float = 1.0) -> bool:
        """Draw ``cost`` tokens; False when the session is over budget."""
        bucket = self._bucket(session_key)
        if bucket[0] >= cost:
            bucket[0] -= cost
            self.taken_total += 1
            return True
        self.refused_total += 1
        return False

    def refund(self, session_key: Optional[str], cost: float = 1.0) -> None:
        """Give back tokens of a request that was refused afterwards."""
        bucket = self._bucket(session_key)
        bucket[0] = min(self.burst, bucket[0] + cost)

    def retry_after_s(self, session_key: Optional[str],
                      cost: float = 1.0) -> float:
        """Seconds until the session's bucket covers ``cost``."""
        bucket = self._bucket(session_key)
        return max(0.0, cost - bucket[0]) / self.refill_per_s


class AdmissionController:
    """Depth- and deadline-aware load shedding for the render path."""

    # EWMA weight of the per-render service time (seconds).
    ALPHA = 0.2

    def __init__(self, max_queue: int, renderer=None,
                 retry_after_s: float = 1.0,
                 session_buckets: Optional[SessionTokenBuckets] = None):
        if max_queue < 1:
            raise ValueError("admission max_queue must be >= 1")
        self.max_queue = max_queue
        self.renderer = renderer          # duck-typed; lanes estimate
        self.retry_after_s = retry_after_s
        self.session_buckets = session_buckets  # None: sessions unmetered
        self.inflight = 0                 # admitted, not yet released
        self.ewma_s: Optional[float] = None
        self.admitted_total = 0
        self.shed_total = 0

    def _lanes(self) -> int:
        return max(1, getattr(self.renderer, "device_lanes", 1))

    def effective_max_queue(self) -> int:
        """The depth bound now: ``max_queue``, scaled down while the
        pressure governor's ``tighten_admission`` step is engaged
        (shedding turns pressure-aware, not only depth-aware)."""
        from .pressure import active
        governor = active()
        if governor is None:
            return self.max_queue
        return max(1, int(self.max_queue * governor.admission_scale()))

    def estimated_wait_ms(self) -> float:
        """Expected queueing delay of a request admitted now."""
        if self.ewma_s is None:
            return 0.0
        return self.inflight * self.ewma_s * 1000.0 / self._lanes()

    def _shed(self, reason: str, message: str, wait_ms: float, **event):
        """Count the shed, record its ``admission.shed`` flight event
        (``event``: the JAX event's fields) and raise the 503."""
        self.shed_total += 1
        telemetry.RESILIENCE.count_shed(reason)
        telemetry.FLIGHT.record("admission.shed", reason=reason,
                                inflight=self.inflight, **event)
        raise OverloadedError(message, retry_after_s=max(
            self.retry_after_s, wait_ms / 1000.0))

    def admit_session(self, ctx):
        """The per-session fairness gate, per caller and before
        single-flight, so one session's 503 never reaches a coalesced
        follower of another.  Returns the debit for
        :meth:`refund_session` (None when unmetered); raises
        ``OverloadedError`` (reason ``fairness``) over budget."""
        buckets = self.session_buckets
        if buckets is None or ctx is None:
            return None
        from .pressure import is_bulk
        bulk = is_bulk(ctx)
        cost = buckets.bulk_cost if bulk else 1.0
        session = ctx.omero_session_key
        if buckets.try_take(session, cost):
            return (session, cost)
        self.shed_total += 1
        cls = "bulk" if bulk else "interactive"
        telemetry.RESILIENCE.count_shed("fairness")
        telemetry.QOS.count_shed(cls)
        telemetry.FLIGHT.record(
            "qos.shed", reason="fairness", cls=cls,
            session=(session or "-")[:16], cost=cost)
        raise OverloadedError(
            "session over its admission budget",
            retry_after_s=max(self.retry_after_s,
                              buckets.retry_after_s(session, cost)))

    def refund_session(self, debit) -> None:
        """Give back an :meth:`admit_session` debit whose request the
        global bound (or the leader it coalesced onto) refused."""
        if debit is not None and self.session_buckets is not None:
            self.session_buckets.refund(*debit)

    def admit(self) -> float:
        """Claim a slot or shed.  Returns the admission time to hand back
        to :meth:`release`."""
        max_queue = self.effective_max_queue()
        if self.inflight >= max_queue:
            self._shed("pressure" if max_queue < self.max_queue
                       else "queue-full",
                       f"admission queue full ({self.inflight} renders "
                       f"in flight, bound {max_queue})",
                       self.estimated_wait_ms(), max_queue=max_queue)
        remaining = transient.remaining_ms()
        if remaining is not None:
            est = self.estimated_wait_ms()
            if est > remaining:
                self._shed("deadline",
                           f"estimated wait {est:.0f} ms exceeds "
                           f"remaining deadline budget {remaining:.0f} ms",
                           est, est_wait_ms=round(est, 1),
                           remaining_ms=round(remaining, 1))
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
