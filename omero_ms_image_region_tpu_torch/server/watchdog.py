"""Stuck-lane watchdog with targeted healing.

Counterpart of the JAX package's ``server/watchdog.py``.  A device lane
whose group render has run far past its history (a wedged stream, a host
stall inside the group) raises no error: it holds its waiters until their
deadlines, or for ever.  The watchdog scans its targets on a cadence; each
target heals the smallest thing that works and returns what it did:

1. **requeue the group**: the stuck group's unsettled waiters go back to
   the head of their queue, and the other lane renders them
   (``server.batcher.BatchingRenderer.watchdog_scan``);
2. **drop the connection**: a hung sidecar wire (requests in flight, no
   frame received for ``watchdog.wire-hang-s``) is dropped, so the retry
   policy sends the idempotent calls again on a fresh connection
   (``server.sidecar.SidecarClient.watchdog_scan``);
3. **escalate**: a victim already healed ``escalate-after - 1`` times
   fails with ``ConnectionError`` (the app answers 503 with
   ``Retry-After``), and the event carries ``escalate=True`` for the
   callback.

Targets implement ``watchdog_scan(now) -> [{"action", "target",
"escalate", ...}, ...]``.  The watchdog keeps the cadence, counts fires
(``imageregion_watchdog_fires_total``) and relays escalations.  A scan that
raises is logged and never stops the loop.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

from ..utils import telemetry

log = logging.getLogger("omero_ms_image_region_tpu_torch.watchdog")


class Watchdog:
    """Tick-driven scan over registered targets."""

    def __init__(self, interval_s: float = 2.0,
                 escalate_cb: Optional[Callable[[dict], None]] = None):
        self.interval_s = max(0.05, interval_s)
        self.escalate_cb = escalate_cb
        self._targets: List[object] = []

    def add_target(self, target) -> None:
        if not hasattr(target, "watchdog_scan"):
            raise TypeError(
                f"watchdog target {target!r} has no watchdog_scan")
        self._targets.append(target)

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One scan over every target; returns the fire events."""
        now = time.monotonic() if now is None else now
        events: List[dict] = []
        for target in self._targets:
            try:
                events.extend(target.watchdog_scan(now) or [])
            except Exception:
                log.warning("watchdog scan failed on %r", target,
                            exc_info=True)
        for event in events:
            telemetry.WATCHDOG.count_fire(event.get("action", "?"))
            telemetry.FLIGHT.record("watchdog.fire", **{
                k: v for k, v in event.items() if k != "escalate"})
            log.warning("watchdog fired: %s on %s (%s)",
                        event.get("action"), event.get("target"),
                        {k: v for k, v in event.items()
                         if k not in ("action", "target")})
            if event.get("escalate") and self.escalate_cb is not None:
                try:
                    self.escalate_cb(event)
                except Exception:
                    log.warning("watchdog escalation callback failed",
                                exc_info=True)
        return events

    async def run(self) -> None:
        """The cadence loop (the app starts it as a task on startup)."""
        import asyncio

        while True:
            await asyncio.sleep(self.interval_s)
            self.tick()


def build_watchdog(config, renderer=None, clients=(),
                   escalate_cb=None) -> Watchdog:
    """A watchdog over the batcher (stuck lanes) and the sidecar clients
    (hung wires), with the config's thresholds
    (``server.config.WatchdogConfig``) pushed onto each."""
    wd = Watchdog(interval_s=config.interval_s, escalate_cb=escalate_cb)
    if renderer is not None and hasattr(renderer, "watchdog_scan"):
        renderer.watchdog_stall_factor = config.stall_factor
        renderer.watchdog_stall_min_s = config.stall_min_s
        renderer.watchdog_escalate_after = config.escalate_after
        wd.add_target(renderer)
    for client in clients:
        client.wire_hang_s = config.wire_hang_s
        client.watchdog_escalate_after = config.escalate_after
        wd.add_target(client)
    return wd
