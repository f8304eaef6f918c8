"""The ordered shutdown chain of the signal path.

Counterpart of the JAX package's ``server/shutdown.py``.  On SIGTERM or
SIGINT ``server.app.run_app`` runs one chain of hooks while the services
are still live, before aiohttp's cleanup closes the caches and the pixel
stores: with a fleet, the ``fleet-quiesce`` hook first (every member stops
taking routes, so the snapshot sees a settled shard map), then the
warm-state snapshot (it lists what is hot), the build store's drain (a
library being stored now is one the next life does not build), the
flight-recorder dump last (the black box lands even if a hook before it
failed).  Each hook is guarded, so one failing never skips the rest, and
the chain runs once: ``run`` never raises.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Tuple

log = logging.getLogger("omero_ms_image_region_tpu_torch.shutdown")


class ShutdownChain:
    """Ordered, guarded, once-only shutdown hooks."""

    def __init__(self):
        self._hooks: List[Tuple[str, Callable[[], object]]] = []
        self._ran = False
        self._lock = threading.Lock()

    def add(self, name: str, fn: Callable[[], object]) -> None:
        self._hooks.append((name, fn))

    def run(self, reason: str = "") -> List[Tuple[str, bool]]:
        """Run every hook in the order added; ``[(name, ok)]``.  A second
        call (SIGTERM, then SIGINT) is a no-op returning ``[]``."""
        with self._lock:
            if self._ran:
                return []
            self._ran = True
        results: List[Tuple[str, bool]] = []
        for name, fn in self._hooks:
            try:
                fn()
                results.append((name, True))
            except Exception:
                try:
                    log.warning("shutdown hook %r failed (%s); continuing "
                                "the chain", name, reason, exc_info=True)
                except Exception:
                    pass
                results.append((name, False))
        return results


def build_shutdown_chain(config, services=None,
                         fleet_router=None) -> ShutdownChain:
    """The chain of an app: ``fleet-quiesce`` (with a fleet router),
    ``warmstate-snapshot`` (with persistence on), ``execcache-drain`` (with
    the build store) and ``flight-dump`` to
    ``telemetry.flight-recorder-dir``, in that order.  ``services`` (the
    handler's ``ImageRegionServices``) None and no router give the dump
    alone."""
    from ..utils import telemetry

    chain = ShutdownChain()
    if fleet_router is not None:
        def quiesce():
            # Flag flips only: the chain runs on its own thread, off the
            # loop that owns the router's queues.  The lanes see the flags
            # at their next pop; a whole-process SIGTERM has no surviving
            # member to hand a shard to, so no handoff.
            for name in fleet_router.order:
                fleet_router.members[name].draining = True
                telemetry.DRAIN.set_state(name, "draining")
            telemetry.FLIGHT.record("drain.phase", member="*",
                                    phase="quiesce-all", reason="shutdown")
        chain.add("fleet-quiesce", quiesce)
    warmstate = getattr(services, "warmstate", None)
    if warmstate is not None:
        chain.add("warmstate-snapshot", warmstate.snapshot_now)
    store = getattr(getattr(services, "renderer", None), "exec_cache", None)
    if store is not None:
        chain.add("execcache-drain", lambda: store.drain(timeout_s=5.0))

    def dump():
        telemetry.FLIGHT.dump(config.telemetry.flight_recorder_dir,
                              "shutdown")

    chain.add("flight-dump", dump)
    return chain
