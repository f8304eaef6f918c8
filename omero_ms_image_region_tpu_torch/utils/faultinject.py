"""Seeded fault injection for the device lanes.

Counterpart of the JAX package's ``utils/faultinject.py``.  One
process-global :class:`FaultInjector` (installed from the
``fault-injection`` config block, or directly by tests) is consulted at
fixed hook points:

* the batcher's lane thread, before a group's launches: ``freeze_s``
  stalls the lane (a wedged stream), which the watchdog must heal, and
  ``maybe_device_error`` raises :class:`CudaError`, which fails the group;
* ``server.sidecar.SidecarClient``'s calls: ``wire_fault`` drops the
  request frame or sends half of it and closes the connection (the
  connection dies under the request), ``wire_delay_s`` delays it;
* the sidecar's request handling: ``sidecar_should_die`` kills the
  process on its Nth request (``die-after-requests``), mid-call, for the
  supervisor's drill.

Decisions come from one seeded ``random.Random`` under a lock, so a fixed
seed gives a reproducible schedule for a fixed call sequence.  Every rate
defaults to 0 and the injector to ``None``: a lane pays one ``is None``
check.

The link partitions (:class:`PartitionTable`, :data:`PARTITIONS`,
:func:`partitioned`) are the federation's netsplit drill: directional
``(src_host, dst_host)`` rules that the sidecar client consults before a
frame leaves this host, set and cleared over the ``partition`` wire op.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from random import Random
from typing import Dict, Optional


class CudaError(RuntimeError):
    """An injected device error, worded as PyTorch words a failed launch
    (``CUDA error: ...``).  The port has no transient class (a CUDA error
    is sticky; ``utils.transient``), so it fails the group's requests,
    where the JAX package's ``XlaRuntimeError`` is retried once."""


@dataclass
class FaultInjectionConfig:
    """``fault-injection`` config block.  ``seed`` None disables the layer
    (the default)."""

    seed: Optional[int] = None
    wire_drop_rate: float = 0.0       # request frame never sent
    wire_truncate_rate: float = 0.0   # partial frame then close
    wire_delay_rate: float = 0.0
    wire_delay_ms: float = 0.0
    device_error_rate: float = 0.0    # error raised in a group render
    freeze_rate: float = 0.0          # a device lane stalls freeze_ms
    freeze_ms: float = 0.0
    # At most this many freezes are injected (0 = unbounded): the
    # watchdog drills need "the first dispatch wedges, the requeue runs
    # clean", which a rate alone cannot promise.
    freeze_max: int = 0
    die_after_requests: int = 0       # sidecar self-kill mid-call

    def validate(self) -> "FaultInjectionConfig":
        for name in ("wire_drop_rate", "wire_truncate_rate",
                     "wire_delay_rate", "device_error_rate",
                     "freeze_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault-injection.{name} must be in "
                                 f"[0, 1], got {v}")
        if self.wire_delay_ms < 0 or self.freeze_ms < 0:
            raise ValueError("fault-injection delays must be >= 0")
        if self.freeze_max < 0:
            raise ValueError("fault-injection.freeze-max must be >= 0 "
                             "(0 = unbounded)")
        if self.die_after_requests < 0:
            raise ValueError("fault-injection.die-after-requests must "
                             "be >= 0")
        return self


class FaultInjector:
    """Seeded decisions, and counts of what was injected."""

    def __init__(self, config: FaultInjectionConfig):
        self.config = config.validate()
        self._rng = Random(config.seed)
        self._lock = threading.Lock()
        self._requests_seen = 0
        self.counts: Dict[str, int] = {}

    def _roll(self, rate: float, kind: str) -> bool:
        if rate <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < rate
            if hit:
                self.counts[kind] = self.counts.get(kind, 0) + 1
        return hit

    def wire_fault(self) -> Optional[str]:
        """``"drop"``, ``"truncate"`` or None for the frame about to be
        sent."""
        if self._roll(self.config.wire_drop_rate, "wire_drop"):
            return "drop"
        if self._roll(self.config.wire_truncate_rate, "wire_truncate"):
            return "truncate"
        return None

    def wire_delay_s(self) -> float:
        if self._roll(self.config.wire_delay_rate, "wire_delay"):
            return self.config.wire_delay_ms / 1000.0
        return 0.0

    def maybe_device_error(self) -> None:
        """Raise an injected device error at the group-render hook."""
        if self._roll(self.config.device_error_rate, "device_error"):
            raise CudaError("CUDA error: injected fault")

    def freeze_s(self) -> float:
        """Stall of the lane hook (0 = none; at most ``freeze_max``)."""
        if self.config.freeze_max:
            with self._lock:
                if self.counts.get("freeze", 0) >= self.config.freeze_max:
                    return 0.0
        if self._roll(self.config.freeze_rate, "freeze"):
            return self.config.freeze_ms / 1000.0
        return 0.0

    def sidecar_should_die(self) -> bool:
        """True on the Nth request this process handles, and never again
        (a supervised restart must not die in a loop)."""
        if self.config.die_after_requests <= 0:
            return False
        with self._lock:
            self._requests_seen += 1
            if self._requests_seen == self.config.die_after_requests:
                self.counts["sidecar_kill"] = \
                    self.counts.get("sidecar_kill", 0) + 1
                return True
        return False

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)


_INSTALLED: Optional[FaultInjector] = None


def install(config: Optional[FaultInjectionConfig]
            ) -> Optional[FaultInjector]:
    """Install the process-global injector (None or a seed-less config
    uninstalls).  Returns the active injector."""
    global _INSTALLED
    if config is None or config.seed is None:
        _INSTALLED = None
    else:
        _INSTALLED = FaultInjector(config)
    return _INSTALLED


def uninstall() -> None:
    global _INSTALLED
    _INSTALLED = None


def active() -> Optional[FaultInjector]:
    return _INSTALLED


# ------------------------------------------------- link-level partitions

class PartitionTable:
    """Directional link partitions for the netsplit drill.

    Rules are ``(src_host, dst_host) -> mode``, applied at the sidecar
    client of the ``src_host`` process (``SidecarClient.call_full`` asks
    :func:`partitioned` before a frame leaves the host).  ``"drop"``: the
    call fails as a dead wire (``ConnectionError``, after its retries);
    ``"deny"``: the same error, counted apart.  No seed gates them: they
    are topology state the drill flips on and off (the ``partition`` wire
    op), and they stack with any installed injector.  A rule whose
    ``src_host`` is not this process's host never matches here."""

    MODES = ("drop", "deny")

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: Dict[tuple, str] = {}

    def add(self, src: str, dst: str, mode: str = "drop",
            bidirectional: bool = False) -> None:
        if mode not in self.MODES:
            raise ValueError(f"partition mode must be one of "
                             f"{self.MODES}, got {mode!r}")
        src, dst = str(src), str(dst)
        if not src or not dst or src == dst:
            raise ValueError("partition rule needs distinct non-empty "
                             "src and dst hosts")
        with self._lock:
            self._rules[(src, dst)] = mode
            if bidirectional:
                self._rules[(dst, src)] = mode
        self._publish()

    def remove(self, src: str, dst: str,
               bidirectional: bool = False) -> None:
        with self._lock:
            self._rules.pop((str(src), str(dst)), None)
            if bidirectional:
                self._rules.pop((str(dst), str(src)), None)
        self._publish()

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
        self._publish()

    def check(self, src: str, dst: str) -> Optional[str]:
        """The blocking mode of src->dst, or None (an open link).  An empty
        host never matches: an unstamped client is never partitioned."""
        if not src or not dst:
            return None
        with self._lock:
            return self._rules.get((src, dst))

    def snapshot(self) -> list:
        with self._lock:
            return [{"src": s, "dst": d, "mode": m}
                    for (s, d), m in sorted(self._rules.items())]

    def __len__(self) -> int:
        with self._lock:
            return len(self._rules)

    def _publish(self) -> None:
        from . import telemetry
        telemetry.QUORUM.set_partition_rules(len(self))


PARTITIONS = PartitionTable()


def partitioned(src: str, dst: str) -> Optional[str]:
    """The rule mode blocking src->dst right now (counted on
    ``imageregion_partition_blocked_total``), or None."""
    mode = PARTITIONS.check(src, dst)
    if mode is not None:
        from . import telemetry
        telemetry.QUORUM.count_partition_blocked(mode)
    return mode
