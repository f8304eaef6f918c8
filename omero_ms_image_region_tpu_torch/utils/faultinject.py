"""Seeded fault injection for the device lanes.

Counterpart of the device half of the JAX package's
``utils/faultinject.py``.  One process-global :class:`FaultInjector`
(installed from the ``fault-injection`` config block, or directly by tests)
is consulted in the batcher's lane thread, before a group's launches:

* ``freeze_s`` stalls the lane (a wedged stream), which the watchdog must
  heal;
* ``maybe_device_error`` raises :class:`CudaError`, which fails the group.

Decisions come from one seeded ``random.Random`` under a lock, so a fixed
seed gives a reproducible schedule for a fixed call sequence.  Every rate
defaults to 0 and the injector to ``None``: a lane pays one ``is None``
check.  The wire, sidecar and partition faults wait for the sidecar and
federation.
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
    device_error_rate: float = 0.0    # error raised in a group render
    freeze_rate: float = 0.0          # a device lane stalls freeze_ms
    freeze_ms: float = 0.0
    # At most this many freezes are injected (0 = unbounded): the
    # watchdog drills need "the first dispatch wedges, the requeue runs
    # clean", which a rate alone cannot promise.
    freeze_max: int = 0

    def validate(self) -> "FaultInjectionConfig":
        for name in ("device_error_rate", "freeze_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault-injection.{name} must be in "
                                 f"[0, 1], got {v}")
        if self.freeze_ms < 0:
            raise ValueError("fault-injection delays must be >= 0")
        if self.freeze_max < 0:
            raise ValueError("fault-injection.freeze-max must be >= 0 "
                             "(0 = unbounded)")
        return self


class FaultInjector:
    """Seeded decisions, and counts of what was injected."""

    def __init__(self, config: FaultInjectionConfig):
        self.config = config.validate()
        self._rng = Random(config.seed)
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}

    def _roll(self, rate: float, kind: str) -> bool:
        if rate <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < rate
            if hit:
                self.counts[kind] = self.counts.get(kind, 0) + 1
        return hit

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
