"""Fixed-size mergeable streaming rank sketch.

Counterpart of the JAX package's ``utils/sketch.py``, copied: the perf
sentinel (``server.sentinel``) keeps per-(route, shape) latency quantiles
that must be (a) cheap enough to update on every request (the insert is
two list operations, no lock, no allocation), (b) bounded in memory for
the life of the process, and (c) mergeable, so two sketches of one ladder
add bucket for bucket.

A geometric bucket ladder gives all three.  Values land in buckets whose
bounds grow by a fixed ratio (``10 ** (1 / buckets_per_decade)``), the
HDR/DDSketch layout; the ladder is a tuple computed once per parameter set
and shared by every sketch.  The insert is one ``bisect_right`` into the
shared bounds and one GIL-atomic list-slot increment.  A merge of two
sketches of one ladder is element-wise count addition: associative and
commutative.

A quantile is reported as the geometric midpoint of its bucket, so the
relative error is at most ``sqrt(ratio) - 1`` (~3.6 % at the default 32
buckets a decade): plenty to call a 1.5x p99 drift.

Standard library only.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

__all__ = ["RankSketch"]

# Ladders are keyed by (lo, hi, buckets_per_decade) and shared:
# building one is O(decades * buckets) and every sketch with the same
# parameters must agree bucket-for-bucket or merging would be
# meaningless.
_LADDERS: Dict[Tuple[float, float, int], Tuple[float, ...]] = {}


def _ladder(lo: float, hi: float,
            buckets_per_decade: int) -> Tuple[float, ...]:
    key = (lo, hi, buckets_per_decade)
    ladder = _LADDERS.get(key)
    if ladder is None:
        ratio = 10.0 ** (1.0 / buckets_per_decade)
        bounds: List[float] = []
        b = lo
        while b < hi:
            bounds.append(b)
            b *= ratio
        bounds.append(hi)
        ladder = tuple(bounds)
        _LADDERS[key] = ladder
    return ladder


class RankSketch:
    """Streaming quantile sketch over a geometric bucket ladder.

    ``add`` is safe to call from any thread without a lock: the only
    shared mutation is a single list-slot increment (GIL-atomic, the
    ``Histogram.add`` idiom).  Everything else (quantile, merge,
    serialization) runs at tick/debug cadence where a racy read of a
    count that is one insert stale is invisible.
    """

    __slots__ = ("lo", "hi", "buckets_per_decade", "bounds", "counts")

    def __init__(self, lo: float = 0.01, hi: float = 1e6,
                 buckets_per_decade: int = 32):
        if not (0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        if buckets_per_decade < 1:
            raise ValueError("need buckets_per_decade >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.buckets_per_decade = int(buckets_per_decade)
        self.bounds = _ladder(self.lo, self.hi,
                              self.buckets_per_decade)
        # bucket i holds values in (bounds[i-1], bounds[i]]; bucket 0
        # is the underflow (<= lo), the last is the overflow (> hi).
        self.counts = [0] * (len(self.bounds) + 1)

    # ------------------------------------------------------------ hot

    def add(self, value: float) -> None:
        """One observation.  Two ops, no lock — the hot path."""
        self.counts[bisect_right(self.bounds, value)] += 1

    # ----------------------------------------------------------- cold

    @property
    def n(self) -> int:
        return sum(self.counts)

    def _bucket_value(self, idx: int) -> float:
        """Representative value of bucket ``idx``: geometric midpoint
        of its bounds (bounded relative error), clamped at the ladder
        edges."""
        if idx <= 0:
            return self.lo
        if idx >= len(self.bounds):
            return self.hi
        lo_b, hi_b = self.bounds[idx - 1], self.bounds[idx]
        return (lo_b * hi_b) ** 0.5

    def quantile(self, q: float) -> Optional[float]:
        """Value at rank ``q`` in [0, 1], or None while empty."""
        counts = list(self.counts)  # one racy snapshot, then stable
        total = sum(counts)
        if total <= 0:
            return None
        q = min(1.0, max(0.0, q))
        target = q * (total - 1)
        seen = 0
        for idx, c in enumerate(counts):
            if c <= 0:
                continue
            seen += c
            if seen - 1 >= target:
                return self._bucket_value(idx)
        return self._bucket_value(len(counts) - 1)

    def quantiles(self, qs) -> List[Optional[float]]:
        return [self.quantile(q) for q in qs]

    # ---------------------------------------------------------- merge

    def compatible(self, other: "RankSketch") -> bool:
        return (self.lo == other.lo and self.hi == other.hi
                and self.buckets_per_decade == other.buckets_per_decade)

    def merge(self, other: "RankSketch") -> "RankSketch":
        """Element-wise count addition into ``self`` (associative and
        commutative — the fleet-merge contract).  Raises on a ladder
        mismatch: merging incomparable ladders would silently produce
        garbage quantiles."""
        if not self.compatible(other):
            raise ValueError("sketch ladder mismatch")
        counts = self.counts
        for i, c in enumerate(other.counts):
            if c:
                counts[i] += c
        return self

    def copy(self) -> "RankSketch":
        dup = RankSketch(self.lo, self.hi, self.buckets_per_decade)
        dup.counts = list(self.counts)
        return dup

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)

    # ----------------------------------------------------------- wire

    def to_doc(self) -> dict:
        """Sparse wire/persist form — gossip payloads and warm-state
        manifests carry only the occupied buckets."""
        return {
            "v": 1, "lo": self.lo, "hi": self.hi,
            "b": self.buckets_per_decade,
            "counts": {str(i): c for i, c in enumerate(self.counts)
                       if c},
        }

    @classmethod
    def from_doc(cls, doc) -> Optional["RankSketch"]:
        """Parse-or-None: a truncated or foreign doc merges as
        nothing, never as an exception (gossip payloads cross
        versions)."""
        if not isinstance(doc, dict) or doc.get("v") != 1:
            return None
        try:
            sk = cls(float(doc["lo"]), float(doc["hi"]),
                     int(doc["b"]))
            for key, c in dict(doc.get("counts") or {}).items():
                idx = int(key)
                if 0 <= idx < len(sk.counts):
                    sk.counts[idx] += int(c)
        except (KeyError, TypeError, ValueError):
            return None
        return sk
