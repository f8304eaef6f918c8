"""Control-plane decision ledger: what the service decided, and why.

Counterpart of the JAX package's ``utils/decisions.py``.  The forensics
plane (traces, the flight ring, ``/debug/costs``, SLO burn) answers "what
happened to this request"; this module answers "why did the service do X
at 14:02".  Every control-plane action lands here as one record of a
closed vocabulary (``telemetry.DecisionStats.KINDS`` / ``VERDICTS``, the
JAX package's, so the cardinality budget bounds
``imageregion_decision_total{kind,verdict}``).  In the port the perf
sentinel (``server.sentinel``) writes ``kind=sentinel`` with ``drift`` and
``recovered``, the fleet (``parallel.fleet``) its drains (``drain``,
``handoff``, ``undrain``) and hot-key promotions and demotions
(``hotkey``), and the autoscaler (``server.autoscaler``) ``kind=autoscaler``:
one record for each change of its tick's verdict (``up``, ``down``,
``blocked``, ``steady``) with the signals it read, and the measured outcome
(the queue and the active members) attached ``outcome_horizon_ticks`` ticks
later by :meth:`DecisionLedger.resolve`.  The federation
(``parallel.federation``) writes ``epoch`` (``installed``, ``pending``,
``done``, ``failed``), ``manifest`` (``agreed``, ``pending``, ``stale``,
``split-brain``, ``unreachable``, ``legacy``), ``gossip`` (``ok``,
``mismatch``, ``unreachable``, on a change of a peer's verdict only) and
``quorum`` (``fenced``, ``restored``); its ``install`` stamps the ledger
with the host (``configure(host=...)``), so a merged fleet timeline
attributes each record.  Each record also fires a
``decision.<kind>`` flight event, so the black box and the ledger tell one
story.

Storage is the flight recorder's shape: an append-only bounded ring
(``/debug/decisions`` snapshots it) and an optional JSONL spool
(``decisions.jsonl``, one-file rotation).  Recording never fails the
control plane: a word outside the vocabulary is dropped with a warning,
spool errors are counted and swallowed.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from . import telemetry

log = logging.getLogger("omero_ms_image_region_tpu_torch.decisions")

KINDS = telemetry.DecisionStats.KINDS
VERDICTS = telemetry.DecisionStats.VERDICTS

# One rotation (decisions.jsonl -> decisions.jsonl.1) keeps the spool
# bounded without a compaction thread.
_SPOOL_MAX_BYTES = 4 * 1024 * 1024
_SPOOL_NAME = "decisions.jsonl"


class DecisionLedger:
    """Bounded ring and JSONL spool of control-plane decision records."""

    def __init__(self, ring_size: int = 256, spool_dir: str = "",
                 outcome_horizon_ticks: int = 3, host: str = ""):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(16, int(ring_size)))
        self._seq = 0
        self.records_total = 0
        self.spool_dir = spool_dir
        self.spool_errors = 0
        self.outcome_horizon_ticks = max(1, int(outcome_horizon_ticks))
        self.host = host

    def configure(self, ring_size: Optional[int] = None,
                  spool_dir: Optional[str] = None,
                  outcome_horizon_ticks: Optional[int] = None,
                  host: Optional[str] = None) -> None:
        """The ``decisions:`` config block, at app startup.  The ring's
        records survive a resize (the newest kept)."""
        with self._lock:
            if ring_size is not None:
                self._ring = collections.deque(
                    self._ring, maxlen=max(16, int(ring_size)))
            if spool_dir is not None:
                self.spool_dir = spool_dir
            if outcome_horizon_ticks is not None:
                self.outcome_horizon_ticks = max(
                    1, int(outcome_horizon_ticks))
            if host is not None:
                self.host = host

    # ------------------------------------------------------------ record

    def record(self, kind: str, verdict: str, member: str = "",
               detail: Optional[dict] = None) -> int:
        """Append one record; its ``seq`` (the handle :meth:`resolve`
        attaches an outcome to), or -1 when the vocabulary refused it.
        Never raises."""
        if kind not in KINDS or verdict not in VERDICTS:
            log.warning("decision dropped: kind=%r verdict=%r not in "
                        "the closed vocabulary", kind, verdict)
            return -1
        with self._lock:
            self._seq += 1
            seq = self._seq
            rec: Dict[str, object] = {
                "seq": seq, "ts": time.time(),
                "kind": kind, "verdict": verdict,
            }
            if self.host:
                rec["host"] = self.host
            if member:
                rec["member"] = member
            if detail:
                rec["detail"] = dict(detail)
            self._ring.append(rec)
            self.records_total += 1
        telemetry.DECISIONS.count(kind, verdict)
        fields = {"verdict": verdict, "seq": seq}
        if member:
            fields["member"] = member
        telemetry.FLIGHT.record(f"decision.{kind}", **fields)
        self._spool(rec)
        return seq

    def resolve(self, seq: int, outcome: dict) -> bool:
        """Attach a measured outcome to an earlier record: True when it
        was still in the ring.  The spool gets an outcome line either
        way."""
        found = False
        with self._lock:
            for rec in reversed(self._ring):
                if rec.get("seq") == seq:
                    rec["outcome"] = dict(outcome)
                    found = True
                    break
        self._spool({"outcome_for": seq, "ts": time.time(),
                     "outcome": dict(outcome)})
        return found

    # ---------------------------------------------------------- surfaces

    def snapshot(self, limit: int = 0) -> List[dict]:
        """The ring's records, oldest first (copies)."""
        with self._lock:
            out = [dict(rec) for rec in self._ring]
        return out[-limit:] if limit > 0 else out

    def status(self) -> dict:
        with self._lock:
            return {
                "records_total": self.records_total,
                "ring": len(self._ring),
                "ring_size": self._ring.maxlen,
                "outcome_horizon_ticks": self.outcome_horizon_ticks,
                "spool_dir": self.spool_dir or None,
                "spool_errors": self.spool_errors,
                "host": self.host or None,
            }

    # ------------------------------------------------------------- spool

    def _spool(self, doc: dict) -> None:
        spool_dir = self.spool_dir
        if not spool_dir:
            return
        try:
            os.makedirs(spool_dir, exist_ok=True)
            path = os.path.join(spool_dir, _SPOOL_NAME)
            try:
                if os.path.getsize(path) >= _SPOOL_MAX_BYTES:
                    os.replace(path, path + ".1")
            except OSError:
                pass                     # no file yet
            with open(path, "a") as f:
                f.write(json.dumps(doc, sort_keys=True) + "\n")
        except (OSError, ValueError, TypeError):
            with self._lock:
                self.spool_errors += 1

    def reset(self) -> None:
        """Test isolation."""
        with self._lock:
            self._ring = collections.deque(maxlen=256)
            self._seq = 0
            self.records_total = 0
            self.spool_dir = ""
            self.spool_errors = 0
            self.outcome_horizon_ticks = 3
            self.host = ""


LEDGER = DecisionLedger()


def record(kind: str, verdict: str, member: str = "",
           detail: Optional[dict] = None) -> int:
    return LEDGER.record(kind, verdict, member=member, detail=detail)


def resolve(seq: int, outcome: dict) -> bool:
    return LEDGER.resolve(seq, outcome)
