"""Per-session viewport model: pan/zoom trajectories -> predictions.

The port's copy of the JAX package's ``services/viewport.py``, prediction
for prediction.  The reference exists to serve interactive OMERO.web
viewers: a user PANS (tile requests march along a lattice direction),
ZOOMS (requests jump resolution levels around one viewport centre) and
SCRUBS z or t with the sliders.  This module gives the prefetcher
(``services.prefetch``) a client model:

* :class:`ViewportTracker` holds a bounded LRU of per-session states
  (the session is ``ctx.omero_session_key``; sessionless traffic shares
  the anonymous state), each a short deque of recent tile observations.
* :meth:`ViewportTracker.predict` turns a session's recent trajectory
  into an ordered list of predicted next tiles: the velocity (the median
  per-step tile delta over the recent window) extrapolated ``lookahead``
  steps ahead, the same tile on the planes a z/t scrub heads to, and the
  next zoom level's tiles when the last observation changed level.
* No trajectory (first touch, or a teleport) predicts nothing, and the
  prefetcher falls back to the four lattice neighbours.

Deterministic: the clock is injectable and nothing here samples
randomness, so a replayed trace gives the same predictions.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Tuple

from ..utils import telemetry

# Observations older than this never vote in the velocity estimate —
# a viewer that paused for a coffee did not keep panning.
_STALE_S = 10.0


@dataclass(frozen=True)
class TilePrediction:
    """One predicted future tile request of a session (same z/t/image
    as the observation stream; ``resolution`` may differ on zooms)."""

    image_id: int
    z: int
    t: int
    resolution: Optional[int]
    x: int
    y: int
    # Ordering hint: step 1 = most imminent.  Prefetchers schedule in
    # ascending step order so the budget spends on the near future.
    step: int = 1


class _Obs:
    __slots__ = ("ts", "image_id", "z", "t", "resolution", "x", "y")

    def __init__(self, ts, image_id, z, t, resolution, x, y):
        self.ts = ts
        self.image_id = image_id
        self.z = z
        self.t = t
        self.resolution = resolution
        self.x = x
        self.y = y


class _SessionState:
    __slots__ = ("history",)

    def __init__(self, maxlen: int):
        self.history: Deque[_Obs] = deque(maxlen=maxlen)


def _median_int(values: List[int]) -> int:
    """Deterministic integer median (lower of the middle pair)."""
    ordered = sorted(values)
    return ordered[(len(ordered) - 1) // 2]


class ViewportTracker:
    """Bounded LRU of per-session pan/zoom trajectories.

    Thread-safe (observations arrive from asyncio worker threads via
    the handler's read path); the per-session history is tiny and the
    lock is held for dict/deque ops only.
    """

    ANONYMOUS = ""

    def __init__(self, max_sessions: int = 4096, history: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if max_sessions < 1:
            raise ValueError("viewport max_sessions must be >= 1")
        if history < 2:
            raise ValueError("viewport history must be >= 2")
        self.max_sessions = max_sessions
        self.history = history
        self.clock = clock
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[str, _SessionState]" = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    @staticmethod
    def _key(session_key: Optional[str]) -> str:
        return session_key if session_key else ViewportTracker.ANONYMOUS

    def _touch(self, key: str) -> _SessionState:
        """Get-or-create the session's state at the LRU head, with
        eviction + gauge bookkeeping.  Caller holds the lock."""
        state = self._sessions.get(key)
        if state is None:
            state = _SessionState(self.history)
            self._sessions[key] = state
            while len(self._sessions) > self.max_sessions:
                self._sessions.popitem(last=False)
                self.evictions += 1
                telemetry.SESSIONS.count_evicted()
        else:
            self._sessions.move_to_end(key)
        telemetry.SESSIONS.set_tracked(len(self._sessions))
        return state

    def observe(self, session_key: Optional[str], image_id: int,
                z: int, t: int, resolution: Optional[int],
                x: int, y: int) -> None:
        """Record one served tile request for the session."""
        key = self._key(session_key)
        now = self.clock()
        with self._lock:
            state = self._touch(key)
            state.history.append(
                _Obs(now, image_id, z, t, resolution, x, y))
            # Counted here, not in _touch: observations_total is the
            # VIEWPORT-lattice feed (what the predictor reads) — mask
            # activity keeps the session live but never counts as one.
            telemetry.SESSIONS.count_observation()

    def observe_activity(self, session_key: Optional[str]) -> None:
        """Record NON-TILE session activity (shape-mask requests):
        keeps the session live in the LRU and counted in the tracked
        gauge — the demand figure the autoscaler reads — without
        polluting the pan/zoom trajectory (a mask request has no
        lattice coordinates to vote with)."""
        with self._lock:
            self._touch(self._key(session_key))

    # ------------------------------------------------------- prediction

    def _recent(self, session_key: Optional[str]) -> List[_Obs]:
        with self._lock:
            state = self._sessions.get(self._key(session_key))
            if state is None:
                return []
            return list(state.history)

    def velocity(self, session_key: Optional[str]
                 ) -> Optional[Tuple[int, int]]:
        """The session's per-step tile velocity ``(vx, vy)`` on its
        current image/plane/level — the median of consecutive deltas
        over the fresh history — or None when there is no same-level
        trajectory to read."""
        history = self._recent(session_key)
        if len(history) < 2:
            return None
        last = history[-1]
        now = self.clock()
        dxs: List[int] = []
        dys: List[int] = []
        for prev, cur in zip(history, history[1:]):
            if (cur.image_id != last.image_id
                    or prev.image_id != last.image_id
                    or cur.resolution != last.resolution
                    or prev.resolution != last.resolution
                    or cur.z != last.z or cur.t != last.t
                    or now - cur.ts > _STALE_S
                    # The gap WITHIN the pair matters too: the single
                    # resume delta after a pause spans the teleport
                    # (e.g. 35 tiles "per step") and must not be the
                    # one fresh vote that defines the velocity.
                    or cur.ts - prev.ts > _STALE_S):
                continue
            dxs.append(cur.x - prev.x)
            dys.append(cur.y - prev.y)
        if not dxs:
            return None
        return _median_int(dxs), _median_int(dys)

    def scrub_velocity(self, session_key: Optional[str]
                       ) -> Optional[Tuple[int, int]]:
        """The session's per-step plane velocity ``(dz, dt)`` — the
        median of consecutive z/t deltas over the fresh history while
        the viewport itself holds still (same image/level/tile) — or
        None when no scrub trajectory is in flight.  This is the focus/
        time SCRUB a viewer drives with the z/t sliders: the lattice
        velocity estimate deliberately excludes those pairs (z/t change
        disqualifies a pan vote), so without this reader a scrubbing
        session looks stationary to the prefetcher."""
        history = self._recent(session_key)
        if len(history) < 2:
            return None
        last = history[-1]
        now = self.clock()
        dzs: List[int] = []
        dts: List[int] = []
        for prev, cur in zip(history, history[1:]):
            if (cur.image_id != last.image_id
                    or prev.image_id != last.image_id
                    or cur.resolution != last.resolution
                    or prev.resolution != last.resolution
                    or cur.x != prev.x or cur.y != prev.y
                    or (cur.z == prev.z and cur.t == prev.t)
                    or now - cur.ts > _STALE_S
                    or cur.ts - prev.ts > _STALE_S):
                continue
            dzs.append(cur.z - prev.z)
            dts.append(cur.t - prev.t)
        if not dzs:
            return None
        return _median_int(dzs), _median_int(dts)

    def zoom_direction(self, session_key: Optional[str]) -> int:
        """-1 zooming IN (toward finer levels — resolution indexes are
        largest-first, so the index DECREASES), +1 zooming out, 0 no
        zoom in flight."""
        history = self._recent(session_key)
        if len(history) < 2:
            return 0
        prev, last = history[-2], history[-1]
        if (prev.image_id != last.image_id
                or prev.resolution is None or last.resolution is None
                or prev.resolution == last.resolution):
            return 0
        return 1 if last.resolution > prev.resolution else -1

    def predict(self, session_key: Optional[str],
                lookahead: int = 2,
                max_level: Optional[int] = None
                ) -> List[TilePrediction]:
        """Predicted next tiles for the session, most imminent first.

        * Pan in flight: extrapolate the velocity ``lookahead`` steps.
        * z/t scrub in flight: the same tile on the planes the slider
          is heading to, ``lookahead`` steps of the median z/t delta.
        * Zoom in flight: the last tile's center re-expressed at the
          next level in the zoom direction (children when zooming in,
          the parent when zooming out).
        * Neither: empty (the prefetcher falls back to the lattice
          neighbors of the served tile).

        Coordinates may run past the plane edge — the prefetcher clamps
        through the same region pipeline as the foreground read, which
        discards out-of-plane tiles.
        """
        history = self._recent(session_key)
        if not history:
            return []
        last = history[-1]
        out: List[TilePrediction] = []
        vel = self.velocity(session_key)
        if vel is not None and vel != (0, 0):
            vx, vy = vel
            for i in range(1, max(1, lookahead) + 1):
                nx, ny = last.x + vx * i, last.y + vy * i
                if nx < 0 or ny < 0:
                    break
                out.append(TilePrediction(
                    last.image_id, last.z, last.t, last.resolution,
                    nx, ny, step=i))
        scrub = self.scrub_velocity(session_key)
        if scrub is not None and scrub != (0, 0):
            # z/t scrub in flight: the same tile at the planes the
            # slider is heading to (sliders clamp at the stack edge,
            # so negative targets are simply not predicted).
            dz, dt = scrub
            for i in range(1, max(1, lookahead) + 1):
                nz, nt = last.z + dz * i, last.t + dt * i
                if nz < 0 or nt < 0:
                    break
                out.append(TilePrediction(
                    last.image_id, nz, nt, last.resolution,
                    last.x, last.y, step=i))
        zoom = self.zoom_direction(session_key)
        if zoom != 0 and last.resolution is not None:
            target = last.resolution + zoom
            if target >= 0 and (max_level is None
                                or target <= max_level):
                if zoom < 0:
                    # Finer level: the tile's four children cover the
                    # same viewport region at 2x the lattice density.
                    for j, (cx, cy) in enumerate((
                            (2 * last.x, 2 * last.y),
                            (2 * last.x + 1, 2 * last.y),
                            (2 * last.x, 2 * last.y + 1),
                            (2 * last.x + 1, 2 * last.y + 1))):
                        out.append(TilePrediction(
                            last.image_id, last.z, last.t, target,
                            cx, cy, step=1 + j))
                else:
                    out.append(TilePrediction(
                        last.image_id, last.z, last.t, target,
                        last.x // 2, last.y // 2, step=1))
        return out
