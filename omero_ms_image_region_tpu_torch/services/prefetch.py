"""Predictive, budgeted tile prefetch into the device raw cache.

The port's copy of the JAX package's ``services/prefetch.py``.  Each tile
GET feeds the session's viewport model (:mod:`.viewport`, with
``sessions.enabled``), and what is staged ahead of the viewer is that
session's predicted next tiles (pan velocity, z/t scrub, next-zoom
children or parent); a session with no trajectory yet, or an app without
sessions, gets the four lattice neighbours of the tile it was served.

* **Same keys as the foreground.**  A candidate is resolved by the
  handler's own plan function (``server.region.plan_region``, flips
  included) and keyed by ``io.devicecache.region_key``, so the next pan
  step's request computes exactly the key the prefetcher staged.
* **Same read path.**  A staged tile is read into pinned staging
  (``io.staging.read_pinned``) and copied on the raw cache's stream by
  ``DeviceRawCache.get_or_load``, as a foreground miss is.
* **Bounded.**  2 worker threads and at most ``max_pending`` (16) loads in
  flight or queued (a candidate past the bound is skipped, reason
  ``budget``).  Resident or already pending keys are not scheduled
  again.
* **Accountable.**  Staged keys are remembered (bounded), the handler
  reports raw-cache hits back through :meth:`TilePrefetcher.note_hit`, and
  :meth:`TilePrefetcher.hit_rate` is staged planes the foreground came back
  for over planes staged (``imageregion_prefetch_*``).

Best effort: a failed load is dropped (the foreground reads on demand),
and nothing is scheduled for a request that is not a tile.

* **Budgeted by pressure.**  The pending bound is ``max_pending`` times
  the local ``budget_scale`` times the pressure governor's
  :meth:`~..server.pressure.PressureGovernor.prefetch_budget` (elevated
  pressure halves it, critical quarters it); the ladder's
  ``pause_prefetch`` step sets ``paused`` (budget 0).  A queued load whose
  turn comes after the budget reached 0 exits without reading (skip reason
  ``paused``).  Each staged plane records its routing identity
  (``server.ctx.plane_route_key``), as the foreground's does.

* **Fleet-aware.**  With ``cache_for_route`` set (the combined fleet
  sets ``parallel.fleet.FleetRouter.cache_for_route``), each predicted
  tile stages into the raw cache of the member that owns its route, so
  prefetch warms the member that will serve the request and never
  duplicates a plane; with ``replica_caches`` (``FleetRouter
  .local_replica_caches``) a promoted hot route's prediction also stages
  into each local replica's cache.  With ``remote_prestage`` (a
  federated fleet sets ``FleetRouter.remote_prestage_for_route``), a
  prediction whose owner is a member on another host is handed to that
  host as a ``prestage`` hint, and nothing is staged here.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
from collections import OrderedDict
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

from ..io.devicecache import DeviceRawCache, region_key
from ..io.staging import read_pinned
from ..server.ctx import plane_route_key
from ..server.region import RegionDef, plan_region
from ..utils import telemetry

log = logging.getLogger(__name__)

# Staged-key memory bound: more planes than the raw cache holds.
_STAGED_KEYS_MAX = 8192


class TilePrefetcher:
    """Stages each session's predicted next tiles into the raw cache."""

    def __init__(self, raw_cache: DeviceRawCache, max_workers: int = 2,
                 max_pending: int = 16, viewport=None, lookahead: int = 2):
        self.raw_cache = raw_cache
        self.max_pending = max_pending
        self.viewport = viewport          # ViewportTracker, or None
        self.lookahead = max(1, int(lookahead))
        # Local budget scale in [0, 1], times the governor's
        # prefetch_budget(); the ladder's pause_prefetch sets it to 0
        # through ``paused``.
        self.budget_scale = 1.0
        # Fleet seams: route -> the owning member's raw cache (None: this
        # prefetcher's own), and route -> the live local replicas' caches
        # of a promoted hot route.
        self.cache_for_route = None
        self.replica_caches = None
        # The federation's seam: ``remote_prestage(route, entry) -> bool``
        # hints a remote owner's host to stage the plane from its own
        # pixel store.
        self.remote_prestage = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="tile-prefetch")
        self._lock = threading.Lock()
        self._pending: set = set()
        self._futures: set = set()
        # Keys this prefetcher staged, awaiting their foreground hit.
        self._staged_keys: "OrderedDict" = OrderedDict()
        self.scheduled = 0
        self.staged = 0
        self.hits = 0
        self.predicted = 0

    # ------------------------------------------------------------ budget

    @property
    def paused(self) -> bool:
        """The ladder's ``pause_prefetch``: paused is budget 0."""
        return self.budget_scale <= 0.0

    @paused.setter
    def paused(self, value: bool) -> None:
        self.budget_scale = 0.0 if value else 1.0

    def effective_budget(self) -> float:
        """This instant's budget scale: local times the governor's."""
        scale = self.budget_scale
        if scale <= 0.0:
            return 0.0
        from ..server.pressure import active
        governor = active()
        if governor is not None:
            scale *= governor.prefetch_budget()
        return max(0.0, min(1.0, scale))

    def effective_max_pending(self) -> int:
        """The pending bound this instant (0: paused)."""
        return int(self.max_pending * self.effective_budget())

    def note_hit(self, key) -> None:
        """The foreground found ``key`` resident: a predictive hit if this
        prefetcher staged it."""
        with self._lock:
            if self._staged_keys.pop(key, None) is None:
                return
            self.hits += 1
        telemetry.PREFETCH.count_hit()

    def hit_rate(self) -> Optional[float]:
        """Staged planes the foreground came back for, over planes staged;
        None before anything was staged."""
        if self.staged == 0:
            return None
        return self.hits / self.staged

    def _candidates(self, image_id: int, z: int, t: int,
                    resolution: Optional[int], session_key: Optional[str],
                    tile: RegionDef
                    ) -> List[Tuple[Optional[int], int, int, int, int]]:
        """(resolution, z, t, x, y) of the predicted tiles: the session's
        viewport predictions when it has a trajectory, else the four
        lattice neighbours of the served tile."""
        if self.viewport is not None:
            out = [(p.resolution, p.z, p.t, p.x, p.y)
                   for p in self.viewport.predict(session_key,
                                                  lookahead=self.lookahead)
                   if p.image_id == image_id]
            if out:
                self.predicted += len(out)
                telemetry.PREFETCH.count_predicted(len(out))
                telemetry.FLIGHT.record(
                    "prefetch.predict", n=len(out),
                    session=(session_key or "-")[:16], x=tile.x, y=tile.y)
                return out
        return [(resolution, z, t, tile.x + dx, tile.y + dy)
                for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1))
                if tile.x + dx >= 0 and tile.y + dy >= 0]

    def tile_served(self, src, image_id: int, z: int, t: int,
                    resolution: Optional[int], levels, tile: RegionDef,
                    tile_size: Tuple[int, int], max_tile_length: int,
                    active: Sequence[int], flip_horizontal: bool = False,
                    flip_vertical: bool = False,
                    session_key: Optional[str] = None) -> None:
        """Feed the viewport model and schedule the predicted tiles (on the
        event loop: it only queues work)."""
        if tile is None:
            return
        if self.viewport is not None:
            self.viewport.observe(session_key, image_id, z, t, resolution,
                                  tile.x, tile.y)
        budget = self.effective_max_pending()
        if budget <= 0:
            telemetry.PREFETCH.count_skipped("budget")
            return
        for nres, nz, nt, nx, ny in self._candidates(
                image_id, z, t, resolution, session_key, tile):
            if nres is not None and not 0 <= nres < len(levels):
                continue
            region, level = plan_region(
                levels, nres, RegionDef(nx, ny, tile.width, tile.height),
                None, tile_size, max_tile_length, flip_horizontal,
                flip_vertical)
            if region.width <= 0 or region.height <= 0:
                continue
            key = region_key(image_id, nz, nt, level, region.as_tuple(),
                             tuple(active))
            route = plane_route_key(SimpleNamespace(
                image_id=image_id, z=nz, t=nt, resolution=nres,
                tile=RegionDef(nx, ny, tile.width, tile.height),
                region=None))
            cache = self.raw_cache
            if self.cache_for_route is not None:
                # (An empty cache is falsy: compare with None.)
                routed = self.cache_for_route(route)
                if routed is not None:
                    cache = routed
                elif self.remote_prestage is not None:
                    # No local member owns the route: its owner is on
                    # another host, which stages the hint.
                    entry = {"key": [image_id, nz, nt, level,
                                     list(region.as_tuple()),
                                     list(active)],
                             "route": route}
                    if self.remote_prestage(route, entry):
                        self.predicted += 1
                        continue
            targets = [cache]
            if self.replica_caches is not None:
                try:
                    replicas = list(self.replica_caches(route) or ())
                except Exception:
                    replicas = []
                targets += [c for c in replicas if c is not cache]
            for target in targets:
                # A replica's staging has a token of its own, so two
                # caches may hold one key in flight at once.
                token = key if target is cache else (id(target), key)
                if key in target:
                    continue            # resident: no pool churn
                with self._lock:
                    if token in self._pending:
                        continue        # in flight: a dedup, not a skip
                    if len(self._pending) >= budget:
                        telemetry.PREFETCH.count_skipped("budget")
                        continue
                    self._pending.add(token)
                try:
                    future = self._pool.submit(
                        self._load, src, target, key, route, nz, nt, level,
                        region, tuple(active), token)
                except RuntimeError:    # pool shut down mid-request
                    with self._lock:
                        self._pending.discard(token)
                    return
                self.scheduled += 1
                telemetry.PREFETCH.count_scheduled()
                with self._lock:
                    self._futures.add(future)
                future.add_done_callback(self._futures.discard)

    def _load(self, src, cache, key, route: str, z: int, t: int,
              level: int, region: RegionDef, active: Tuple[int, ...],
              token=None) -> None:
        token = key if token is None else token
        try:
            # A budget that reached 0 binds queued work too.
            if self.effective_budget() <= 0.0:
                telemetry.PREFETCH.count_skipped("paused")
                return
            loaded = [False]

            def loader():
                loaded[0] = True
                return read_pinned(src, z, t, region, level, active,
                                   cache.device)

            cache.get_or_load(key, loader, route_key=route)
            if loaded[0]:
                telemetry.PREFETCH.count_staged()
                with self._lock:
                    self.staged += 1
                    self._staged_keys[key] = True
                    while len(self._staged_keys) > _STAGED_KEYS_MAX:
                        self._staged_keys.popitem(last=False)
        except Exception as e:   # best effort: the foreground re-reads
            log.debug("prefetch failed for %s: %r", key, e)
        finally:
            with self._lock:
                self._pending.discard(token)

    def flush(self, timeout: float = 10.0) -> None:
        """Wait for the loads in flight (tests, shutdown)."""
        with self._lock:
            outstanding = list(self._futures)
        concurrent.futures.wait(outstanding, timeout=timeout)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
