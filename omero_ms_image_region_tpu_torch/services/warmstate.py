"""Warm-state snapshot and rehydrate: the lifecycle between two lives of
the process.

Counterpart of the JAX package's ``services/warmstate.py``.  The disk byte
tier (``services.diskcache``) and the build store (``server.execcache``)
keep the expensive state on disk; this module (a) writes a manifest of
what is hot, periodically and on SIGTERM through the shutdown chain
(``server.shutdown``), and (b) replays it on boot on a background thread,
so the first minute after a deploy serves warm.

The manifest (``manifest.json``, the JAX ``MANIFEST_VERSION`` and field
names) holds:

* ``byte_keys``: per named cache, its most recent keys.  The port's memory
  tier is the native LRU, which cannot list its keys, so they come from
  the disk tier's recency order (mtime, most recent first; a read bumps
  it), as in JAX.  Rehydrate promotes each disk -> memory.
* ``planes``: the raw cache's resident region entries
  (``DeviceRawCache.snapshot_entries``).  Rehydrate re-reads each region
  from the pixel store into a pinned buffer and copies it to the card
  through ``DeviceRawCache.get_or_load`` (the cache's own stream, waited
  for before the entry is published), at ``rehydrate-concurrency``.
* ``fingerprint`` and ``executables``: the build store's toolchain and
  card fingerprint and its stored keys.  Rehydrate writes them into the
  package's ``_build/`` directories first (``ExecutableCache.preload``),
  unless the fingerprint differs; bytes and planes replay either way.

Everything is best effort: a missing, corrupt or foreign manifest is a
cold boot, the rehydrator yields to live load (the batcher's queue and
groups in flight) and stops at shutdown, and nothing here fails a request
or the boot.  The manifest also carries the perf sentinel's learned
baselines (``sentinel``: ``SentinelEngine.export_baseline``), restored
first on boot (``load_baseline``), so a restart does not learn "normal"
again from its first windows.  While the pressure governor's
``pause_snapshots`` step is engaged (``paused``) the timer skips its
snapshots; the SIGTERM chain's and ``/debug/warmstate``'s still run.  A
plane entry carries its fleet ``route`` (``server.ctx.plane_route_key``)
when the cache recorded one, and a restaged plane keeps it, so a drain's
handoff after a restart hands it to the member that serves it, as in JAX.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import List, Optional

from ..utils import telemetry

log = logging.getLogger("omero_ms_image_region_tpu_torch.warmstate")

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"

_CACHE_NAMES = ("image_region", "pixels_metadata", "shape_mask")

# The disk tier's key namespaces (services.cache.Caches.from_config).
_DISK_PREFIXES = {"image_region": "img:", "pixels_metadata": "meta:",
                  "shape_mask": "mask:"}


def restage_plane_entry(raw_cache, pixels_service, entry: dict) -> bool:
    """Re-read one manifest plane entry from the pixel store and stage it
    on the card as a cold GET would (``io.staging.read_pinned``, then the
    raw cache's copy), under the entry's recorded ``route``.  Shared by
    the boot rehydrate and the fleet's prestage (a drain's handoff, a hot
    route's replicas).  False on a malformed entry; read errors propagate
    to the caller's guard."""
    from ..io.devicecache import region_key
    from ..io.staging import read_pinned
    from ..server.region import RegionDef

    try:
        image_id, z, t, level, region, channels = entry["key"]
        key = region_key(int(image_id), int(z), int(t), int(level),
                         tuple(int(v) for v in region),
                         tuple(int(c) for c in channels))
    except (KeyError, TypeError, ValueError):
        return False
    if key in raw_cache:
        return True

    def load():
        src = pixels_service.get_pixel_source(key[0])
        return read_pinned(src, key[1], key[2], RegionDef(*key[4]), key[3],
                           key[5], raw_cache.device)

    raw_cache.get_or_load(key, load, route_key=entry.get("route"))
    return True


def _load_manifest(path: str) -> Optional[dict]:
    """The manifest, or None for a missing, truncated or foreign one."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("version") != MANIFEST_VERSION:
        return None
    return doc


class WarmStateManager:
    """Snapshot timer and boot rehydrator of one app.  ``services`` is the
    handler's ``ImageRegionServices`` (duck-typed): its caches, raw cache,
    renderer (and the renderer's ``exec_cache``, the build store) and
    pixel service."""

    def __init__(self, directory: str, services,
                 snapshot_interval_s: float = 60.0,
                 snapshot_top_k: int = 512,
                 max_plane_entries: int = 256,
                 rehydrate_concurrency: int = 2):
        self.directory = directory
        self.services = services
        self.snapshot_interval_s = snapshot_interval_s
        self.snapshot_top_k = snapshot_top_k
        self.max_plane_entries = max_plane_entries
        self.rehydrate_concurrency = max(1, rehydrate_concurrency)
        self._stop = threading.Event()
        # The timer and the SIGTERM chain may both snapshot.
        self._snapshot_lock = threading.Lock()
        self._timer_thread: Optional[threading.Thread] = None
        self._rehydrate_thread: Optional[threading.Thread] = None
        # The ladder's pause_snapshots: the timer skips while set.
        self.paused = False

    # ------------------------------------------------------------ start

    def start(self, rehydrate: bool = True) -> None:
        """Start the boot rehydrator and the snapshot timer (daemon
        threads that end at :meth:`close`)."""
        os.makedirs(self.directory, exist_ok=True)
        if rehydrate:
            self._rehydrate_thread = threading.Thread(
                target=self._rehydrate_guarded,
                name="warmstate-rehydrate", daemon=True)
            self._rehydrate_thread.start()
        if self.snapshot_interval_s > 0:
            self._timer_thread = threading.Thread(
                target=self._timer_loop, name="warmstate-snapshot",
                daemon=True)
            self._timer_thread.start()

    def close(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        for t in (self._rehydrate_thread, self._timer_thread):
            if t is not None and t.is_alive():
                t.join(timeout=timeout_s)

    def _timer_loop(self) -> None:
        while not self._stop.wait(self.snapshot_interval_s):
            if self.paused:
                continue
            try:
                self.snapshot_now()
            except Exception:
                log.warning("periodic warm-state snapshot failed",
                            exc_info=True)

    # --------------------------------------------------------- snapshot

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def _collect_manifest(self) -> dict:
        doc = {"version": MANIFEST_VERSION, "ts": round(time.time(), 3),
               "byte_keys": {}, "planes": [], "executables": []}
        caches = getattr(self.services, "caches", None)
        disk = getattr(caches, "disk", None)
        disk_keys: Optional[List[str]] = None
        for name in _CACHE_NAMES:
            stack = getattr(caches, name, None)
            tiers = getattr(stack, "tiers", ())
            keys: List[str] = []
            if tiers:
                recency = getattr(tiers[0], "keys_by_recency", None)
                if recency is not None:
                    keys = recency(self.snapshot_top_k)
            if not keys and disk is not None:
                # The native memory tier cannot list its keys: the disk
                # tier's recency order stands in.  Its queued writes land
                # first, so the keys of the last requests are listed.
                if disk_keys is None:
                    disk.flush()
                    disk_keys = disk.keys_sync()
                prefix = _DISK_PREFIXES[name]
                keys = [k[len(prefix):] for k in disk_keys
                        if k.startswith(prefix)][:self.snapshot_top_k]
            doc["byte_keys"][name] = keys
        raw_cache = getattr(self.services, "raw_cache", None)
        if raw_cache is not None:
            doc["planes"] = raw_cache.snapshot_entries(
                self.max_plane_entries)
        store = getattr(getattr(self.services, "renderer", None),
                        "exec_cache", None)
        if store is not None:
            doc["fingerprint"] = store.fingerprint()
            doc["executables"] = store.stored_keys()
        # The sentinel's learned baselines: a regression deployed with the
        # restart must not become the new normal.
        from ..server import sentinel
        engine = sentinel.active()
        if engine is not None:
            baselines = engine.export_baseline()
            if baselines.get("baselines"):
                doc["sentinel"] = baselines
        return doc

    def snapshot_now(self) -> Optional[str]:
        """Write the manifest (tmp file and ``os.replace``); the path, or
        None on a failure (logged and counted, never raised: it runs in the
        SIGTERM chain and the timer)."""
        t0 = time.perf_counter()
        with self._snapshot_lock:
            try:
                doc = self._collect_manifest()
                os.makedirs(self.directory, exist_ok=True)
                path = self.manifest_path
                tmp = path + f".tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                os.replace(tmp, path)
            except Exception:
                telemetry.PERSIST.count_snapshot(0.0, error=True)
                log.warning("warm-state snapshot failed", exc_info=True)
                return None
        duration_ms = (time.perf_counter() - t0) * 1000.0
        telemetry.PERSIST.count_snapshot(duration_ms)
        telemetry.FLIGHT.record(
            "warmstate.snapshot",
            keys=sum(len(v) for v in doc["byte_keys"].values()),
            planes=len(doc["planes"]),
            executables=len(doc["executables"]),
            ms=round(duration_ms, 1))
        return path

    # -------------------------------------------------------- rehydrate

    def _yield_to_live_load(self) -> None:
        """Wait, at most 2 s, while the batcher has tiles queued or groups
        in flight: live requests go first, and a boot under steady load
        still trickles its warm state in."""
        renderer = getattr(self.services, "renderer", None)
        depth = getattr(renderer, "queue_depth", None)
        inflight = getattr(renderer, "inflight", None)
        if depth is None:
            return
        waited = 0.0
        while not self._stop.is_set() and waited < 2.0:
            if not (depth() > 0 or (inflight is not None
                                    and inflight() > 0)):
                return
            time.sleep(0.05)
            waited += 0.05

    def _rehydrate_guarded(self) -> None:
        t0 = time.perf_counter()
        try:
            self._rehydrate()
        except Exception:
            telemetry.PERSIST.rehydrate_end(
                (time.perf_counter() - t0) * 1000.0, aborted=True)
            log.warning("warm-state rehydrate failed; serving cold",
                        exc_info=True)

    def _rehydrate(self) -> None:
        doc = _load_manifest(self.manifest_path)
        if doc is None:
            telemetry.PERSIST.rehydrate_begin(0)
            telemetry.PERSIST.rehydrate_end(0.0)
            log.info("no usable warm-state manifest; cold boot")
            return
        store = getattr(getattr(self.services, "renderer", None),
                        "exec_cache", None)
        exec_keys = list(doc.get("executables") or ())
        if store is not None and doc.get("fingerprint") not in (
                None, store.fingerprint()):
            # Another toolchain or card wrote it: its libraries cannot
            # load here.  Bytes and planes still replay.
            log.info("warm-state manifest fingerprint differs; skipping "
                     "the build store's preload")
            exec_keys = []
        # The sentinel's baselines first: a dict copy, not I/O, and the
        # engine should know "normal" before the first windows close.
        if doc.get("sentinel"):
            try:
                from ..server import sentinel
                engine = sentinel.active()
                if engine is not None:
                    engine.load_baseline(doc["sentinel"])
            except Exception:
                log.warning("sentinel baseline rehydrate failed",
                            exc_info=True)
        byte_items = [(name, key) for name in _CACHE_NAMES
                      for key in (doc.get("byte_keys") or {}).get(name, ())]
        plane_items = list(doc.get("planes") or ())
        exec_items = len(exec_keys) if store is not None else 0
        total = len(byte_items) + len(plane_items) + exec_items
        telemetry.PERSIST.rehydrate_begin(total)
        telemetry.FLIGHT.record("warmstate.rehydrate.start", items=total)
        t0 = time.perf_counter()
        aborted = False

        # 1. The build store first: the prewarm and the first group of
        # each kernel load these libraries instead of building them.  One
        # step per key, so items_done reaches items_total.
        if exec_items:
            n = store.preload(exec_keys)
            for _ in range(n):
                telemetry.PERSIST.rehydrate_step("executable")
            for _ in range(exec_items - n):
                telemetry.PERSIST.rehydrate_step("executable", error=True)

        # 2. Disk -> memory: a promoted key's next request is a memory
        # hit.
        caches = getattr(self.services, "caches", None)
        for name, key in byte_items:
            if self._stop.is_set():
                aborted = True
                break
            self._yield_to_live_load()
            try:
                value = self._promote_byte(caches, name, key)
                telemetry.PERSIST.rehydrate_step(
                    "byte", nbytes=len(value) if value else 0,
                    error=value is None)
            except Exception:
                telemetry.PERSIST.rehydrate_step("byte", error=True)

        # 3. The planes back onto the card.
        if plane_items and not aborted and not self._stop.is_set():
            aborted = self._restage_planes(plane_items) or aborted
        ms = (time.perf_counter() - t0) * 1000.0
        telemetry.PERSIST.rehydrate_end(ms, aborted=aborted)
        telemetry.FLIGHT.record("warmstate.rehydrate.done",
                                aborted=aborted, ms=round(ms, 1))
        log.info("warm-state rehydrate %s (%d items)",
                 "aborted" if aborted else "complete", total)

    def _promote_byte(self, caches, name: str,
                      key: str) -> Optional[bytes]:
        """One key from the disk tier into the memory tier; its bytes, or
        None when the disk does not hold it (or it is corrupt: the next
        request renders)."""
        tiers = getattr(getattr(caches, name, None), "tiers", ())
        disk = getattr(caches, "disk", None)
        if not tiers or disk is None or not isinstance(key, str):
            return None
        value = disk.get_sync(_DISK_PREFIXES[name] + key)
        if value is not None:
            tiers[0].set_sync(key, value)
        return value

    def _restage_planes(self, plane_items: List[dict]) -> bool:
        """Stage the manifest's planes at ``rehydrate_concurrency``; True
        when shutdown stopped it."""
        import concurrent.futures as cf

        raw_cache = getattr(self.services, "raw_cache", None)
        pixels_service = getattr(self.services, "pixels_service", None)
        if raw_cache is None or pixels_service is None:
            for _ in plane_items:
                telemetry.PERSIST.rehydrate_step("plane", error=True)
            return False
        aborted = False
        with cf.ThreadPoolExecutor(
                max_workers=self.rehydrate_concurrency,
                thread_name_prefix="warmstate-stage") as pool:
            pending = []
            for entry in plane_items:
                if self._stop.is_set():
                    aborted = True
                    break
                self._yield_to_live_load()
                pending.append(pool.submit(restage_plane_entry, raw_cache,
                                           pixels_service, entry))
            for fut in pending:
                try:
                    telemetry.PERSIST.rehydrate_step(
                        "plane", error=not fut.result())
                except Exception:
                    telemetry.PERSIST.rehydrate_step("plane", error=True)
        return aborted
