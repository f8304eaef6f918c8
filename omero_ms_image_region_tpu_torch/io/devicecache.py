"""Device-resident raw tile cache: card memory as the hot tier of the store.

Counterpart of the JAX package's ``io/devicecache.py``.  Raw channel planes
do not depend on the rendering settings, and a viewer re-requests the same
tiles with other windows, colours or LUTs; after the first read such a
request costs no host read and no host-to-device copy.

Keyed by (image, z, t, level, region, channels); bounded by device bytes
with LRU eviction.  Planes stay in their storage dtype (uint16 takes half
the bytes of float32); the kernels widen on the card.

Content addressing: with ``digest_index`` on, every host plane stack
staged through :meth:`DeviceRawCache.get_or_load` is also indexed by its
content digest (:func:`plane_digest`).  Content already resident under any
key is not copied again: the new key aliases the resident tensor, and the
two share one byte charge.  It is off by default, unlike the JAX
package's: on an H100 host the BLAKE2b pass over a 1024² 4-channel tile
costs 13-25 ms, against well under 1 ms for the pinned copy it could
save, and no measured traffic yet repeats content under distinct keys
(PERF.md).

Staging: a host-array miss goes through ``io.staging.stage``, packed
(K10) where the JAX ``stage`` packs, as JAX ``io/devicecache.py:185-193``
does; a loader that returns a tensor already on the card (the handler's
banded cold read, a projected plane) is stored as it is.

Cost ledger (``utils.telemetry``): a miss's copy adds its host bytes to
the request's ``staged_bytes``, and a digest alias the bytes it saved to
``staged_bytes_skipped``, as in the JAX cache (no-op outside a request,
as for the prefetcher's loads).

Streams: a miss is copied on the cache's own CUDA stream and waited for
before the entry is published, so any stream may read an entry.  A reader
on another stream marks it with ``io.staging.use_on_current_stream``
before it queues work on it, so eviction cannot hand the memory out again
under that work.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..utils import telemetry
from .staging import HostPlanes, stage


def plane_digest(arr: np.ndarray) -> str:
    """Content address of a host plane stack: dtype + shape + bytes
    (BLAKE2b-128)."""
    import hashlib

    a = np.ascontiguousarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(a.dtype).encode())
    h.update(",".join(str(s) for s in a.shape).encode())
    h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceRawCache:
    """LRU of device-resident raw tile tensors.

    ``get_or_load(key, loader)`` returns a tensor on ``device``;
    ``loader()`` supplies the host planes on a miss, as a numpy array or as
    ``io.staging.HostPlanes`` already filled (then they are copied from
    that pinned buffer, with no second host copy), or a tensor it made on
    the device and synchronized (a projected plane), cached as it is.
    Thread-safe: the handler loads in worker threads; the copy happens
    outside the lock, and concurrent misses on one key may both load (last
    write wins, which is right for immutable pixels).
    """

    def __init__(self, max_bytes: int = 2 * 1024 * 1024 * 1024,
                 digest_index: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.max_bytes = max_bytes
        self.digest_index = digest_index
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, torch.Tensor]" = OrderedDict()
        # digest -> the keys whose entries hold that content (aliases
        # share one tensor).
        self._digests_of: Dict[Hashable, str] = {}
        self._keys_by_digest: Dict[str, Set[Hashable]] = {}
        # key -> the plane's routing identity (``server.ctx
        # .plane_route_key``), recorded at staging: the explain plane's
        # residency probe (:meth:`resident_route`).
        self._route_of: Dict[Hashable, str] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Copies skipped (aliased) / paid after a digest probe.
        self.plane_hits = 0
        self.plane_misses = 0

    # ------------------------------------------------------------ digest

    def count_plane(self, hit: bool) -> None:
        """Count a digest probe's outcome (``io.staging.stage_deduped``
        counts here too)."""
        with self._lock:
            if hit:
                self.plane_hits += 1
            else:
                self.plane_misses += 1

    def resident_digest(self, digest: str, count: bool = True) -> bool:
        """Is this content on the card under any key (the sidecar's
        ``plane_probe``)?  A resident answer counts a plane hit (an upload
        that will not happen); a miss is counted by the upload that
        follows."""
        with self._lock:
            resident = bool(self._keys_by_digest.get(digest))
            if count and resident:
                self.plane_hits += 1
            return resident

    def get_by_digest(self, digest: str, bump: bool = True):
        """The tensor holding this content under any key, or None.
        ``bump=False`` skips the LRU touch (the alias lookup of a miss:
        the new key gets its own LRU position)."""
        with self._lock:
            for key in self._keys_by_digest.get(digest, ()):
                arr = self._entries.get(key)
                if arr is not None:
                    if bump:
                        self._entries.move_to_end(key)
                    return arr
        return None

    def _index_digest(self, key: Hashable, digest: Optional[str]) -> None:
        """Record key -> digest (caller holds the lock)."""
        if digest is None:
            return
        self._digests_of[key] = digest
        self._keys_by_digest.setdefault(digest, set()).add(key)

    def _drop_digest(self, key: Hashable) -> None:
        digest = self._digests_of.pop(key, None)
        if digest is None:
            return
        keys = self._keys_by_digest.get(digest)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._keys_by_digest[digest]

    def _release_bytes(self, key: Hashable, arr: torch.Tensor) -> None:
        """Remove a key's accounting (lock held).  Aliases share one
        tensor, so its bytes leave the budget with the last key of that
        content."""
        digest = self._digests_of.get(key)
        self._drop_digest(key)
        self._route_of.pop(key, None)
        if digest is None or not self._keys_by_digest.get(digest):
            self._bytes -= _nbytes(arr)

    # ------------------------------------------------------------- loads

    def upload(self, upload: Callable[[], torch.Tensor]) -> torch.Tensor:
        """Run ``upload`` and wait for the work it queued (on the cache's
        own stream on CUDA, so the wait does not include unrelated work):
        the returned tensor may be read on any stream."""
        if self._stream is None:
            return upload()
        with torch.cuda.stream(self._stream):
            arr = upload()
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return arr

    def get_or_load(self, key: Hashable, loader: Callable,
                    digest: Optional[str] = None,
                    route_key: Optional[str] = None) -> torch.Tensor:
        with self._lock:
            arr = self._entries.get(key)
            if arr is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return arr
            self.misses += 1
        loaded = loader()
        if isinstance(loaded, torch.Tensor):
            return self._insert(key, loaded.to(self.device), None,
                                route_key)
        if isinstance(loaded, HostPlanes):
            host, planes = loaded.array, loaded
        else:
            host, planes = np.ascontiguousarray(loaded), None
        arr = None
        if self.digest_index:
            # Content already resident under another key aliases that
            # tensor: no copy.
            digest = digest or plane_digest(host)
            arr = self.get_by_digest(digest, bump=False)
            self.count_plane(hit=arr is not None)
            if arr is not None:
                # The copy this request did not pay.
                telemetry.add_cost("staged_bytes_skipped", host.nbytes)
        else:
            digest = None
        if arr is None:
            arr = self.upload(lambda: stage(host, self.device,
                                            planes=planes))
            telemetry.add_cost("staged_bytes", host.nbytes)
        return self._insert(key, arr, digest, route_key)

    def _insert(self, key: Hashable, arr: torch.Tensor,
                digest: Optional[str],
                route_key: Optional[str] = None) -> torch.Tensor:
        """Publish a loaded entry, then evict to the budget."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._release_bytes(key, old)
            if digest is not None:
                # Re-probe under the lock: a racing miss for the same
                # content may have landed since the probe above.  Adopt
                # its tensor (dropping the one just copied), so aliases
                # always share one allocation and one byte charge.
                for k in self._keys_by_digest.get(digest, ()):
                    existing = self._entries.get(k)
                    if existing is not None:
                        arr = existing
                        break
            self._entries[key] = arr
            if route_key is not None:
                self._route_of[key] = route_key
            if digest is None or not self._keys_by_digest.get(digest):
                self._bytes += _nbytes(arr)
            self._index_digest(key, digest)
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                evicted_key, evicted = self._entries.popitem(last=False)
                self._release_bytes(evicted_key, evicted)
                self.evictions += 1
        return arr

    def get(self, key: Hashable) -> Optional[torch.Tensor]:
        """Hit probe with the LRU bump; None on a miss (the serving fast
        path on the event loop; a miss goes to :meth:`get_or_load` in a
        worker thread)."""
        with self._lock:
            arr = self._entries.get(key)
            if arr is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            return arr

    def resident_digests(self) -> Set[str]:
        """Every content digest resident (the fleet's shard accounting:
        across members these sets should not meet, since a digest on two
        members is a plane staged twice).  Empty with the digest index
        off."""
        with self._lock:
            return set(self._keys_by_digest)

    def resident_route(self, route_key: str) -> bool:
        """Residency by routing identity, with no LRU bump (the explain
        plane's probe; O(resident entries), never on the serving path)."""
        with self._lock:
            return route_key in self._route_of.values()

    def evict_to_fraction(self, frac: float) -> int:
        """The pressure governor's ``evict_caches``: walk LRU-first until
        resident bytes are at most ``frac`` of the budget (keeping at least
        one entry); returns the entries dropped.  Their tensors go back to
        PyTorch's caching allocator, not to the driver."""
        target = max(0, int(self.max_bytes * frac))
        dropped = freed = 0
        with self._lock:
            while self._bytes > target and len(self._entries) > 1:
                key, arr = self._entries.popitem(last=False)
                before = self._bytes
                self._release_bytes(key, arr)
                freed += before - self._bytes
                self.evictions += 1
                dropped += 1
        if dropped:
            telemetry.FLIGHT.record("rawcache.pressure-evict",
                                    entries=dropped, bytes=freed)
        return dropped

    def clear(self) -> None:
        """Drop every entry (counters stay)."""
        with self._lock:
            self._entries.clear()
            self._route_of.clear()
            self._digests_of.clear()
            self._keys_by_digest.clear()
            self._bytes = 0

    def __contains__(self, key: Hashable) -> bool:
        """Residency probe with no LRU bump and no hit count (the
        prefetcher's)."""
        with self._lock:
            return key in self._entries

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot_entries(self, limit: int = 0):
        """The warm-state manifest's and the drain handoff's planes
        (``services.warmstate``, ``parallel.fleet``): the resident region
        entries, most recently used first, each as ``{"key": [image, z, t,
        level, [x, y, w, h], [channels]], "digest": <content digest, or
        None with digest dedup off>, "route": <the plane's routing
        identity, when it was recorded>}``, no LRU bump.  Only region keys
        can be re-read from the source; projected planes (``("proj",
        ...)``) are left out.  ``limit`` 0: all."""
        out = []
        with self._lock:
            for key in reversed(self._entries.keys()):
                entry = self._entry(key)
                if entry is None:
                    continue
                out.append(entry)
                if limit and len(out) >= limit:
                    break
        return out

    def entries_for_route(self, route_key: str):
        """The region entries of one routing identity, in
        :meth:`snapshot_entries`' form, MRU first, no LRU bump: what a hot
        route's promotion stages onto its replicas
        (``parallel.fleet.FleetRouter``)."""
        with self._lock:
            return [entry for key in reversed(self._entries.keys())
                    if self._route_of.get(key) == route_key
                    and (entry := self._entry(key)) is not None]

    def _entry(self, key: Hashable) -> Optional[dict]:
        """A region key's manifest entry (lock held); None for any other
        key."""
        if (not isinstance(key, tuple) or len(key) != 6
                or not isinstance(key[0], int)):
            return None
        image_id, z, t, level, region, channels = key
        entry = {"key": [image_id, z, t, level, list(region),
                         list(channels)],
                 "digest": self._digests_of.get(key)}
        route = self._route_of.get(key)
        if route is not None:
            entry["route"] = route
        return entry


def region_key(image_id: int, z: int, t: int, level: int,
               region: Tuple[int, int, int, int],
               channels: Tuple[int, ...]) -> tuple:
    """The raw read's identity: everything the pixels depend on and
    nothing the rendering settings touch."""
    return (image_id, z, t, level, region, channels)


def plane_key(digest: str) -> tuple:
    """Cache key of a content-addressed plane entry."""
    return ("plane", digest)
