"""The durable disk tier of the byte caches: rendered bytes that survive
the process.

The port's own copy of the JAX package's ``services/diskcache.py`` (it
imports nothing of that package), slotted by ``services.cache`` into each
named cache's chain between the memory LRU and Redis under the ``img:``,
``meta:`` and ``mask:`` namespaces when ``persistence.enabled`` is on.
Tiles, masks and metadata written here answer after a deploy, a respawn
or a crash with no pixel read and no kernel launch.

* **The same files.**  The entry format (:func:`encode_entry`,
  :func:`decode_entry`) and the file naming are the JAX package's byte for
  byte: ``IRB1`` | u16 key length | u32 value length | BLAKE2b-128 over
  key + value | key | value, under ``<2 hex>/<BLAKE2b-128 of the
  key>.irb``.  Either package reads the other's directory.
* **Crash-safe.**  Every write is a tmp file and ``os.replace``; a torn,
  truncated or foreign entry reads as a miss, is counted
  (``telemetry.PERSIST``) and removed, never served.
* **Off the request path.**  ``set`` is write-behind: one worker thread
  drains a bounded queue, and a full queue drops the write (counted)
  instead of blocking a render.  ``get`` reads on a worker thread.
* **Bounded.**  Past ``max_bytes`` the worker evicts the oldest entries by
  mtime (a read bumps it) down to 90 % of the budget, and sweeps the tmp
  files a crash left behind.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import queue
import struct
import threading
from typing import List, Optional, Tuple

from ..utils import telemetry

log = logging.getLogger("omero_ms_image_region_tpu_torch.diskcache")

# Entry format: MAGIC | u16 key_len | u32 value_len | blake2b-16 over
# (key_bytes + value) | key_bytes | value.  The stored key is verified
# against the requested key on read — a (vanishingly unlikely) digest
# filename collision must alias to a miss, not to another key's bytes.
_MAGIC = b"IRB1"
_HEADER = struct.Struct("<4sHI16s")

# Default eviction low-water mark: evict down to this fraction of
# max_bytes so each over-budget episode frees a batch, not one file.
_LOW_WATER = 0.9


def _digest(key: bytes, value: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(key)
    h.update(value)
    return h.digest()


def encode_entry(key: str, value: bytes) -> bytes:
    kb = key.encode()
    return (_HEADER.pack(_MAGIC, len(kb), len(value),
                         _digest(kb, value)) + kb + value)


def decode_entry(blob: bytes, key: str) -> Optional[bytes]:
    """Value bytes, or None when the blob fails ANY integrity check
    (wrong magic, truncation, trailing garbage, checksum mismatch,
    foreign key).  Never raises on hostile content."""
    try:
        if len(blob) < _HEADER.size:
            return None
        magic, key_len, value_len, digest = _HEADER.unpack_from(blob)
        if magic != _MAGIC:
            return None
        end = _HEADER.size + key_len + value_len
        if end != len(blob):
            return None
        kb = blob[_HEADER.size:_HEADER.size + key_len]
        value = blob[_HEADER.size + key_len:end]
        if kb != key.encode():
            return None
        if _digest(kb, value) != digest:
            return None
        return value
    except Exception:
        return None


class DiskByteCache:
    """Crash-safe content-addressed disk tier for the byte-cache chain.

    The sync face (``get_sync``/``set_sync``) is what the write-behind
    worker, tests and the boot rehydrator use; the async face matches
    the ``CacheTier`` protocol (``get`` off-loads the file read,
    ``set`` enqueues and returns).
    """

    SHARD_CHARS = 2          # 256 shard dirs
    QUEUE_DEPTH = 256        # pending write-behind entries
    # Gauge-publish coalescing: the write-behind worker publishes the
    # size gauges at most this often (plus once when its queue drains),
    # instead of taking the telemetry lock on every write — measured
    # contention against request threads flushing their own counters.
    PUBLISH_INTERVAL_S = 0.5

    def __init__(self, directory: str,
                 max_bytes: int = 1024 * 1024 * 1024,
                 sync_writes: bool = False):
        self.directory = directory
        self.max_bytes = max_bytes
        # sync_writes: write inline instead of behind the queue — the
        # deterministic mode tests and the snapshot path use.
        self.sync_writes = sync_writes
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._size_lock = threading.Lock()
        self._bytes = 0
        self._entries = 0
        self._scanned = False
        self._last_publish = 0.0
        self._queue: "queue.Queue[Optional[Tuple[str, bytes]]]" = \
            queue.Queue(maxsize=self.QUEUE_DEPTH)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._closed = False

    # ----------------------------------------------------------- paths

    def _path_of(self, key: str) -> str:
        name = hashlib.blake2b(key.encode(), digest_size=16).hexdigest()
        return os.path.join(self.directory, name[:self.SHARD_CHARS],
                            name + ".irb")

    # ----------------------------------------------------------- sizing

    def _scan_size(self) -> None:
        """One-time startup accounting of what a previous life left on
        disk (runs on the worker thread, or lazily on first use)."""
        total = entries = 0
        try:
            with os.scandir(self.directory) as shards:
                for shard in shards:
                    if not shard.is_dir():
                        continue
                    with os.scandir(shard.path) as files:
                        for f in files:
                            if not f.name.endswith(".irb"):
                                continue
                            try:
                                total += f.stat().st_size
                                entries += 1
                            except OSError:
                                pass
        except OSError:
            pass
        with self._size_lock:
            self._bytes += total
            self._entries += entries
        self._publish_size()

    def _ensure_scanned(self) -> None:
        # Claim-then-scan: the claim flips INSIDE the lock, so two
        # concurrent first touches can never both run the scan and
        # double-count the prior life's entries (phantom bytes would
        # evict exactly the warm set this tier exists to preserve).
        with self._size_lock:
            if self._scanned:
                return
            self._scanned = True
        self._scan_size()

    def _publish_size(self, force: bool = False) -> None:
        import time as _time
        now = _time.monotonic()
        with self._size_lock:
            if not force and (now - self._last_publish
                              < self.PUBLISH_INTERVAL_S):
                return
            self._last_publish = now
            telemetry.PERSIST.set_disk_size(self._bytes, self._entries)

    @property
    def size_bytes(self) -> int:
        with self._size_lock:
            return self._bytes

    def __len__(self) -> int:
        with self._size_lock:
            return self._entries

    # ------------------------------------------------------------ reads

    def get_sync(self, key: str) -> Optional[bytes]:
        # One-time: a restarted process must account (and publish) the
        # previous life's entries even if it only ever READS them.
        self._ensure_scanned()
        path = self._path_of(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            self.misses += 1
            return None
        value = decode_entry(blob, key)
        if value is None:
            # Corrupt (or foreign) entry: count it, remove it so the
            # next write can replace it, and serve a MISS — the caller
            # re-renders from source; nothing poisoned ever leaves.
            self.misses += 1
            telemetry.PERSIST.count_disk_corrupt()
            self._unlink(path)
            return None
        self.hits += 1
        try:
            # The LRU touch: eviction scans mtime oldest-first.
            os.utime(path)
        except OSError:
            pass
        return value

    # ----------------------------------------------------------- writes

    def set_sync(self, key: str, value: bytes) -> None:
        """Atomic write: tmp file in the target shard, then
        ``os.replace`` — a crash mid-write leaves only a tmp file (a
        later eviction scan sweeps it), never a half entry."""
        if len(value) > self.max_bytes:
            return
        # Account a previous life's leftovers BEFORE this write lands,
        # or the scan would double-count it.
        self._ensure_scanned()
        path = self._path_of(key)
        shard = os.path.dirname(path)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(shard, exist_ok=True)
            blob = encode_entry(key, value)
            try:
                old_size = os.path.getsize(path)
            except OSError:
                old_size = None
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError as e:
            telemetry.PERSIST.count_disk_write(error=True)
            self._unlink(tmp)
            log.warning("disk cache write failed, degrading: %s", e)
            return
        telemetry.PERSIST.count_disk_write()
        with self._size_lock:
            self._bytes += len(blob) - (old_size or 0)
            if old_size is None:
                self._entries += 1
        self._evict_if_needed()
        self._publish_size()

    def _unlink(self, path: str) -> None:
        try:
            size = os.path.getsize(path)
            os.unlink(path)
        except OSError:
            return
        with self._size_lock:
            self._bytes = max(0, self._bytes - size)
            self._entries = max(0, self._entries - 1)

    # --------------------------------------------------------- eviction

    def _entry_mtimes(self) -> List[Tuple[float, str, int]]:
        out = []
        try:
            with os.scandir(self.directory) as shards:
                for shard in shards:
                    if not shard.is_dir():
                        continue
                    with os.scandir(shard.path) as files:
                        for f in files:
                            try:
                                st = f.stat()
                            except OSError:
                                continue
                            if f.name.endswith(".irb"):
                                out.append((st.st_mtime, f.path,
                                            st.st_size))
                            elif ".tmp." in f.name:
                                # Orphaned tmp from a crash mid-write.
                                try:
                                    os.unlink(f.path)
                                except OSError:
                                    pass
        except OSError:
            pass
        out.sort()
        return out

    def _evict_if_needed(self) -> None:
        with self._size_lock:
            over = self._bytes > self.max_bytes
        if not over:
            return
        self._evict_to(int(self.max_bytes * _LOW_WATER))

    def evict_to_fraction(self, frac: float) -> None:
        """The pressure governor's ``evict_caches``: walk the tier to
        ``frac`` of its budget now, oldest first (the early form of the
        write path's eviction)."""
        self._ensure_scanned()
        target = max(0, int(self.max_bytes * frac))
        with self._size_lock:
            over = self._bytes > target
        if over:
            self._evict_to(target)

    def _evict_to(self, target: int) -> None:
        for _mtime, path, size in self._entry_mtimes():
            with self._size_lock:
                if self._bytes <= target:
                    break
            try:
                os.unlink(path)
            except OSError:
                continue
            with self._size_lock:
                self._bytes = max(0, self._bytes - size)
                self._entries = max(0, self._entries - 1)
            self.evictions += 1
            telemetry.FLIGHT.record("diskcache.evict", bytes=size)
        self._publish_size()

    # ------------------------------------------------------ write-behind

    def _worker_loop(self) -> None:
        self._ensure_scanned()
        while True:
            item = self._queue.get()
            if item is None:
                return
            key, value = item
            try:
                self.set_sync(key, value)
                if self._queue.empty():
                    # Burst drained: land the coalesced gauges now
                    # rather than waiting out the publish interval.
                    self._publish_size(force=True)
            except Exception:
                # set_sync already degrades on OSError; this catches
                # anything else so the worker thread never dies and
                # silently turns every later set into a dropped write.
                telemetry.PERSIST.count_disk_write(error=True)
                log.warning("disk cache write-behind failed",
                            exc_info=True)

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._worker_lock:
            if self._worker is not None and self._worker.is_alive():
                return
            if self._closed:
                return
            self._worker = threading.Thread(
                target=self._worker_loop, name="diskcache-writer",
                daemon=True)
            self._worker.start()

    def flush(self, timeout_s: float = 5.0) -> None:
        """Drain pending write-behind entries (shutdown + tests)."""
        import time as _time
        deadline = _time.monotonic() + timeout_s
        while not self._queue.empty():
            if _time.monotonic() >= deadline:
                return
            _time.sleep(0.01)

    def close(self) -> None:
        self._closed = True
        worker = self._worker
        if worker is not None and worker.is_alive():
            self.flush()
            self._queue.put(None)
            worker.join(timeout=5.0)

    # ------------------------------------------------------- async face

    async def get(self, key: str) -> Optional[bytes]:
        return await asyncio.to_thread(self.get_sync, key)

    async def contains(self, key: str) -> bool:
        """Existence probe — one stat, no read/verify/mtime effect
        (``CacheStack.probe_tiered``'s view).  A corrupt entry may read
        present here and still degrade to an honest MISS on the real
        ``get``; a residency HINT may be optimistic, a byte path may
        not."""
        return await asyncio.to_thread(os.path.exists,
                                       self._path_of(key))

    async def set(self, key: str, value: bytes) -> None:
        if self.sync_writes:
            await asyncio.to_thread(self.set_sync, key, value)
            return
        self._ensure_worker()
        try:
            self._queue.put_nowait((key, value))
        except queue.Full:
            # Never block a render behind disk I/O: drop and count.
            telemetry.PERSIST.count_disk_write(dropped=True)

    # ------------------------------------------------------- enumeration

    def keys_sync(self, limit: int = 0) -> List[str]:
        """Stored keys, most-recently-used first (entry headers carry
        the key verbatim) — the snapshot engine's view of what is
        durable.  ``limit`` 0 = all."""
        out: List[str] = []
        for _mtime, path, _size in reversed(self._entry_mtimes()):
            try:
                with open(path, "rb") as f:
                    head = f.read(_HEADER.size)
                    if len(head) < _HEADER.size:
                        continue
                    magic, key_len, _vlen, _dig = _HEADER.unpack(head)
                    if magic != _MAGIC:
                        continue
                    kb = f.read(key_len)
                if len(kb) == key_len:
                    out.append(kb.decode("utf-8", "replace"))
            except OSError:
                continue
            if limit and len(out) >= limit:
                break
        return out
