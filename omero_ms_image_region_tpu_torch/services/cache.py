"""Byte caches for rendered regions, masks and pixels metadata.

The port's copy of the JAX package's ``services/cache.py``, the
counterpart of the reference's ``RedisCacheVerticle`` get/set events
(``ImageRegionRequestHandler.java:214-249, 469-477``; ``ShapeMaskVerticle
.java:82-90, 140-148``) and its per-cache enable flags.

Tiering: a process-local LRU, then, with ``persistence.enabled``, the
durable disk tier (``services.diskcache``: one store shared by the three
caches under the ``img:``, ``meta:`` and ``mask:`` namespaces), then an
optional shared Redis.  The local tier is the native C++ LRU (``native.NativeLRUCache``, built with
g++ at first use) when its library builds, else :class:`MemoryLRUCache`;
both are host byte stores, as in the JAX package.  Redis needs the
``redis`` package (``redis.asyncio``); without it the caches keep their
local tier and the app logs that the Redis tier and the shared canRead
memo are off.  A tier that fails reads as a miss and drops its write, with
a warning at most every 30 s a tier, so an outage never turns a request
into a 500.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Tuple

log = logging.getLogger("omero_ms_image_region_tpu_torch.cache")

# One warning a tier an interval: an outage shows in the log without
# flooding it at request rate.
_WARN_INTERVAL_S = 30.0


class CacheTier(Protocol):
    async def get(self, key: str) -> Optional[bytes]: ...
    async def set(self, key: str, value: bytes) -> None: ...


class MemoryLRUCache:
    """Thread-safe LRU of bytes values bounded by their total size.  Its
    async face completes at once (in-memory operations only)."""

    def __init__(self, max_bytes: int = 256 * 1024 * 1024):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._data: "OrderedDict[str, bytes]" = OrderedDict()
        self._size = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_sync(self, key: str) -> Optional[bytes]:
        with self._lock:
            value = self._data.get(key)
            if value is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def set_sync(self, key: str, value: bytes) -> None:
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._size -= len(old)
            self._data[key] = value
            self._size += len(value)
            while self._size > self.max_bytes and self._data:
                _, evicted = self._data.popitem(last=False)
                self._size -= len(evicted)
                self.evictions += 1

    def keys_by_recency(self, limit: int = 0) -> List[str]:
        """Resident keys, most recently used first (``limit`` 0: all)."""
        with self._lock:
            keys = list(reversed(self._data.keys()))
        return keys[:limit] if limit else keys

    async def contains(self, key: str) -> bool:
        """Is ``key`` resident?  No LRU bump, no hit or miss counted."""
        with self._lock:
            return key in self._data

    async def get(self, key: str) -> Optional[bytes]:
        return self.get_sync(key)

    async def set(self, key: str, value: bytes) -> None:
        self.set_sync(key, value)


def _native_cache(max_bytes: int):
    """The native LRU tier if its library builds, else None."""
    try:
        from ..native import NativeLRUCache
        return NativeLRUCache(max_bytes)
    except Exception:
        return None


class TTLCacheTier(Protocol):
    """A tier whose entries can expire (the shared canRead memo's)."""

    async def set_ttl(self, key: str, value: bytes,
                      ttl_seconds: float) -> None: ...


class RedisCache:
    """The shared Redis byte cache.  Building one raises ImportError when
    the ``redis`` package is missing."""

    def __init__(self, uri: str):
        import redis.asyncio as aioredis
        self._client = aioredis.from_url(uri)

    async def get(self, key: str) -> Optional[bytes]:
        return await self._client.get(key)

    async def set(self, key: str, value: bytes) -> None:
        await self._client.set(key, value)

    async def contains(self, key: str) -> bool:
        """EXISTS: residency without moving the value."""
        return bool(await self._client.exists(key))

    async def set_ttl(self, key: str, value: bytes,
                      ttl_seconds: float) -> None:
        await self._client.set(key, value, px=max(1, int(ttl_seconds * 1000)))

    async def close(self) -> None:
        await self._client.aclose()


async def get_with_tier(stack, key: str
                        ) -> "Tuple[Optional[bytes], Optional[str]]":
    """``(value, tier label)`` from any stack-shaped object: a
    :class:`CacheStack` answers through :meth:`CacheStack.get_tiered`; an
    object with only ``get`` gives an unlabelled hit."""
    fn = getattr(stack, "get_tiered", None)
    if fn is not None:
        return await fn(key)
    return await stack.get(key), None


async def probe_with_tier(stack, key: str) -> Optional[str]:
    """The label of the tier holding ``key`` (None: not resident), without
    a back-fill: :meth:`CacheStack.probe_tiered` where the stack has it,
    else a bare ``get`` labelled "memory"."""
    fn = getattr(stack, "probe_tiered", None)
    if fn is not None:
        return await fn(key)
    return "memory" if (await stack.get(key)) is not None else None


def tier_label(tier) -> str:
    """A tier's short label, "memory", "disk" or "redis": its
    ``tier_label`` attribute when it has one, else "redis" for a Redis
    class and "memory" for the rest (the native and Python LRUs)."""
    explicit = getattr(tier, "tier_label", None)
    if explicit:
        return str(explicit)
    return "redis" if "Redis" in type(tier).__name__ else "memory"


class CacheStack:
    """Read-through tiers: the first hit wins and is written back into
    the tiers above it.  A failing tier reads as a miss and its write is
    dropped (the reference answers a failed Redis get with null too), so
    the render path keeps serving uncached.  Disabled, it holds nothing:
    every get misses without touching a tier and every set is dropped."""

    def __init__(self, tiers: List[CacheTier], enabled: bool = True):
        self.tiers = tiers
        self.enabled = enabled
        self._last_warn: Dict[int, float] = {}

    def _warn_tier(self, i: int, op: str, e: Exception) -> None:
        now = time.monotonic()
        if now - self._last_warn.get(i, 0.0) >= _WARN_INTERVAL_S:
            self._last_warn[i] = now
            log.warning("cache tier %d (%s) %s failed, degrading: %s",
                        i, type(self.tiers[i]).__name__, op, e)

    async def get(self, key: str) -> Optional[bytes]:
        value, _tier = await self.get_tiered(key)
        return value

    async def probe_tiered(self, key: str) -> Optional[str]:
        """The label of the first tier holding ``key``, with no
        back-fill, no LRU bump and, where a tier has ``contains``, no
        value moved (a tier without it is asked with ``get``)."""
        if not self.enabled:
            return None
        for i, tier in enumerate(self.tiers):
            try:
                probe = getattr(tier, "contains", None)
                if probe is not None:
                    present = await probe(key)
                else:
                    present = (await tier.get(key)) is not None
            except Exception as e:
                self._warn_tier(i, "probe", e)
                continue
            if present:
                return tier_label(tier)
        return None

    async def get_tiered(self, key: str
                         ) -> "Tuple[Optional[bytes], Optional[str]]":
        """``(value, label of the tier that answered)``, ``(None, None)``
        on a miss; a hit is written back into the tiers above."""
        if not self.enabled:
            return None, None
        for i, tier in enumerate(self.tiers):
            try:
                value = await tier.get(key)
            except Exception as e:
                self._warn_tier(i, "get", e)
                continue
            if value is not None:
                for upper in self.tiers[:i]:
                    try:
                        await upper.set(key, value)
                    except Exception as e:
                        self._warn_tier(self.tiers.index(upper), "set", e)
                return value, tier_label(tier)
        return None, None

    async def set(self, key: str, value: bytes) -> None:
        if not self.enabled:
            return
        results = await asyncio.gather(
            *(t.set(key, value) for t in self.tiers),
            return_exceptions=True)
        for i, r in enumerate(results):
            if isinstance(r, Exception):
                self._warn_tier(i, "set", r)


@dataclass
class CacheConfig:
    """The per-cache enable flags and sizes (the reference's
    ``config.yaml:47-60``), off by default as there."""

    redis_uri: Optional[str] = None
    local_max_bytes: int = 256 * 1024 * 1024
    image_region: bool = False         # image-region-cache.enabled
    pixels_metadata: bool = False      # pixels-metadata-cache.enabled
    shape_mask: bool = False           # shape-mask-cache.enabled
    # The durable disk tier (services.diskcache); the app sets it from
    # persistence.dir.
    disk_dir: Optional[str] = None
    disk_max_bytes: int = 1024 * 1024 * 1024
    disk_sync_writes: bool = False

    @classmethod
    def enabled_all(cls, **kwargs) -> "CacheConfig":
        return cls(image_region=True, pixels_metadata=True,
                   shape_mask=True, **kwargs)


def make_cache(config: CacheConfig, enabled: bool,
               redis: Optional[RedisCache] = None,
               disk: Optional[CacheTier] = None) -> CacheStack:
    """One named cache's stack: the local LRU, then ``disk`` and then
    ``redis`` when given (one shared client for every stack and the memo,
    as the reference runs one ``RedisCacheVerticle``)."""
    tiers: List[CacheTier] = []
    native = _native_cache(config.local_max_bytes)
    tiers.append(native if native is not None
                 else MemoryLRUCache(config.local_max_bytes))
    if disk is not None:
        tiers.append(disk)
    if redis is not None:
        tiers.append(redis)
    return CacheStack(tiers, enabled=enabled)


class NamespacedTier:
    """One shared tier seen by one named cache: its keys gain ``prefix``,
    and its counters are the shared tier's."""

    def __init__(self, inner, prefix: str, tier_label: str = "disk"):
        self.inner = inner
        self.prefix = prefix
        self.tier_label = tier_label

    async def get(self, key: str) -> Optional[bytes]:
        return await self.inner.get(self.prefix + key)

    async def set(self, key: str, value: bytes) -> None:
        await self.inner.set(self.prefix + key, value)

    async def contains(self, key: str) -> bool:
        probe = getattr(self.inner, "contains", None)
        if probe is not None:
            return await probe(self.prefix + key)
        return (await self.inner.get(self.prefix + key)) is not None

    @property
    def hits(self):
        return self.inner.hits

    @property
    def misses(self):
        return self.inner.misses

    @property
    def evictions(self):
        return self.inner.evictions


@dataclass
class Caches:
    """The three named caches (``config.yaml:53-60``), the one shared
    Redis client they and the canRead memo ride, and the one durable disk
    tier they share (``services.diskcache.DiskByteCache``, or None)."""

    image_region: CacheStack
    pixels_metadata: CacheStack
    shape_mask: CacheStack
    redis: Optional[RedisCache] = None
    disk: object = None

    @classmethod
    def disabled(cls) -> "Caches":
        """Three disabled stacks: the services' default, for handlers
        built by hand (their tiers are never touched, so no native
        build)."""
        return cls(*(CacheStack([MemoryLRUCache()], enabled=False)
                     for _ in range(3)))

    @classmethod
    def from_config(cls, config: CacheConfig) -> "Caches":
        redis = None
        if config.redis_uri:
            try:
                redis = RedisCache(config.redis_uri)
            except ImportError:
                pass
        disk = None
        if config.disk_dir:
            from .diskcache import DiskByteCache
            disk = DiskByteCache(config.disk_dir,
                                 max_bytes=config.disk_max_bytes,
                                 sync_writes=config.disk_sync_writes)

        def disk_view(prefix: str):
            return NamespacedTier(disk, prefix) if disk is not None else None

        return cls(
            image_region=make_cache(config, config.image_region, redis,
                                    disk=disk_view("img:")),
            pixels_metadata=make_cache(config, config.pixels_metadata,
                                       redis, disk=disk_view("meta:")),
            shape_mask=make_cache(config, config.shape_mask, redis,
                                  disk=disk_view("mask:")),
            redis=redis, disk=disk)

    async def close(self) -> None:
        if self.disk is not None:
            # Drain the write-behind queue: the bytes of this life's last
            # seconds are the next life's.
            await asyncio.to_thread(self.disk.close)
        if self.redis is not None:
            await self.redis.close()
