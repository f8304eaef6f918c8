"""Port ``io.devicecache.DeviceRawCache`` on the CPU: the contracts of
``tests/test_devicecache.py`` (load once, byte budget, digest aliases,
racing identical content; the last two with ``digest_index`` on, as the
JAX cache has it by default), plus the default cache's copy without a
digest, ``get`` after ``evict_to_fraction`` and a loader that fills a
pinned ``HostPlanes`` buffer."""

import threading

import numpy as np
import torch

from omero_ms_image_region_tpu_torch.io.devicecache import (
    DeviceRawCache, plane_digest, plane_key, region_key,
)
from omero_ms_image_region_tpu_torch.io.staging import HostPlanes, stage

TILE_BYTES = 2 * 8 * 8 * 4


def _cache(**kw):
    return DeviceRawCache(device="cpu", **kw)


def test_same_key_loads_once_and_counts():
    cache = _cache(max_bytes=1 << 30)
    calls = []

    def loader():
        calls.append(1)
        return np.ones((2, 8, 8), np.float32)

    key = region_key(1, 0, 0, 0, (0, 0, 8, 8), (0, 1))
    a = cache.get_or_load(key, loader)
    b = cache.get_or_load(key, loader)
    assert len(calls) == 1
    assert a is b
    assert (cache.hits, cache.misses) == (1, 1)
    assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), 1.0)


def test_eviction_respects_byte_budget():
    cache = _cache(max_bytes=TILE_BYTES * 2)
    for i in range(4):
        cache.get_or_load(("k", i), lambda i=i: np.full((2, 8, 8), float(i),
                                                        np.float32))
    assert len(cache) == 2
    assert cache.size_bytes == TILE_BYTES * 2
    assert cache.evictions == 2
    misses = cache.misses
    cache.get_or_load(("k", 0), lambda: np.zeros((2, 8, 8), np.float32))
    assert cache.misses == misses + 1


def test_default_cache_copies_identical_content_without_hashing(
        monkeypatch):
    """Dedup is off by default: no digest is taken, and identical content
    under two keys is two tensors and two byte charges."""
    from omero_ms_image_region_tpu_torch.io import devicecache

    def no_digest(arr):
        raise AssertionError("the default cache hashed a miss")

    monkeypatch.setattr(devicecache, "plane_digest", no_digest)
    cache = _cache(max_bytes=TILE_BYTES * 4)
    a, b = (cache.get_or_load(("k", i),
                              lambda: np.zeros((2, 8, 8), np.float32))
            for i in range(2))
    assert a is not b
    assert cache.size_bytes == TILE_BYTES * 2
    assert (cache.plane_hits, cache.plane_misses) == (0, 0)


def test_digest_aliases_share_tensor_and_bytes():
    cache = _cache(max_bytes=TILE_BYTES * 4, digest_index=True)
    arrs = [cache.get_or_load(("k", i),
                              lambda: np.zeros((2, 8, 8), np.float32))
            for i in range(3)]
    assert arrs[0] is arrs[1] is arrs[2]
    assert len(cache) == 3
    assert cache.size_bytes == TILE_BYTES
    assert (cache.plane_hits, cache.plane_misses) == (2, 1)
    # Distinct content pushes the aliases out one by one; the shared
    # bytes leave the budget with the last of them.
    for i in range(4):
        cache.get_or_load(("fresh", i), lambda i=i: np.full(
            (2, 8, 8), 1.0 + i, np.float32))
    assert cache.evictions == 3
    assert cache.size_bytes == TILE_BYTES * 4
    assert cache.get_by_digest(plane_digest(
        np.zeros((2, 8, 8), np.float32))) is None


def test_racing_identical_content_misses_share_one_tensor():
    cache = _cache(digest_index=True)
    content = np.arange(2 * 8 * 8, dtype=np.uint16).reshape(2, 8, 8)
    barrier = threading.Barrier(2, timeout=30)

    def load():
        barrier.wait()          # both threads inside the miss path at once
        return content.copy()

    outs = [None, None]

    def worker(i):
        outs[i] = cache.get_or_load(("r", i), load)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert outs[0] is outs[1]
    assert cache.size_bytes == content.nbytes
    assert len(cache) == 2
    assert outs[0].dtype == torch.uint16
    np.testing.assert_array_equal(outs[0].view(torch.int16).numpy().view(
        np.uint16), content)


def test_get_after_evict_to_fraction():
    cache = _cache(max_bytes=TILE_BYTES * 4)
    for i in range(4):
        cache.get_or_load(("k", i), lambda i=i: np.full((2, 8, 8), float(i),
                                                        np.float32))
    cache.get(("k", 0))                 # bump: k0 is now the newest
    assert cache.evict_to_fraction(0.5) == 2
    assert cache.size_bytes == TILE_BYTES * 2
    assert cache.get(("k", 1)) is None and cache.get(("k", 2)) is None
    hits = cache.hits
    assert cache.get(("k", 0)) is not None and cache.get(("k", 3)) is not None
    assert cache.hits == hits + 2
    cache.clear()
    assert len(cache) == 0 and cache.size_bytes == 0


def test_pinned_loader_and_plane_key():
    """A loader may fill ``HostPlanes`` (the handler reads straight into
    the pinned buffer); the entry holds the same planes, and a content
    entry under ``plane_key`` aliases it."""
    cache = _cache(digest_index=True)
    content = np.random.default_rng(0).integers(
        0, 60000, (3, 5, 7)).astype(np.uint16)

    def loader():
        planes = HostPlanes(content.shape, content.dtype, "cpu")
        planes.array[...] = content
        return planes

    t = cache.get_or_load(region_key(1, 0, 0, 0, (0, 0, 7, 5), (0, 1, 2)),
                          loader)
    assert t.dtype == torch.uint16 and tuple(t.shape) == content.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(
        np.uint16), content)
    alias = cache.get_or_load(plane_key(plane_digest(content)),
                              lambda: content)
    assert alias is t and cache.size_bytes == content.nbytes
    staged = stage(content.astype(np.int32), "cpu")
    assert staged.dtype == torch.float32         # other types: float32
