"""Warm restarts of the port against the JAX package: the disk byte tier,
the shutdown chain, the warm-state snapshot and rehydrate, the build store
and the ``persistence`` settings.

* ``services.diskcache``: both packages write the same entry bytes for one
  key and value and read each other's; corrupt, torn and foreign entries
  read as a miss and are removed in both; the tier's bounds (oldest-first
  eviction, the write-behind queue's counted drops, the orphan tmp sweep)
  behave alike.
* ``server.shutdown``: the chain is ordered, guarded and once only, and
  both packages' chains put the snapshot before the flight dump.
* Both default apps with persistence on, from one config dict over one
  data tree (``tests/torch_workload_apps.py``), serve the same GETs,
  snapshot, and come back over the same directories: the manifests list
  the same byte keys and planes, the repeats answer life 1's bytes from
  the disk tier with no render, ``/readyz``'s ``rehydrate`` strings agree,
  a re-windowed GET of a re-staged plane is a raw-cache hit, and the doc
  keys of ``/debug/warmstate`` and ``/debug/flightrecorder`` agree.
* The port's manifest cases: a manifest of another fingerprint skips the
  build store's preload and still replays bytes and planes; a corrupt
  persistence directory serves cold and never 5xx; persistence off serves
  the JAX app's bytes and headers.
* ``server.execcache`` for real, on g++ (the native codecs' helper) and on
  a stand-in nvcc (the kernels' helper): a second store over the same
  directory loads without compiling; a changed fingerprint builds again;
  a truncated stored library is deleted, counted and built again.
* The ``persistence`` block and the flight-recorder keys parse as JAX's,
  and JAX's invalid blocks fail the port's load too.
"""

import asyncio
import ctypes
import json
import os
import shutil
import subprocess
import types

import numpy as np
import pytest

from omero_ms_image_region_tpu.server import shutdown as jax_shutdown
from omero_ms_image_region_tpu.server.app import (
    SERVICES_KEY, create_app as jax_app)
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.services import diskcache as jax_disk
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch import native
from omero_ms_image_region_tpu_torch.kernels import build
from omero_ms_image_region_tpu_torch.server import execcache, shutdown
from omero_ms_image_region_tpu_torch.server.app import (
    build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.services import diskcache
from omero_ms_image_region_tpu_torch.utils import telemetry
from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

from torch_workload_apps import CH, IMG, exchange, write_tree

CH2 = "c=1|500:30000$FF0000,2|300:45000$00FF00&m=c"
TILE = f"/webgateway/render_image_region/{IMG}/0/0/?tile=0,{{}},{{}},128,128"
REQUESTS = [TILE.format(0, 0) + f"&{CH}&format=jpeg",
            TILE.format(1, 1) + f"&{CH}&format=jpeg",
            "/webgateway/render_shape_mask/1?color=FF0000"]
REWINDOWED = TILE.format(0, 0) + f"&{CH2}&format=jpeg"


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    jax_telemetry.reset()
    yield
    execcache.install(None)
    telemetry.reset()
    jax_telemetry.reset()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("warm_tree")))


# ---------------------------------------------------------- disk entries

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entries_are_the_jax_bytes(seed):
    rng = np.random.default_rng(seed)
    key = "img:" + "".join(map(chr, rng.integers(33, 127, 40)))
    value = rng.integers(0, 256, int(rng.integers(0, 5000)),
                         dtype=np.uint8).tobytes()
    mine, theirs = diskcache.encode_entry(key, value), \
        jax_disk.encode_entry(key, value)
    assert mine == theirs
    assert diskcache.decode_entry(theirs, key) == value
    assert jax_disk.decode_entry(mine, key) == value
    # The file name too: either package reads the other's directory.
    assert (diskcache.DiskByteCache("d")._path_of(key)
            == jax_disk.DiskByteCache("d")._path_of(key))


@pytest.mark.parametrize("mutate", [
    lambda b: b[:len(b) // 2],                      # torn
    lambda b: b"",                                  # zero-length
    lambda b: bytes([b[0] ^ 0xFF]) + b[1:],         # magic
    lambda b: b[:-1] + bytes([b[-1] ^ 0x01]),       # payload bit
    lambda b: b + b"trailing",                      # grown
    lambda b: b"not an entry at all",               # alien
    lambda b: jax_disk.encode_entry("other", b"x"),  # another key's
], ids=["torn", "empty", "magic", "bit", "grown", "alien", "foreign"])
def test_bad_entries_read_as_a_miss_and_go(tmp_path, mutate):
    out = []
    for mod, tel in ((diskcache, telemetry), (jax_disk, jax_telemetry)):
        c = mod.DiskByteCache(str(tmp_path / mod.__name__),
                              sync_writes=True)
        c.set_sync("k", b"precious bytes")
        path = c._path_of("k")
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(mutate(blob))
        out.append((c.get_sync("k"), os.path.exists(path),
                    tel.PERSIST.diskcache_corrupt, c.misses))
    assert out[0] == out[1] == (None, False, 1, 1)


def _tier_script(mod, tel, root, case):
    """One case of the disk tier's bounds; every observable, in order."""
    if case == "evict":
        c = mod.DiskByteCache(root, max_bytes=4096, sync_writes=True)
        for i in range(32):
            c.set_sync(f"k{i}", bytes(300))
        return (c.size_bytes, c.evictions, len(c),
                sorted(c.keys_sync()),
                [c.get_sync(f"k{i}") is not None for i in (0, 20, 31)])
    if case == "drop":
        c = mod.DiskByteCache(root, sync_writes=False)

        async def go():
            # A closed cache never starts its worker: the bounded queue
            # fills and the overflow is dropped, counted, never waited on.
            c._closed = True
            c._queue.maxsize = 1
            for k in "abc":
                await c.set(k, b"1")
        asyncio.run(go())
        return (tel.PERSIST.diskcache_write_dropped, c._queue.qsize())
    if case == "orphan":
        c = mod.DiskByteCache(root, max_bytes=2048, sync_writes=True)
        c.set_sync("k", b"v")
        orphan = os.path.join(os.path.dirname(c._path_of("k")),
                              "deadbeef.irb.tmp.123.456")
        with open(orphan, "wb") as f:
            f.write(b"half a write")
        for i in range(16):
            c.set_sync(f"fill{i}", bytes(300))
        return (os.path.exists(orphan), c.evictions)
    c = mod.DiskByteCache(root, sync_writes=True)     # "recency"
    for i in range(5):
        c.set_sync(f"key-{i}", b"x" * i)
        os.utime(c._path_of(f"key-{i}"), (1000 + i, 1000 + i))
    os.utime(c._path_of("key-1"), (2000, 2000))       # the read bump
    reopened = mod.DiskByteCache(root, sync_writes=True)
    return (c.keys_sync(), c.keys_sync(limit=2), len(reopened),
            reopened.get_sync("key-3"), tel.PERSIST.diskcache_writes)


@pytest.mark.parametrize("case", ["evict", "drop", "orphan", "recency"])
def test_disk_tier_bounds_behave_as_jax(tmp_path, case):
    mine = _tier_script(diskcache, telemetry, str(tmp_path / "port"), case)
    theirs = _tier_script(jax_disk, jax_telemetry, str(tmp_path / "jax"),
                          case)
    assert mine == theirs
    if case == "evict":
        assert mine[0] <= 4096 and mine[1] > 0 and mine[4] == [
            False, True, True]
    elif case == "drop":
        assert mine == (2, 1)
    elif case == "orphan":
        assert mine[0] is False
    else:
        assert mine[0] == ["key-1", "key-4", "key-3", "key-2", "key-0"]


# -------------------------------------------------------- shutdown chain

@pytest.mark.parametrize("mod", [shutdown, jax_shutdown],
                         ids=["port", "jax"])
def test_chain_is_ordered_guarded_once_only(mod):
    ran = []
    chain = mod.ShutdownChain()
    chain.add("snapshot", lambda: ran.append("snapshot"))
    chain.add("boom", lambda: 1 / 0)
    chain.add("dump", lambda: ran.append("dump"))
    assert chain.run("test") == [("snapshot", True), ("boom", False),
                                 ("dump", True)]
    assert chain.run("again") == []
    assert ran == ["snapshot", "dump"]


def test_both_chains_snapshot_before_the_dump(tmp_path):
    def chain_of(mod, tel, cfg, fail_snapshot):
        order = []

        def snapshot():
            order.append("snapshot")
            if fail_snapshot:
                raise OSError("disk gone")

        services = types.SimpleNamespace(
            warmstate=types.SimpleNamespace(snapshot_now=snapshot),
            renderer=types.SimpleNamespace(exec_cache=types.SimpleNamespace(
                drain=lambda timeout_s: order.append("drain"))))
        tel.FLIGHT.record("signal", sig="SIGTERM")
        chain = mod.build_shutdown_chain(cfg, services)
        names = [name for name, _ in chain._hooks]
        results = chain.run("SIGTERM")
        dumps = os.listdir(cfg.telemetry.flight_recorder_dir)
        with open(os.path.join(cfg.telemetry.flight_recorder_dir,
                               dumps[0])) as f:
            doc = json.load(f)
        return (names, order, results, len(dumps), sorted(doc),
                [e["kind"] for e in doc["events"]], doc["reason"])

    for fail in (False, True):
        out = []
        for mod, tel, cls in ((shutdown, telemetry, AppConfig),
                              (jax_shutdown, jax_telemetry, JaxConfig)):
            tel.reset()
            cfg = cls()
            cfg.telemetry.flight_recorder_dir = str(
                tmp_path / f"{mod.__name__}-{fail}")
            out.append(chain_of(mod, tel, cfg, fail))
        assert out[0] == out[1]
        assert out[0][0] == ["warmstate-snapshot", "execcache-drain",
                             "flight-dump"]
        assert out[0][1] == ["snapshot", "drain"]
        assert out[0][2][0] == ("warmstate-snapshot", not fail)
        assert out[0][2][-1] == ("flight-dump", True)


# ---------------------------------------------------- warm restart vs JAX

def _raw(tree, warm, **persistence) -> dict:
    return {"data-dir": tree, "renderer": {"cpu-fallback-max-px": 0},
            "raw-cache": {"prefetch": False}, "watchdog": {"enabled": False},
            "image-region-cache": {"enabled": True},
            "pixels-metadata-cache": {"enabled": True},
            "shape-mask-cache": {"enabled": True},
            "persistence": dict({"enabled": True, "dir": str(warm),
                                 "snapshot-interval-s": 0}, **persistence)}


def _app(pkg, raw):
    """(app, services) of one package's default app; disk writes inline,
    so a snapshot lists every key written."""
    if pkg == "jax":
        cfg = JaxConfig.from_dict(dict(raw))
        cfg.caches.disk_sync_writes = True
        app = jax_app(cfg)
        return app, app[SERVICES_KEY]
    cfg = AppConfig.from_dict(dict(raw))
    cfg.caches.disk_sync_writes = True
    handler = ImageRegionHandler(build_services(cfg, "cpu"))
    return create_app(cfg, "cpu", handler=handler), handler.s


def _life(pkg, raw, urls, snapshot=False):
    """One life: wait for the boot rehydrate, ``/readyz``, each URL,
    optionally ``/debug/warmstate?snapshot=1``, then
    ``/debug/flightrecorder``.  Returns the answers (status, headers,
    body), the services and the renders the batcher made."""
    from aiohttp.test_utils import TestClient, TestServer

    app, services = _app(pkg, raw)
    thread = getattr(services.warmstate, "_rehydrate_thread", None)
    if thread is not None:          # both packages' rehydrate thread
        thread.join(timeout=60)
        assert not thread.is_alive()

    async def go():
        out = []
        async with TestClient(TestServer(app)) as client:
            paths = ["/readyz"] + list(urls) + (
                ["/debug/warmstate?snapshot=1"] if snapshot else []) + [
                "/debug/warmstate", "/debug/flightrecorder"]
            for path in paths:
                r = await client.get(path)
                out.append((r.status, r.headers, await r.read()))
        return out

    rendered0 = services.renderer.tiles_rendered
    out = asyncio.run(go())
    return out, services, services.renderer.tiles_rendered - rendered0


def _manifest(warm):
    with open(os.path.join(warm, "manifest.json")) as f:
        return json.load(f)


def test_warm_restart_matches_jax(tree, tmp_path):
    lives = {}
    for pkg in ("jax", "port"):
        warm = tmp_path / pkg
        raw = _raw(tree, warm, executables=False)
        first, _, rendered1 = _life(pkg, raw, REQUESTS, snapshot=True)
        doc = _manifest(warm)
        telemetry.reset()
        jax_telemetry.reset()
        REGISTRY.reset()
        second, services, rendered2 = _life(
            pkg, raw, REQUESTS + [REWINDOWED])
        lives[pkg] = (first, second, doc, rendered1, rendered2,
                      services.raw_cache.hits)
    (jf, js, jdoc, *_), (pf, ps, pdoc, rendered1, rendered2, hits) = (
        lives["jax"], lives["port"])
    n = len(REQUESTS)
    # Life 1: the same bytes, then a manifest of the same keys and planes.
    assert [a[0] for a in pf] == [a[0] for a in jf] == [200] * (n + 4)
    assert [a[2] for a in pf[1:n + 1]] == [a[2] for a in jf[1:n + 1]]
    assert rendered1 == 3
    assert {k: sorted(v) for k, v in pdoc["byte_keys"].items()} == {
        k: sorted(v) for k, v in jdoc["byte_keys"].items()}
    assert sum(map(len, pdoc["byte_keys"].values())) == 4
    assert (sorted(p["key"] for p in pdoc["planes"])
            == sorted(p["key"] for p in jdoc["planes"]))
    assert len(pdoc["planes"]) == 2
    assert pdoc["version"] == jdoc["version"] == 1
    # Life 2: rehydrated alike, and the repeats are life 1's bytes from
    # the byte tiers, with no render.
    ready = [json.loads(life[0][2])["checks"]["rehydrate"]
             for life in (js, ps)]
    assert ready[0] == ready[1] == "done 6/6"
    assert [a[2] for a in ps[1:n + 1]] == [a[2] for a in pf[1:n + 1]]
    assert [a[2] for a in js[1:n + 1]] == [a[2] for a in jf[1:n + 1]]
    for a, b in zip(ps[1:n + 1], pf[1:n + 1]):
        assert a[1]["ETag"] == b[1]["ETag"]
    # The re-windowed GET renders from the re-staged plane (a raw-cache
    # hit, no pixel read), with JAX's bytes.
    assert ps[n + 1][0] == js[n + 1][0] == 200
    assert ps[n + 1][2] == js[n + 1][2]
    assert rendered2 == 1 and hits == 1
    assert "PixelsService.readRegion" not in REGISTRY.snapshot()
    assert telemetry.PERSIST.rehydrate_planes_restaged == 2
    # The debug documents' keys.
    for i in (-2, -1):
        assert sorted(json.loads(ps[i][2])) == sorted(json.loads(js[i][2]))
    assert sorted(json.loads(pf[-3][2])) == sorted(json.loads(jf[-3][2]))
    kinds = {e["kind"] for e in json.loads(ps[-1][2])["events"]}
    assert {"warmstate.rehydrate.start", "warmstate.rehydrate.done",
            "batch.formed"} <= kinds


# ------------------------------------------------------- manifest cases

@pytest.fixture(scope="module")
def seeded(tree, tmp_path_factory):
    """Life 1 of the port with the build store on: its warm directory, its
    answers and its manifest."""
    telemetry.reset()
    warm = tmp_path_factory.mktemp("seeded") / "warm"
    first, _, _ = _life("port", _raw(tree, warm), REQUESTS, snapshot=True)
    execcache.install(None)
    return str(warm), first, _manifest(str(warm))


@pytest.mark.parametrize("case", ["fingerprint", "corrupt", "off"])
def test_manifest_cases(tree, seeded, tmp_path, case):
    warm0, first, doc = seeded
    assert doc["executables"] and json.loads(doc["fingerprint"])["g++"]
    warm = str(tmp_path / "warm")
    shutil.copytree(warm0, warm)
    if case == "fingerprint":
        doc = dict(doc, fingerprint="another toolchain and card")
        with open(os.path.join(warm, "manifest.json"), "w") as f:
            json.dump(doc, f)
    elif case == "corrupt":
        rng = np.random.default_rng(5)
        for dirpath, _dirs, names in os.walk(warm):
            for name in names:
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    b = bytearray(f.read())
                for _ in range(3):
                    b[int(rng.integers(0, len(b)))] ^= 0xA5
                with open(path, "wb") as f:
                    f.write(bytes(b))
    raw = _raw(tree, warm)
    if case == "off":
        raw.pop("persistence")
    second, services, rendered = _life("port", raw, REQUESTS)
    assert [a[0] for a in second] == [200] * (len(REQUESTS) + 3)
    assert [a[2] for a in second[1:-2]] == [a[2] for a in first[1:-3]]
    checks = json.loads(second[0][2])["checks"]
    warmstate = json.loads(second[-2][2])
    persist = telemetry.PERSIST
    if case == "fingerprint":
        assert persist.rehydrate_executables_loaded == 0
        assert persist.rehydrate_planes_restaged == 2
        assert persist.rehydrate_bytes_promoted > 0 and rendered == 0
        assert checks["rehydrate"] == "done 6/6"
    elif case == "corrupt":
        # Nothing poisoned: a corrupt manifest is a cold boot, and every
        # corrupt entry was refused, counted and removed.
        assert checks["rehydrate"] == "idle" and rendered == 3
        assert persist.diskcache_corrupt == 4
        assert persist.execcache_corrupt >= 1
    else:
        # Persistence off: no disk tier, no store, no rehydrate, and the
        # JAX app's bytes and headers.
        assert services.warmstate is None and services.caches.disk is None
        assert services.renderer.exec_cache is None
        assert sorted(checks) == ["prewarm", "queue", "sentinel"]
        assert warmstate == {"enabled": False, "rehydrate": "idle",
                             "snapshots": 0, "snapshot_errors": 0}
        jax, _ = exchange(raw, [("GET", u, {}) for u in REQUESTS])
        for (ps, ph, pb), (js, jh, jb) in zip(second[1:-2], jax):
            assert (ps, pb) == (js, jb)
            for k in ("ETag", "Cache-Control", "Content-Type"):
                assert ph.get(k) == jh.get(k)


# ---------------------------------------------------------- build store

class _Compiles:
    """Counts the compiler runs that build (``--version`` runs aside)."""

    def __init__(self, monkeypatch):
        self.runs = []
        real = subprocess.run

        def run(cmd, *args, **kwargs):
            if "--version" not in cmd:
                self.runs.append(os.path.basename(cmd[0]))
            return real(cmd, *args, **kwargs)
        monkeypatch.setattr(subprocess, "run", run)


def _helper(tmp_path, monkeypatch, helper):
    """(build function giving the library path, compiler name)."""
    if helper == "native":
        src = tmp_path / "seven.cpp"
        src.write_text('extern "C" int seven() { return 7; }\n')
        return (lambda: native.build(src)), "g++"
    src = tmp_path / "seven.cu"
    src.write_text('extern "C" int seven() { return 7; }\n')
    fake = tmp_path / "nvcc"
    # A stand-in for nvcc: g++ on the same source, no CUDA.
    fake.write_text('#!/bin/sh\n[ "$1" = --version ] && echo fake nvcc '
                    '&& exit 0\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'exec g++ -shared -fPIC -x c++ -o "$2" "$3"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    return (lambda: build.build(src, ("-O3",))[0]), "nvcc"


@pytest.mark.parametrize("case", ["reload", "fingerprint", "truncated"])
@pytest.mark.parametrize("helper", ["native", "kernels"])
def test_build_store(tmp_path, monkeypatch, helper, case):
    compiles = _Compiles(monkeypatch)
    build_fn, compiler = _helper(tmp_path, monkeypatch, helper)
    # The libraries this process loaded earlier stay out of the store.
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(build, "_libs", {})
    store_dir = str(tmp_path / "executables")

    def deploy(n):
        """A fresh package directory: an empty _build/."""
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / f"n{n}")
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / f"k{n}")

    deploy(0)
    first = execcache.ExecutableCache(store_dir)
    execcache.install(first)
    lib = build_fn()
    assert compiles.runs == [compiler] and first.saved == 1
    assert ctypes.CDLL(str(lib)).seven() == 7
    [key] = first.stored_keys()
    deploy(1)
    second = execcache.ExecutableCache(store_dir)
    if case == "fingerprint":
        second._fingerprint = first.fingerprint().replace('"g++"', '"gxx"')
    elif case == "truncated":
        path = os.path.join(store_dir, key + ".lib")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    execcache.install(second)
    lib = build_fn()
    assert ctypes.CDLL(str(lib)).seven() == 7
    assert lib.parent == tmp_path / ("n1" if helper == "native" else "k1")
    kinds = [e["kind"] for e in telemetry.FLIGHT.snapshot()]
    if case == "reload":
        # Loaded, not compiled: the second deploy ran no compiler.
        assert compiles.runs == [compiler]
        assert (second.hits, second.loaded, second.saved) == (1, 1, 0)
        assert kinds == ["execcache.save", "execcache.load"]
        assert second.preload([key]) == 1
    elif case == "fingerprint":
        # A clean miss: built again and stored under its own key.
        assert compiles.runs == [compiler, compiler]
        assert (second.misses, second.saved) == (1, 1)
        assert len(second.stored_keys()) == 2
        assert second.preload([key]) == 0
    else:
        assert compiles.runs == [compiler, compiler]
        assert telemetry.PERSIST.execcache_corrupt == 1
        assert second.stored_keys() == [key] and second.saved == 1


# --------------------------------------------------------------- config

def test_persistence_and_flight_settings_parse_as_jax():
    raw = {"persistence": {"enabled": True, "dir": "/var/warm",
                           "disk-cache-max-bytes": 2 * 1024 * 1024,
                           "snapshot-interval-s": 30,
                           "rehydrate-concurrency": 4, "executables": False,
                           "snapshot-top-k": 7, "max-plane-entries": 9,
                           "rehydrate": False},
           "telemetry": {"flight-recorder-events": 64,
                         "flight-recorder-dir": "/var/flight"}}
    for doc in (raw, {}):
        mine, theirs = AppConfig.from_dict(doc), JaxConfig.from_dict(doc)
        assert vars(mine.persistence) == vars(theirs.persistence)
        for name in ("flight_recorder_events", "flight_recorder_dir"):
            assert (getattr(mine.telemetry, name)
                    == getattr(theirs.telemetry, name))
    assert AppConfig.from_dict({}).persistence.enabled is False


@pytest.mark.parametrize("block", [
    {"persistence": {"disk-cache-max-bytes": 1024}},
    {"persistence": {"snapshot-interval-s": -1}},
    {"persistence": {"rehydrate-concurrency": 0}},
    {"persistence": {"snapshot-top-k": 0}},
    {"telemetry": {"flight-recorder-events": 8}},
])
def test_invalid_blocks_fail_at_load(block):
    with pytest.raises(ValueError):
        JaxConfig.from_dict(block)
    with pytest.raises(ValueError):
        AppConfig.from_dict(block)
