"""The port's ``MeshRenderer`` (``parallel.serve``) at world size 1, on the
CPU, against the JAX package's on its 8-device virtual mesh
(``make_mesh(8, 2)``), and the ``parallel.enabled`` posture of both apps.

* Groups: mixed per-tile settings with C=3 (JAX pads to 4 for its chan
  axis of 2), full LUT tables, packed results equal; JPEG bytes equal,
  sparse and Huffman; the Huffman engine's pixels equal the sparse
  engine's.
* The overflow rescue: the launch sequence of the one-shot cap widening
  (base cap, then 2x, then the memo's 2x) as JAX's
  ``tests/test_mesh_serve.py:302``, and a tile past twice the cap coded
  from its dense coefficients; bytes equal to JAX's mesh and to the
  port's default route.
* HTTP: both apps with ``parallel.enabled`` serve the same
  ``render_image_region`` bytes.
* Config and startup: JAX's four errors, and a mesh wider than the world
  size refused by name.
* The batcher's lockstep hooks (``_growth_enabled``, ``_shared_slots``,
  ``_deadline_drop_enabled``).
"""

import asyncio
import io
import time

import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu.flagship import flagship_rdef as jax_flagship
from omero_ms_image_region_tpu.flagship import synthetic_wsi_tiles
from omero_ms_image_region_tpu.ops import jpegenc as J
from omero_ms_image_region_tpu.ops.render import (
    build_channel_tables, pack_settings)
from omero_ms_image_region_tpu.parallel.mesh import make_mesh as jax_mesh
from omero_ms_image_region_tpu.parallel.serve import (
    MeshRenderer as JaxMeshRenderer)
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.batcher import _Pending as JaxPending
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu_torch.ops import jpegenc as P
from omero_ms_image_region_tpu_torch.ops import render as R
from omero_ms_image_region_tpu_torch.parallel import mesh as M
from omero_ms_image_region_tpu_torch.parallel.serve import MeshRenderer
from omero_ms_image_region_tpu_torch.server.app import create_app
from omero_ms_image_region_tpu_torch.server.batcher import (
    BatchingRenderer, _Pending)
from omero_ms_image_region_tpu_torch.server.config import AppConfig

from torch_workload_apps import CH, IMG, write_tree


@pytest.fixture(autouse=True)
def _clean_memos():
    """No cap memo leaks between tests; the Huffman wire of both meshes
    codes with the fixed tables."""
    for mod in (J, P):
        mod._CAP_MEMO.clear()
    yield
    for mod in (J, P):
        mod._CAP_MEMO.clear()


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _settings(C, window_end=50000.0, reverse=()):
    rdef = jax_flagship(C)
    for i, cb in enumerate(rdef.channel_bindings):
        cb.input_start, cb.input_end = 0.0, window_end
        cb.reverse_intensity = i in reverse
    return pack_settings(rdef)


def _pair(**kw):
    """The port's renderer on its (1, 1) CPU mesh and JAX's on
    make_mesh(8, 2)."""
    port = MeshRenderer(M.make_mesh(device="cpu"), linger_ms=0.0, **kw)
    jax = JaxMeshRenderer(jax_mesh(8, chan_parallel=2), linger_ms=0.0,
                          **kw)
    return port, jax


def _serve(renderer, jobs, f32: bool):
    """Each (tile, settings, jpeg) through ``renderer`` at once."""
    async def go():
        async def one(tile, s, jpeg):
            t = tile.astype(np.float32) if f32 else tile
            if jpeg:
                return await renderer.render_jpeg(t, s, 85, t.shape[2],
                                                  t.shape[1])
            return await renderer.render(t, s)
        out = await asyncio.gather(*(one(*j) for j in jobs))
        await renderer.close()
        return out
    return run(go())


def _tiles(n, C, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 60000, (C, h, w)).astype(np.uint16)
            for _ in range(n)]


def _cells(n, C, h, w, seed):
    """Microscopy-like tiles whose JPEG wire fits the default budgets
    (noise would send every tile down the dense route)."""
    tiles = synthetic_wsi_tiles(np.random.default_rng(seed), n, C, h, w)
    return list(tiles // 8 + 15000)


def test_mixed_settings_with_chan_padding_match_jax():
    """C=3 (3 -> 4 on JAX's chan axis of 2), three windows and a reversed
    channel in one group: packed results equal."""
    port, jax = _pair()
    tiles = _tiles(3, 3, 40, 56, seed=0)
    jobs = [(t, _settings(3, 30000 + 10000 * i, reverse=(i,)), False)
            for i, t in enumerate(tiles)]
    got = _serve(port, jobs, f32=False)
    want = _serve(jax, jobs, f32=True)
    for g, w in zip(got, want):
        assert g.shape == (40, 56)
        np.testing.assert_array_equal(g, np.asarray(w))
    assert port.batches_dispatched >= 1 and port.tiles_rendered == 3
    assert port.lockstep and not port._multihost and port._pod is None


def test_full_lut_tables_match_jax():
    rdef = jax_flagship(2)
    for cb in rdef.channel_bindings:
        cb.reverse_intensity = True
    s = dict(pack_settings(rdef), tables=build_channel_tables(rdef))
    assert s["tables"].ndim == 3
    port, jax = _pair()
    tile = _tiles(1, 2, 32, 48, seed=7)[0]
    got = _serve(port, [(tile, s, False)], f32=False)
    want = _serve(jax, [(tile, s, False)], f32=True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


@pytest.mark.parametrize("engine", ["sparse", "huffman"])
def test_jpeg_bytes_match_jax(engine):
    """Two tiles that fill their 256x256 bucket, and a ragged 24x40 tile
    (edge-padded to the bucket): the Huffman engine serves only a group
    whose tiles are all grid-exact, as in JAX; bytes equal."""
    port, jax = _pair(jpeg_engine=engine)
    tiles = _cells(2, 2, 256, 256, seed=3)
    jobs = [(t, _settings(2), True) for t in tiles]
    got = _serve(port, jobs, f32=False)
    want = _serve(jax, jobs, f32=True)
    assert got == want
    port, jax = _pair(jpeg_engine=engine)
    ragged = [(_cells(1, 2, 24, 40, seed=4)[0], _settings(2), True)]
    assert _serve(port, ragged, f32=False) == _serve(jax, ragged, f32=True)


def test_huffman_pixels_match_sparse_pixels():
    from PIL import Image

    tiles = _cells(2, 2, 256, 256, seed=3)
    jobs = [(t, _settings(2), True) for t in tiles]
    sparse = _serve(MeshRenderer(M.make_mesh(device="cpu"), linger_ms=0.0),
                    jobs, f32=False)
    renderer = MeshRenderer(M.make_mesh(device="cpu"), linger_ms=0.0,
                            jpeg_engine="huffman")
    wires = []
    huffman_wire = renderer._huffman_wire

    def spied(*args):
        out = huffman_wire(*args)
        wires.append(out[0])
        return out
    renderer._huffman_wire = spied
    huff = _serve(renderer, jobs, f32=False)
    # The Huffman wire coded both tiles within its budgets.
    assert len(wires) == 1 and all(P.row_header_i32(r, 0) > 0
                                   for r in wires[0])
    for a, b in zip(sparse, huff):
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(a)).convert("RGB")),
            np.asarray(Image.open(io.BytesIO(b)).convert("RGB")))


B, C, H, W = 8, 4, 64, 64


def _overflow_raw():
    """The JAX test's content: totals in (cap, 2 cap] for every tile
    (band=10 noise columns over a flat background, seed 7)."""
    rng = np.random.default_rng(7)
    flat = np.full((C, H, W), 20000, np.float32)
    out = []
    for _ in range(B):
        raw = flat.copy()
        raw[:, :, :10] = rng.uniform(0, 60000, (C, H, 10)).astype(
            np.float32)
        out.append(raw)
    return out


def _spy(cls, launches):
    orig = cls._jpeg_step

    def spy(self, quality, cap, engine_="sparse", cap_words=None):
        step = orig(self, quality, cap, engine_, cap_words)

        def wrapped(*args):
            launches.append((engine_, quality, cap, cap_words))
            return step(*args)
        return wrapped
    return orig, spy


@pytest.mark.parametrize("engine", ["huffman", "sparse"])
def test_overflow_rescue_launch_sequence_matches_jax(engine):
    settings = pack_settings(jax_flagship(C))
    raws = _overflow_raw()

    def port_group():
        return [_Pending(r, settings, H, W, (H, W), quality=85)
                for r in raws]

    def jax_group():
        return [JaxPending(raw=r, settings=settings, h=H, w=W, quality=85)
                for r in raws]

    results = {}
    for cls, renderer, group in (
            (MeshRenderer, MeshRenderer(M.make_mesh(device="cpu"),
                                        jpeg_engine=engine), port_group),
            (JaxMeshRenderer, JaxMeshRenderer(jax_mesh(8, chan_parallel=2),
                                              jpeg_engine=engine),
             jax_group)):
        # Groups called directly: no waiter to settle early.
        renderer.first_tile_out = False
        launches = []
        orig, spy = _spy(cls, launches)
        cls._jpeg_step = spy
        try:
            jpegs = [renderer._render_group_jpeg(group()) for _ in range(2)]
        finally:
            cls._jpeg_step = orig
        results[cls] = launches, jpegs
        run(renderer.close())
    base_cap = P.default_sparse_cap(H, W, 85)
    words = P.default_words_cap(H, W, 85) if engine == "huffman" else None
    want = [(engine, 85, base_cap, words),
            (engine, 85, 2 * base_cap, words and 2 * words),
            (engine, 85, 2 * base_cap, words and 2 * words)]
    port_launches, port_jpegs = results[MeshRenderer]
    assert port_launches == results[JaxMeshRenderer][0] == want
    assert port_jpegs[0] == port_jpegs[1] == results[JaxMeshRenderer][1][0]
    # The port's default route (K1 -> K3 -> wire) gives the same bytes.
    args = R.batched_settings(R.settings_to_tensors(settings, "cpu"), B)
    plain = P.render_batch_to_jpeg(
        torch.from_numpy(np.stack(raws)), *args, quality=85,
        dims=[(W, H)] * B, engine=engine, tune=False)
    assert plain == port_jpegs[0]


@pytest.mark.parametrize("engine", ["huffman", "sparse"])
def test_dense_fallback_matches_jax(engine):
    """A noise tile past twice the cap beside a flat one: coded from its
    dense coefficients (K12a, K12b and K3 on the leader's device)."""
    rng = np.random.default_rng(9)
    settings = pack_settings(jax_flagship(C))
    raws = [rng.uniform(0, 60000, (C, H, W)).astype(np.float32),
            np.full((C, H, W), 20000, np.float32)]
    port = MeshRenderer(M.make_mesh(device="cpu"), jpeg_engine=engine)
    port.first_tile_out = False
    jax = JaxMeshRenderer(jax_mesh(8, chan_parallel=2), jpeg_engine=engine)
    jax.first_tile_out = False
    got = port._render_group_jpeg(
        [_Pending(r, settings, H, W, (H, W), quality=85) for r in raws])
    want = jax._render_group_jpeg(
        [JaxPending(raw=r, settings=settings, h=H, w=W, quality=85)
         for r in raws])
    assert got == want
    run(port.close())
    run(jax.close())


def _app_bodies(make, queries):
    from aiohttp.test_utils import TestClient, TestServer

    async def go():
        out = []
        async with TestClient(TestServer(make())) as client:
            for q in queries:
                r = await client.get(
                    f"/webgateway/render_image_region/{IMG}/0/0?{q}")
                out.append((r.status, await r.read()))
        return out
    return asyncio.run(go())


@pytest.mark.parametrize("engine", ["sparse", "huffman"])
def test_both_apps_serve_the_same_bytes(tmp_path, engine):
    root = write_tree(str(tmp_path))
    queries = [f"tile=0,0,0,256,256&{CH}&format=jpeg",
               f"tile=0,1,0,128,128&{CH}&format=jpeg&q=0.9",
               f"region=5,7,100,90&{CH}&format=jpeg",
               f"tile=0,0,1,128,128&{CH}&format=png"]
    base = {"data-dir": root,
            "renderer": {"cpu-fallback-max-px": 0, "jpeg-engine": engine}}
    jax_cfg = JaxConfig.from_dict(dict(base, parallel={
        "enabled": True, "chan-parallel": 2, "n-devices": 8}))
    port_cfg = AppConfig.from_dict(dict(base, parallel={"enabled": True}))
    want = _app_bodies(lambda: jax_app(jax_cfg), queries)
    got = _app_bodies(lambda: create_app(port_cfg, "cpu"), queries)
    assert [s for s, _ in got] == [200] * len(queries)
    assert got == want


def test_the_mesh_app_serves_through_a_mesh_renderer(tmp_path):
    from omero_ms_image_region_tpu_torch.server.app import build_services

    root = write_tree(str(tmp_path))
    services = build_services(AppConfig.from_dict(
        {"data-dir": root, "parallel": {"enabled": True},
         "renderer": {"prewarm": ["2x256"]}}), "cpu")
    renderer = services.renderer
    assert isinstance(renderer, MeshRenderer)
    assert renderer.mesh.shape == {"data": 1, "chan": 1}
    assert renderer.device == torch.device("cpu")
    run(renderer.close())


@pytest.mark.parametrize("raw, message", [
    ({"parallel": {"chan-parallel": 0}},
     "parallel.chan-parallel must be >= 1"),
    ({"parallel": {"coordinator-address": "h:1"}},
     "parallel.coordinator-address requires num-processes"),
    ({"parallel": {"enabled": True}, "batcher": {"enabled": False},
      "renderer": {"jpeg-engine": "bitpack"}},
     "renderer.jpeg-engine 'bitpack' is only supported"),
    ({"parallel": {"enabled": True, "num-processes": 2},
      "fault-injection": {"seed": 3}},
     "fault-injection.seed cannot be combined"),
])
def test_config_errors_match_jax(raw, message):
    for cls in (JaxConfig, AppConfig):
        with pytest.raises(ValueError, match=message):
            cls.from_dict(raw)
    ok = AppConfig.from_dict({"parallel": {
        "enabled": True, "chan-parallel": 2, "n-devices": 2,
        "coordinator-address": "h:1", "num-processes": 2,
        "process-id": 1}}).parallel
    assert (ok.chan_parallel, ok.n_devices, ok.num_processes,
            ok.process_id) == (2, 2, 2, 1)


def test_a_mesh_wider_than_the_world_is_refused(tmp_path):
    from omero_ms_image_region_tpu_torch.server.app import build_services

    config = AppConfig.from_dict({"data-dir": str(tmp_path), "parallel": {
        "enabled": True, "n-devices": 2}})
    with pytest.raises(ValueError, match="only 1 device.*one --role "
                                         "pod-worker per extra GPU"):
        build_services(config, "cpu")
    config = AppConfig.from_dict({"data-dir": str(tmp_path), "parallel": {
        "enabled": True, "chan-parallel": 2}})
    with pytest.raises(ValueError, match="not divisible by "
                                         "chan_parallel=2"):
        build_services(config, "cpu")


def test_a_cuda_mesh_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        M.make_mesh(device="cuda")


def _stub_groups(renderer, started, release):
    """Groups that park on ``release`` (an asyncio.Event), recording
    their sizes and keys in ``started``."""
    async def run_group(render, group, slots, key):
        started.append((key, len(group)))
        try:
            await release.wait()
            for p in group:
                p.future.set_result(None)
        finally:
            slots.release()
    renderer._run_group = run_group


def test_lockstep_hooks():
    """Growth off keeps max_batch; one shared slot runs one group at a
    time across two keys; with the deadline drop off an expired request
    is still rendered."""
    async def go():
        r = BatchingRenderer("cpu", max_batch=2, linger_ms=0.0,
                             max_batch_limit=8, target_inflight=4)
        r._growth_enabled = False
        r._shared_slots = asyncio.Semaphore(1)
        r._deadline_drop_enabled = False
        started, release = [], asyncio.Event()
        _stub_groups(r, started, release)
        s = _settings(2)
        tiles = _tiles(2, 2, 16, 16, 1) + _tiles(1, 3, 16, 16, 2)
        waits = [asyncio.ensure_future(r.render(tiles[0], s))
                 for _ in range(9)]
        waits.append(asyncio.ensure_future(
            r.render(tiles[2], _settings(3))))
        for _ in range(20):
            await asyncio.sleep(0)
        one_at_a_time = len(started)
        release.set()
        await asyncio.gather(*waits)
        # A request whose budget is spent is dispatched all the same.
        from omero_ms_image_region_tpu_torch.utils import transient
        with transient.deadline_scope(time.monotonic() - 1.0):
            late = await r.render(tiles[1], s)
        await r.close()
        return r, one_at_a_time, started, late
    r, one_at_a_time, started, late = run(go())
    assert one_at_a_time == 1
    assert r.max_batch == 2 and max(n for _, n in started) == 2
    assert sum(n for _, n in started) == 11 and late is None
