"""The port's mesh steps (``parallel.mesh``) and K12's plain versions
against the JAX package's mesh (``parallel/mesh.py``) on its 8-device
virtual CPU mesh (``tests/conftest.py``).

* The partial: ``ops.render.composite_partial_plain`` against
  ``_local_render_batched`` and ``_local_render`` (ramp and LUT, per-tile
  windows, reverse, every family): exact for the linear family; for the
  curved families the quantized values may differ by 1 (pow/log/exp differ
  by an ulp between PyTorch and XLA), so the partial by at most one step
  of a channel's weight or table.
* The render step: every position of a (data, chan) mesh computed in one
  process (its shard by ``shard_batch(_batched)``, K12a's plain version on
  it, the row's partials packed in shard order by K12b's) against JAX
  ``render_step_sharded(_batched)`` on ``make_mesh(n, chan)`` for (n, chan)
  in {(2, 2), (4, 4), (4, 1)}: packed u32 equal.  The collectives
  themselves run in ``tests/test_torch_pod.py``.
* The JPEG step: the port's wire rows (K3, then K4a or K5 with the fixed
  tables) against ``render_jpeg_step_sharded(_batched)``'s, and the JFIF
  bytes of both, byte for byte.
* The chan-1 step, through the step functions themselves: against JAX
  ``render_step_sharded(_batched)`` on ``make_mesh(2, chan_parallel=1)``
  for every family with ramp weights and tables (exact for linear; a
  curved family's bytes within one step of the largest channel
  contribution, rounded up), its route (``render_tile_batch_packed``, K1 or
  K2, and no K12 dispatcher, where a chan-2 position calls both), and the
  ``MeshRenderer``'s dense coefficients against JAX's for the same tile.
"""

import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu.flagship import flagship_rdef as jax_flagship
from omero_ms_image_region_tpu.flagship import synthetic_wsi_tiles
from omero_ms_image_region_tpu.models.rendering import Family as JaxFamily
from omero_ms_image_region_tpu.ops import jpegenc as J
from omero_ms_image_region_tpu.ops.render import (
    build_channel_tables, pack_settings)
from omero_ms_image_region_tpu.parallel import mesh as jax_mesh
from omero_ms_image_region_tpu.parallel.serve import (
    MeshRenderer as JaxMeshRenderer)
from omero_ms_image_region_tpu_torch.kernels import mesh as kernels
from omero_ms_image_region_tpu_torch.ops import jpegenc as P
from omero_ms_image_region_tpu_torch.ops import render as R
from omero_ms_image_region_tpu_torch.parallel import mesh as M
from omero_ms_image_region_tpu_torch.parallel.serve import MeshRenderer

SETTINGS = ("window_start", "window_end", "family", "coefficient",
            "reverse")
FAMILIES = ("linear", "polynomial", "logarithmic", "exponential")
COEFFICIENTS = {"linear": 1.0, "polynomial": 0.7, "logarithmic": 1.0,
                "exponential": 0.35}


def _settings(C, b=0, family="linear", lut=False, reverse=(1,)):
    """Packed settings (numpy) of tile ``b``: the flagship colours, a
    window of its own, ``family`` and reversed channels; ``lut`` gives
    the full [C, 256, 3] tables."""
    rdef = jax_flagship(C)
    for i, cb in enumerate(rdef.channel_bindings):
        cb.input_start = 150.0 * b + 40.0 * i
        cb.input_end = 30000.0 + 7000.0 * b - 900.0 * i
        cb.family = JaxFamily(family)
        cb.coefficient = COEFFICIENTS[family]
        cb.reverse_intensity = i in reverse
    s = pack_settings(rdef)
    if lut:
        s = dict(s, tables=build_channel_tables(rdef))
    return s


def _stacked(settings):
    out = {k: np.stack([s[k] for s in settings])
           for k in SETTINGS + ("tables",)}
    out["cd_start"] = int(settings[0]["cd_start"])
    out["cd_end"] = int(settings[0]["cd_end"])
    return out


def _raw(B, C, H=32, W=48, seed=0):
    return np.random.default_rng(seed).integers(
        0, 65535, (B, C, H, W)).astype(np.uint16)


def _port_args(raw, stacked):
    return (torch.from_numpy(raw.view(np.int16)).view(torch.uint16),
            *(torch.from_numpy(stacked[k]) for k in SETTINGS),
            stacked["cd_start"], stacked["cd_end"],
            torch.from_numpy(stacked["tables"]))


def _jax_partial(raw, stacked, c0, c1):
    part = slice(c0, c1)
    return np.asarray(jax_mesh._local_render_batched(
        raw[:, part].astype(np.float32),
        *(stacked[k][:, part] for k in SETTINGS), stacked["cd_start"],
        stacked["cd_end"], stacked["tables"][:, part]))


def _step_tolerance(stacked, family):
    """0 for the linear family; else one quantized step of the largest
    channel contribution (a ramp weight or a table entry difference)."""
    if family == "linear":
        return 0.0
    t = stacked["tables"]
    if t.ndim == 3:
        return float(np.abs(t).max())
    return float(np.abs(np.diff(t, axis=2)).max())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("lut", [False, True], ids=["ramp", "lut"])
def test_partial_matches_jax_local_render_batched(family, lut):
    B, C = 3, 4
    stacked = _stacked([_settings(C, b, family, lut) for b in range(B)])
    raw = _raw(B, C, seed=1)
    tol = _step_tolerance(stacked, family)
    for c0, c1 in ((0, C), (0, 2), (2, 4), (1, 3)):
        got = R.composite_partial_plain(*_port_args(raw, stacked), c0=c0,
                                        c1=c1).numpy()
        want = _jax_partial(raw, stacked, c0, c1)
        assert got.shape == want.shape == (3, B, 32, 48)
        assert np.abs(got - want).max() <= tol, (c0, c1)
        if family == "linear":
            assert np.array_equal(got, want)


@pytest.mark.parametrize("lut", [False, True], ids=["ramp", "lut"])
def test_partial_matches_jax_local_render_shared(lut):
    """``_local_render``: one setting vector for the batch, [C, ...]
    tables; the port repeats it over the tiles (the steps' form)."""
    B, C = 2, 4
    s = _settings(C, 0, "linear", lut)
    raw = _raw(B, C, seed=2)
    want = np.asarray(jax_mesh._local_render(
        raw.astype(np.float32), *(s[k] for k in SETTINGS), s["cd_start"],
        s["cd_end"], s["tables"]))
    got = R.composite_partial_plain(*_port_args(raw, _stacked([s] * B)))
    assert np.array_equal(got.numpy(), want)


def test_pack_sums_in_shard_order():
    """K12b's plain version: the shards summed s = 0, 1, ... (each add
    rounded), then round half to even, clip, pack; with one shard the
    partial alone; and the whole chain equal to K1's plain render."""
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.uniform(-20, 280, (3, 3, 2, 8, 8))
                             .astype(np.float32))
    acc = parts[0] + parts[1] + parts[2]
    want = (torch.clamp(torch.round(acc), 0, 255).to(torch.int32)
            * torch.tensor([1, 256, 65536]).view(3, 1, 1, 1)).sum(0)
    got = R.composite_pack_plain(parts)
    assert torch.equal(got & 0xFFFFFF, want)
    assert bool(((got >> 24) & 0xFF == 0xFF).all())
    B, C = 2, 3
    stacked = _stacked([_settings(C, b, "polynomial") for b in range(B)])
    args = _port_args(_raw(B, C, seed=4), stacked)
    assert torch.equal(R.composite_pack(R.composite_partial(*args)[None]),
                       R.render_tile_batch_packed_plain(*args))


def test_kernel_wrappers_refuse_cpu_tensors():
    B, C = 1, 2
    args = _port_args(_raw(B, C), _stacked([_settings(C)]))
    with pytest.raises(ValueError, match="composite_partial_plain"):
        kernels.composite_partial(*args)
    with pytest.raises(ValueError, match="composite_pack_plain"):
        kernels.composite_pack(torch.zeros((1, 3, 1, 4, 4)))


def _positions(data, chan):
    """One standalone ``Mesh`` for each position of a (data, chan) grid,
    row by row: its shard's slices, with no collective."""
    grid = np.arange(data * chan).reshape(data, chan)
    return [[M.Mesh(grid, torch.device("cpu"), int(grid[d, c]),
                    collective=False) for c in range(chan)]
            for d in range(data)]


def _port_mesh_packed(raw, settings, data, chan, batched):
    """The port's render step at every position of a (data, chan) mesh,
    in one process: each row's partials packed in shard order, the rows
    concatenated."""
    rows = []
    for row in _positions(data, chan):
        partials = []
        for pos in row:
            if batched:
                args = M.shard_batch_batched(pos, raw, settings)
            else:
                shard = M.shard_batch(pos, raw, settings)
                args = (shard[0],) + M._shared_to_batched(shard[0],
                                                           shard[1:])
            partials.append(R.composite_partial(*args))
        rows.append(R.composite_pack(torch.stack(partials)))
    return torch.cat(rows).numpy().view(np.uint32)


@pytest.mark.parametrize("n, chan", [(2, 2), (4, 4), (4, 1)])
@pytest.mark.parametrize("batched", [False, True],
                         ids=["shared", "per_tile"])
def test_render_step_matches_jax_mesh(n, chan, batched):
    data = n // chan
    C = max(chan, 4)
    B = data * 2
    raw = _raw(B, C, seed=n + chan)
    mesh = jax_mesh.make_mesh(n, chan_parallel=chan)
    if batched:
        settings = _stacked([_settings(C, b) for b in range(B)])
        want = jax_mesh.render_step_sharded_batched(mesh)(
            *jax_mesh.shard_batch_batched(mesh, raw.astype(np.float32),
                                          settings))
    else:
        settings = _settings(C)
        want = jax_mesh.render_step_sharded(mesh)(
            *jax_mesh.shard_batch(mesh, raw.astype(np.float32), settings))
    got = _port_mesh_packed(raw, settings, data, chan, batched)
    assert np.array_equal(got, np.asarray(want))


def _port_mesh_wire(raw, stacked, data, chan, quality, engine, cap,
                    cap_words):
    """The port's JPEG wire rows of every position's tiles (a row's
    positions all hold the same packed rows after the pack)."""
    packed = torch.from_numpy(
        _port_mesh_packed(raw, stacked, data, chan, True).view(np.int32))
    standalone = _positions(1, 1)[0][0]
    return M._jpeg_wire(standalone, packed, quality, cap, engine,
                        cap_words, False).numpy()


@pytest.mark.parametrize("engine", ["sparse", "huffman"])
def test_jpeg_step_matches_jax_mesh(engine):
    """Wire rows and JFIF bytes of the per-tile-settings JPEG step on
    make_mesh(8, 2), 4 tiles of 32x48 at q 85."""
    B, C, H, W, q = 4, 4, 32, 48, 85
    raw = synthetic_wsi_tiles(np.random.default_rng(5), B, C, H, W)
    stacked = _stacked([_settings(C, b) for b in range(B)])
    # Budgets every tile fits: the rescue and the dense route are the
    # MeshRenderer's (tests/test_torch_mesh_serve.py).
    cap = J.max_sparse_cap(H, W)
    cap_words = H * W // 4
    mesh = jax_mesh.make_mesh(8, chan_parallel=2)
    want = np.asarray(jax_mesh.render_jpeg_step_sharded_batched(
        mesh, q, cap=cap, engine=engine, cap_words=cap_words)(
        *jax_mesh.shard_batch_batched(mesh, raw.astype(np.float32),
                                      stacked)))
    got = _port_mesh_wire(raw, stacked, 4, 2, q, engine, cap, cap_words)
    assert got.shape == want.shape
    dims = [(W, H)] * B
    rows = [np.ascontiguousarray(r) for r in got]
    if engine == "sparse":
        assert np.array_equal(got, want)
        port_jpegs = P.finish_sparse_to_jpegs(rows, dims, H, W, q, cap,
                                              None)
        jax_jpegs = J.encode_sparse_buffers(want, W, H, q, cap)
    else:
        for g, w in zip(got, want):
            bits = P.row_header_i32(g, 1)
            assert P.row_header_i32(g, 0) == P.row_header_i32(w, 0) <= cap
            assert bits == P.row_header_i32(w, 1) <= 32 * cap_words
            used = 8 + 4 * ((bits + 31) // 32)
            assert np.array_equal(g[:used], w[:used])
        port_jpegs = P.finish_huffman_batch(rows, dims, H, W, q, cap,
                                            cap_words)
        jax_jpegs = J.finish_huffman_batch(list(want), dims, H, W, q, cap,
                                           cap_words)
    assert port_jpegs == list(jax_jpegs)


def test_shared_settings_jpeg_step_matches_jax_mesh():
    """``render_jpeg_step_sharded`` (settings shared by the batch, sparse
    wire) on make_mesh(8, 2), and on the port's (1, 1) mesh through the
    step function itself."""
    B, C, H, W, q = 4, 4, 32, 32, 80
    raw = _raw(B, C, H, W, seed=6)
    s = _settings(C)
    cap = J.max_sparse_cap(H, W)
    mesh = jax_mesh.make_mesh(8, chan_parallel=2)
    want = np.asarray(jax_mesh.render_jpeg_step_sharded(mesh, q, cap=cap)(
        *jax_mesh.shard_batch(mesh, raw.astype(np.float32), s)))
    port_mesh = M.make_mesh(device="cpu")
    got = M.render_jpeg_step_sharded(port_mesh, q, cap=cap)(
        *M.shard_batch(port_mesh, raw, s)).numpy()
    assert np.array_equal(got, want)
    packed = M.render_step_sharded(port_mesh)(
        *M.shard_batch(port_mesh, raw, s))
    assert np.array_equal(
        packed.numpy().view(np.uint32),
        np.asarray(jax_mesh.render_step_sharded(mesh)(
            *jax_mesh.shard_batch(mesh, raw.astype(np.float32), s))))


def test_mesh_shape_and_errors():
    mesh = M.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "chan": 1} and mesh.size == 1
    assert mesh.axis_names == ("data", "chan")
    assert mesh.rows(5) == slice(0, 5) and mesh.channels(3) == slice(0, 3)
    assert mesh.chan_group is None and mesh.data_group is None
    with pytest.raises(ValueError, match="not divisible by chan"):
        _positions(1, 2)[0][1].channels(3)
    with pytest.raises(ValueError, match="not divisible by data"):
        _positions(2, 1)[1][0].rows(3)
    # JAX's errors: an indivisible mesh, and one wider than the devices
    # (here the world size, with the pod-worker advice).
    with pytest.raises(ValueError, match="not divisible"):
        M.make_mesh(7, chan_parallel=2, devices=list(range(8)),
                    device="cpu")
    with pytest.raises(ValueError, match="only 1 device.*pod-worker"):
        M.make_mesh(4096, device="cpu")


def _count_routes(monkeypatch):
    """Count the calls of ``ops.render``'s three step dispatchers."""
    calls = {"render_tile_batch_packed": 0, "composite_partial": 0,
             "composite_pack": 0}
    for name in calls:
        real = getattr(R, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(R, name, counted)
    return calls


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("lut", [False, True], ids=["ramp", "lut"])
def test_chan1_step_renders_whole_and_matches_jax(monkeypatch, family, lut):
    """The chan-1 steps (per-tile and shared settings) at each position of
    a (2, 1) mesh against JAX's on make_mesh(2, chan_parallel=1); the
    step calls K1/K2's dispatcher and no K12 one, a chan-2 position both
    K12 dispatchers."""
    B, C = 4, 4
    raw = _raw(B, C, seed=7)
    stacked = _stacked([_settings(C, b, family, lut) for b in range(B)])
    shared = _settings(C, 1, family, lut)
    byte_tol = int(np.ceil(_step_tolerance(stacked, family)))
    mesh = jax_mesh.make_mesh(2, chan_parallel=1)
    want_batched = np.asarray(jax_mesh.render_step_sharded_batched(mesh)(
        *jax_mesh.shard_batch_batched(mesh, raw.astype(np.float32),
                                      stacked)))
    want_shared = np.asarray(jax_mesh.render_step_sharded(mesh)(
        *jax_mesh.shard_batch(mesh, raw.astype(np.float32), shared)))
    calls = _count_routes(monkeypatch)
    rows = [(M.render_step_sharded_batched(pos)(
                 *M.shard_batch_batched(pos, raw, stacked)),
             M.render_step_sharded(pos)(*M.shard_batch(pos, raw, shared)))
            for (pos,) in _positions(2, 1)]
    assert calls == {"render_tile_batch_packed": 4, "composite_partial": 0,
                     "composite_pack": 0}
    for got, want in ((torch.cat([r[0] for r in rows]), want_batched),
                      (torch.cat([r[1] for r in rows]), want_shared)):
        got = got.numpy().view(np.uint32)
        assert got.shape == want.shape == (B, 32, 48)
        diff = np.abs(R.unpack_rgba(got).astype(np.int16)
                      - R.unpack_rgba(want).astype(np.int16))
        assert diff.max() <= byte_tol
        if family == "linear":
            assert np.array_equal(got, want)
    pos = _positions(1, 2)[0][0]
    M.render_step_sharded_batched(pos)(*M.shard_batch_batched(pos, raw,
                                                              stacked))
    assert calls == {"render_tile_batch_packed": 4, "composite_partial": 1,
                     "composite_pack": 1}


@pytest.mark.parametrize("lut", [False, True], ids=["ramp", "lut"])
def test_dense_coefficients_at_chan1_match_jax(monkeypatch, lut):
    """The overflow fallback's one-tile dense coefficients on the port's
    (1, 1) mesh (K1/K2 then K3, no partial) against the JAX
    MeshRenderer's for the same tile, q 85."""
    B, C, q = 3, 4, 85
    raw = _raw(B, C, seed=8)
    stacked = _stacked([_settings(C, b, "linear", lut) for b in range(B)])
    port = MeshRenderer(M.make_mesh(device="cpu"))
    calls = _count_routes(monkeypatch)
    got = port._dense_coefficients(raw, stacked, q, 1)
    assert calls == {"render_tile_batch_packed": 1, "composite_partial": 0,
                     "composite_pack": 0}
    qy, qc = (np.asarray(t, np.int32) for t in J.quant_tables(q))
    want = JaxMeshRenderer._dense_coefficients(raw.astype(np.float32),
                                               stacked, qy, qc, 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w)
