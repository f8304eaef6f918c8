"""The port's Huffman wire engine against the JAX package's.

* ``ops.jpegenc.huffman_pack_plain`` (K5's plain version) against the JAX
  ``huffman_pack`` on coefficients of rendered content at q 85 and 92
  with the fixed and a tuned spec, an all-zero tile, runs of 16, 32 and 48
  zeros (folded ZRL codes), a DC difference of category 11, and the two
  overflows: the header and the used words are equal on every row within
  its budgets; on a row over ``cap`` entries ``total`` and the overflow
  decision are (JAX drops the entries past ``cap``, so its bit count is
  of a cut stream).
* ``jfif``: the fixed spec, ``tuned_huffman_spec(*symbol_frequencies())``
  and the stream framing equal to JAX's.
* ``render_batch_to_jpeg(engine="huffman")`` gives JAX's bytes with the
  fixed tables and with the same tuned tables published in both packages,
  and on a batch that takes the doubled-budget retry and the dense coder.
* ``AdaptiveEngine`` fed one sequence of fetches and probes flips as
  JAX's does; the batcher asks its controller once a group.
* Both default apps from one config dict with ``jpeg-engine: huffman``
  answer with the same status, bytes and headers, the device route
  (Huffman on an exact bucket, sparse on a smaller tile) and the host path
  of tiles of at most 256².

K5 itself is held to its plain version by ``chip_smoke.py`` on the card.
Only ``test_tuning_publishes_the_workload_tables`` runs the tuning
thread; every other test passes ``tune=False`` or publishes the tables it
wants in both packages first, and each test starts once no tuning thread
is pending.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from omero_ms_image_region_tpu import jfif as jax_jfif
from omero_ms_image_region_tpu.flagship import (
    batched_args as jax_batched_args, flagship_settings as jax_flagship,
    synthetic_wsi_tiles)
from omero_ms_image_region_tpu.ops import jpegenc as J
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import adaptive as jax_adaptive
from omero_ms_image_region_tpu_torch import jfif
from omero_ms_image_region_tpu_torch.flagship import flagship_rdef
from omero_ms_image_region_tpu_torch.ops import jpegenc as P
from omero_ms_image_region_tpu_torch.ops import render as port_render
from omero_ms_image_region_tpu_torch.server.batcher import BatchingRenderer
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.utils import adaptive

from torch_workload_apps import CH, IMG, exchange, write_tree

B, H, W = 3, 64, 64
H16, W16 = H // 16, W // 16
_jax_pack = jax.jit(J.huffman_pack,
                    static_argnames=("cap", "cap_words", "h16", "w16"))


def _reset(mod):
    """Clear a package's cap memo and tuned tables, once no tuning
    thread is left to publish into them."""
    for _ in range(1000):
        if not mod._TUNED_PENDING:
            break
        time.sleep(0.01)
    mod._CAP_MEMO.clear()
    mod._TUNED_TABLES.clear()


@pytest.fixture(autouse=True)
def _clean_state():
    """No cap memo and no tuned table leaks between tests."""
    for mod in (J, P):
        _reset(mod)
    yield
    for mod in (J, P):
        _reset(mod)


def _rendered_coefficients(q: int, seed: int = 3):
    """(y, cb, cr) numpy of B rendered 64² tiles, from the JAX pipeline."""
    _, settings = jax_flagship(2)
    raw = (synthetic_wsi_tiles(np.random.default_rng(seed), B, 2, H, W)
           .astype(np.float32) / 8.0 + 15000.0)
    qy, qc = (t.astype(np.int32) for t in J.quant_tables(q))
    args = jax_batched_args(settings, raw)
    return tuple(np.array(a) for a in J.render_to_jpeg_coefficients(
        *args, qy, qc))


def _crafted(kind: str):
    """Hand-made coefficients: all zero, long zero runs, or a DC
    difference of category 11."""
    y = np.zeros((B, 4 * H16 * W16, 64), np.int16)
    cb = np.zeros((B, H16 * W16, 64), np.int16)
    cr = np.zeros_like(cb)
    if kind == "zero_runs":
        # Runs of 16, 32 and 48 zeros before a nonzero: 1, 2 and 3 ZRL
        # codes folded into one field; and a block ending on position 63.
        y[:, 0, [17, 50]] = [5, -3]        # run 16, then run 32
        y[:, 1, [49, 63]] = [-7, 2]        # run 48, then none, no EOB
        cb[:, 2, [1, 18, 51]] = [1, -1, 4]
        cr[:, 0, 63] = 9                   # run 62: three ZRLs and 14
        y[:, :, 0] = np.arange(y.shape[1]) % 7 - 3
    elif kind == "dc_category_11":
        y[:, ::2, 0] = 1000
        y[:, 1::2, 0] = -1000              # differences of 2000
        cb[:, :, 0] = np.where(np.arange(cb.shape[1]) % 2, 1020, -1020)
        y[:, :, 5] = 1
    return y, cb, cr


def _case(name: str):
    """(coefficients, jfif spec, cap, cap_words) of a named case."""
    cap, cap_words = P.max_sparse_cap(H, W), P.default_words_cap(H, W, 92)
    if name.startswith("q"):
        q, tuned = int(name[1:3]), name.endswith("tuned")
        c = _rendered_coefficients(q)
        spec = (jax_jfif.tuned_huffman_spec(
            *jax_jfif.symbol_frequencies(*(a[0] for a in c)))
            if tuned else jax_jfif.fixed_huffman_spec())
        return c, spec, cap, cap_words
    if name == "entry_overflow":
        return _rendered_coefficients(85), jax_jfif.fixed_huffman_spec(), \
            40, cap_words
    if name == "bit_overflow":
        return _rendered_coefficients(92), jax_jfif.fixed_huffman_spec(), \
            cap, 24
    return _crafted(name), jax_jfif.fixed_huffman_spec(), cap, cap_words


CASES = ["q85_fixed", "q92_fixed", "q85_tuned", "q92_tuned", "all_zero",
         "zero_runs", "dc_category_11", "entry_overflow", "bit_overflow"]


@pytest.mark.parametrize("name", CASES)
def test_huffman_pack_plain_matches_jax(name):
    (y, cb, cr), spec8, cap, cap_words = _case(name)
    want = np.asarray(_jax_pack(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), cap=cap,
        cap_words=cap_words, h16=H16, w16=W16,
        **dict(zip(("dc_code", "dc_len", "ac_code", "ac_len"),
                   J.spec_kernel_arrays(spec8)))))
    got = P.huffman_pack_plain(
        torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr),
        cap_words, P.spec_tensor(P.spec_kernel_arrays(spec8), "cpu"),
        H16, W16).numpy()
    assert got.shape == want.shape == (B, 8 + 4 * cap_words)
    decisions = []
    for g, w in zip(got, want):
        total, bits = P.row_header_i32(g, 0), P.row_header_i32(g, 1)
        assert total == P.row_header_i32(w, 0)
        over = total > cap or bits > 32 * cap_words
        decisions.append(over)
        assert over == (P.row_header_i32(w, 0) > cap
                        or P.row_header_i32(w, 1) > 32 * cap_words)
        if total <= cap:
            assert bits == P.row_header_i32(w, 1)
        if not over:
            used = 8 + 4 * ((bits + 31) // 32)
            assert np.array_equal(g[:used], w[:used])
    if name == "entry_overflow":
        assert all(decisions)
    elif name == "bit_overflow":
        assert any(decisions)
    else:
        assert not any(decisions)


def test_huffman_row_lengths_and_compaction_match_jax():
    """K4b's Huffman lengths (:486-492): used words of in-budget rows, the
    header alone for rows over either budget, nothing past n_valid."""
    (y, cb, cr), spec8, cap, _ = _case("q92_fixed")
    spec = P.spec_tensor(P.spec_kernel_arrays(spec8), "cpu")
    wire = P.huffman_pack_plain(*(torch.from_numpy(a) for a in (y, cb, cr)),
                                600, spec, H16, W16)
    bits = wire[:, 4:8].reshape(-1).view(torch.int32).numpy()
    cw = 600
    for cap_, n_valid in ((cap, 3), (cap, 2), (10, 3)):
        lengths = P.huffman_row_lengths(wire, n_valid, cap_, cw).numpy()
        want = [0 if i >= n_valid else
                (8 + 4 * ((int(bits[i]) + 31) // 32) if cap_ == cap else 8)
                for i in range(B)]
        assert lengths.tolist() == want
        compact = P.compact_huffman_rows(wire, n_valid, cap_, cw)
        assert torch.equal(compact, P.compact_rows_plain(
            wire, torch.tensor(want)))


def test_specs_match_jax():
    (y, cb, cr) = _rendered_coefficients(85)
    for mine, theirs in (
            (jfif.fixed_huffman_spec(), jax_jfif.fixed_huffman_spec()),
            (jfif.tuned_huffman_spec(*jfif.symbol_frequencies(
                y[1], cb[1], cr[1])),
             jax_jfif.tuned_huffman_spec(*jax_jfif.symbol_frequencies(
                 y[1], cb[1], cr[1])))):
        assert len(mine) == len(theirs) == 8
        for a, b in zip(mine, theirs):
            assert np.array_equal(a, b)
    freqs = jfif.symbol_frequencies(y[2], cb[2], cr[2])
    for a, b in zip(freqs, jax_jfif.symbol_frequencies(y[2], cb[2], cr[2])):
        assert np.array_equal(a, b)
    # A sample with no runs at all still keeps the ZRL code <= 10 bits.
    rare = jfif.tuned_huffman_spec(np.full(256, 1000), np.where(
        np.arange(256) == 0xF0, 0, 100000))
    assert int(rare[7][0xF0]) <= 10
    assert P.spec_kernel_arrays(jfif.fixed_huffman_spec())[3][0xF0] <= 10


def test_stream_framing_matches_jax():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2 ** 32, 40, dtype=np.uint64).astype(np.uint32)
    words[3] = 0xFFFFFFFF
    spec = jax_jfif.tuned_huffman_spec(np.arange(256), np.arange(256) % 7)
    for bits in (0, 1, 255, 1271, 1280):
        assert (jfif.finish_fixed_stream(words, bits, 70, 30, 85)
                == jax_jfif.finish_fixed_stream(words, bits, 70, 30, 85))
        assert (jfif.finish_stream_with_spec(words, bits, 64, 64, 92, spec)
                == jax_jfif.finish_stream_with_spec(words, bits, 64, 64, 92,
                                                    spec))


# ------------------------------------------------- render_batch_to_jpeg

def _port_args(raw: np.ndarray, C: int):
    s = port_render.settings_to_tensors(
        port_render.pack_settings(flagship_rdef(C)), "cpu")
    return (port_render.raw_to_tensor(raw, "cpu"),
            *port_render.batched_settings(s, raw.shape[0]))


def _golden_raw():
    return (synthetic_wsi_tiles(np.random.default_rng(42), B, 2, H, W)
            .astype(np.float32) / 8.0 + 15000.0)


@pytest.mark.parametrize("tables", ["fixed", "tuned"])
def test_render_batch_to_jpeg_huffman_matches_jax(tables):
    q = 85
    raw = _golden_raw()
    _, settings = jax_flagship(2)
    if tables == "tuned":
        c = _rendered_coefficients(q, seed=42)
        spec8 = jax_jfif.tuned_huffman_spec(
            *jax_jfif.symbol_frequencies(*(a[0] for a in c)))
        J._TUNED_TABLES[(H, W, q)] = (J.spec_kernel_arrays(spec8), spec8)
        P._TUNED_TABLES[(H, W, q)] = (P.spec_kernel_arrays(spec8), spec8)
    dims = [(W, H)] * B
    want = J.render_batch_to_jpeg(*jax_batched_args(settings, raw),
                                  quality=q, dims=dims, engine="huffman",
                                  tune=False)
    got = P.render_batch_to_jpeg(*_port_args(raw, 2), quality=q, dims=dims,
                                 engine="huffman", tune=False)
    assert got == want
    # The Huffman stream, not the sparse engine's optimal tables.
    assert got != P.render_batch_to_jpeg(*_port_args(raw, 2), quality=q,
                                         dims=dims)
    assert P._CAP_MEMO == J._CAP_MEMO == {}


def test_render_batch_to_jpeg_huffman_retry_and_dense_route():
    """Noise tiles: one within the budgets, one between them and twice
    them (the batch's one retry at doubled budgets, and the memo), one
    past twice them (the dense coder); a grid-exact dims list."""
    C, q = 2, 85
    rng = np.random.default_rng(7)
    raw = np.concatenate([
        15000 + rng.normal(0, amp, (1, C, H, W)) for amp in
        (500, 1000, 4000)]).astype(np.float32)
    _, settings = jax_flagship(C)
    dims = [(W, H)] * 3
    want = J.render_batch_to_jpeg(*jax_batched_args(settings, raw),
                                  quality=q, dims=dims, engine="huffman",
                                  tune=False)
    assert J._CAP_MEMO == {("huffman", H, W, q): True}
    got = P.render_batch_to_jpeg(*_port_args(raw, C), quality=q, dims=dims,
                                 engine="huffman", tune=False)
    assert got == want
    assert P._CAP_MEMO == J._CAP_MEMO
    cw = P.default_words_cap(H, W, q)
    y, cb, cr = P.packed_to_jpeg_coefficients(
        port_render.render_tile_batch_packed(*_port_args(raw, C)), q)
    spec = P.spec_tensor(P.huffman_spec_arrays(), "cpu")
    rows = P.huffman_wire_rows(y, cb, cr, 10 ** 6, 10 ** 6, spec, 3, H16,
                               W16)
    bits = [P.row_header_i32(r, 1) for r in rows]
    assert bits[0] <= 32 * cw < bits[1] <= 64 * cw < bits[2]


def test_a_group_with_an_inexact_tile_takes_the_sparse_engine():
    raw = _golden_raw()
    dims = [(W, H), (W - 20, H - 3), (W, H)]
    assert (P.render_batch_to_jpeg(*_port_args(raw, 2), quality=85,
                                   dims=dims, engine="huffman", tune=False)
            == P.render_batch_to_jpeg(*_port_args(raw, 2), quality=85,
                                      dims=dims))


def test_tuning_publishes_the_workload_tables():
    raw = _golden_raw()
    dims = [(W, H)] * B
    first = P.render_batch_to_jpeg(*_port_args(raw, 2), quality=85,
                                   dims=dims, engine="huffman")
    for _ in range(200):
        if (H, W, 85) in P._TUNED_TABLES:
            break
        time.sleep(0.01)
    arrays, spec8 = P._TUNED_TABLES[(H, W, 85)]
    y, cb, cr = P.packed_to_jpeg_coefficients(
        port_render.render_tile_batch_packed(*_port_args(raw, 2)), 85)
    want = jfif.tuned_huffman_spec(*jfif.symbol_frequencies(
        y[0].numpy(), cb[0].numpy(), cr[0].numpy()))
    assert all(np.array_equal(a, b) for a, b in zip(spec8, want))
    second = P.render_batch_to_jpeg(*_port_args(raw, 2), quality=85,
                                    dims=dims, engine="huffman")
    assert second != first
    assert sum(map(len, second)) < sum(map(len, first))


# ------------------------------------------------- the adaptive engine

def _drive_controller(module):
    """One scripted run: fetches (bytes, seconds, conflated) and engine
    queries on a fake clock and probe; the engine after each step."""
    now = [0.0]
    probes = iter([3.0, 50.0, 4.0, 40.0, 100.0])
    ctl = module.AdaptiveEngine(initial_rate_mb_s=30.0,
                                probe=lambda: next(probes),
                                clock=lambda: now[0])
    steps = [("fetch", 4 << 20, 2.0, False), ("fetch", 100, 0.001, False),
             ("fetch", 4 << 20, 1.0, False), ("ask", 1.0),
             ("fetch", 4 << 20, 0.05, False), ("ask", 25.0), ("ask", 0.0),
             ("fetch", 1 << 20, 1.0, True), ("fetch", 1 << 20, 1.0, True),
             ("fetch", 1 << 20, 1.0, True), ("fetch", 1 << 20, 1.0, True),
             ("fetch", 1 << 20, 1.0, True), ("ask", 1.0), ("ask", 40.0),
             ("fetch", 8 << 20, 0.01, True), ("ask", 1.0)]
    out = []
    for step in steps:
        if step[0] == "fetch":
            ctl.observe_fetch(*step[1:])
        else:
            now[0] += step[1]
            out.append(ctl.current())
        out.append((ctl.engine, round(ctl.rate_mb_s or 0.0, 6),
                    ctl.switches))
    return out


def test_adaptive_engine_flips_as_jax():
    got = _drive_controller(adaptive)
    assert got == _drive_controller(jax_adaptive)
    engines = [step[0] for step in got if isinstance(step, tuple)]
    assert set(engines) == {"sparse", "huffman"}
    assert got[-1][2] >= 2                      # flipped both ways


def test_batcher_asks_its_controller_once_a_group():
    class Controller:
        calls = 0

        def current(self):
            Controller.calls += 1
            return "huffman"

    with pytest.raises(ValueError, match="sparse' or 'huffman"):
        BatchingRenderer("cpu", jpeg_engine="bitpack")
    P._TUNED_TABLES[(256, 256, 85)] = None      # no tuning thread
    renderer = BatchingRenderer("cpu", engine_controller=Controller(),
                                linger_ms=50.0)
    raw = np.random.default_rng(1).integers(
        0, 60000, (2, 256, 256)).astype(np.uint16)
    settings = port_render.pack_settings(flagship_rdef(2))

    async def run():
        try:
            return await asyncio.gather(*(renderer.render_jpeg(
                raw, settings, 85, 256, 256) for _ in range(2)))
        finally:
            await renderer.close()

    a, b = asyncio.run(run())
    assert a == b and a[:2] == b"\xff\xd8"
    assert renderer.group_sizes == {2: 1}
    assert Controller.calls == 1


@pytest.mark.parametrize("engine", ["sparse", "huffman", "auto"])
def test_config_serves_the_jax_engines(engine):
    raw = {"renderer": {"jpeg-engine": engine}}
    assert (AppConfig.from_dict(raw).renderer.jpeg_engine
            == JaxConfig.from_dict(raw).renderer.jpeg_engine == engine)


@pytest.mark.parametrize("batched", [True, False])
def test_auto_engine_opens_from_the_probe(batched):
    """``jpeg-engine: auto``: the startup probe of the (here host) copy
    rate, far above the crossover, opens on sparse; the batched posture
    keeps a live controller fed by the wire fetches, the direct one a
    static choice."""
    from omero_ms_image_region_tpu_torch.server.app import build_services

    raw = {"renderer": {"jpeg-engine": "auto"},
           "batcher": {"enabled": batched}}
    try:
        renderer = build_services(AppConfig.from_dict(raw), "cpu").renderer
        assert renderer.jpeg_engine == "sparse"
        ctl = getattr(renderer, "engine_controller", None)
        assert (ctl is not None) == batched
        if batched:
            assert ctl.rate_mb_s > ctl.crossover
            assert P._FETCH_OBSERVER == ctl.observe_fetch
    finally:
        P.set_fetch_observer(None)


# ------------------------------------------------- the default apps

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("huffman_apps")))


@pytest.mark.parametrize("posture", ["device_route", "host_path"])
def test_default_apps_serve_huffman_alike(tree, posture):
    """``jpeg-engine: huffman`` in both default apps.  The device route:
    a 256² tile (an exact bucket: the Huffman wire) and a 64² one (padded
    into the bucket: the sparse wire); the host path: the same tiles at
    the default ``cpu-fallback-max-px``."""
    raw = {"data-dir": tree, "renderer": {"jpeg-engine": "huffman"}}
    if posture == "device_route":
        raw["renderer"]["cpu-fallback-max-px"] = 0
    for q in (85, 90):
        J._TUNED_TABLES[(256, 256, q)] = None   # the fixed tables only
        P._TUNED_TABLES[(256, 256, q)] = None
    base = f"/webgateway/render_image_region/{IMG}/1/0/"
    # The tree's planes are uniform noise: narrow windows leave a sparse
    # speckle that fits the wire's budgets.
    ch = "c=1|59600:60000$FF0000,2|0:400$00FF00&m=c"
    requests = [("GET", f"{base}?tile=0,0,0,256,256&{ch}&format=jpeg", {}),
                ("GET", f"{base}?tile=0,0,0,256,256&{ch}&format=jpeg&q=0.9",
                 {}),
                ("GET", f"{base}?tile=0,1,1,64,64&{CH}&format=jpeg", {})]
    jax_answers, port_answers = exchange(raw, requests)
    tables = []
    for (js, jh, jb), (ps, ph, pb) in zip(jax_answers, port_answers):
        assert ps == js == 200
        assert pb == jb and pb[:2] == b"\xff\xd8"
        for k in ("ETag", "Cache-Control", "Content-Type",
                  "Last-Modified"):
            assert ph.get(k) == jh.get(k), k
        tables.append(pb[:pb.index(b"\xff\xda")].count(b"\xff\xc4"))
    if posture == "device_route":
        # The Huffman wire's shared tables (2 DHTs) on the exact bucket,
        # the sparse engine's per-tile optimal ones (4) below it.
        assert tables == [2, 2, 4]
