"""The port's bitpack engine (K6) against the JAX package's.

* ``ops.jpegenc.bitpack_fixed_plain`` (K6's plain version) against the JAX
  ``_bitpack_fixed`` (jit on the CPU), words and ``total_bits`` exactly:
  rendered coefficients at 32², 48x64 and 256² with seeds and q 50, 85 and
  95, an all-zero tile, a tile of noise with runs of 48 zeros and more
  (the three ZRL fields) and DC differences past 2048 (the category-11
  clamp), and an overflow at a small cap (the words below the cap equal,
  the whole stream's bits counted); and the inputs that choose between
  the two paths of K6's kernel (chunks of ``kernels.jpeg.BIT_CHUNK_BLOCKS``
  blocks): a clamp below -2047 (whose sign bits JAX adds into the words
  before the field) in one chunk of a tile only, clamps in the first
  block of chunks (their spill reaches the previous chunk's last word),
  tiles whose streams end exactly on a word boundary, and B=3 tiles of
  different stream lengths.
* ``BitpackJpegEncoder`` gives ``TpuJpegEncoder``'s JFIF bytes, and hands
  an overflowing tile to its dense fallback as JAX does.
* Both direct apps (``batcher.enabled: false``) with ``jpeg-engine:
  bitpack`` serve the same bytes for an MCU-aligned tile (K6's stream), a
  tile that is not MCU-aligned (the sparse engine) and flipped tiles.

K6 itself is held to its plain version by ``chip_smoke.py`` on the card.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu.flagship import (
    batched_args as jax_batched_args, flagship_settings as jax_flagship,
    synthetic_wsi_tiles)
from omero_ms_image_region_tpu.jfif import fixed_huffman_spec
from omero_ms_image_region_tpu.ops import jpegenc as J
from omero_ms_image_region_tpu_torch.flagship import flagship_rdef
from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
from omero_ms_image_region_tpu_torch.ops import jpegenc as P
from omero_ms_image_region_tpu_torch.ops import render as port_render

from torch_workload_apps import IMG, exchange, write_tree

_jax_bitpack = jax.jit(jax.vmap(J._bitpack_fixed,
                                in_axes=(0, None, None, None, None, None,
                                         None)),
                       static_argnums=(6,))


def _jax_words(blocks: np.ndarray, H: int, W: int, cap_words: int):
    _, _, dc_code, dc_len, _, _, ac_code, ac_len = fixed_huffman_spec()
    words, bits = _jax_bitpack(
        jnp.asarray(blocks), jnp.asarray(J._mcu_scan_index(H // 16, W // 16)),
        *(jnp.asarray(a.astype(np.int32))
          for a in (dc_code, dc_len, ac_code, ac_len)), cap_words)
    return np.asarray(words).view(np.int32), np.asarray(bits)


def _port_args(raw: np.ndarray, C: int):
    s = port_render.settings_to_tensors(
        port_render.pack_settings(flagship_rdef(C)), "cpu")
    return (port_render.raw_to_tensor(raw, "cpu"),
            *port_render.batched_settings(s, raw.shape[0]))


def _raw(seed: int, B: int, H: int, W: int) -> np.ndarray:
    return (synthetic_wsi_tiles(np.random.default_rng(seed), B, 2, H, W)
            .astype(np.float32) / 8.0 + 15000.0)


def _rendered_blocks(seed: int, H: int, W: int, q: int) -> np.ndarray:
    """[2, nb, 64] coefficient blocks of two rendered tiles (the port's
    plain K1 and K3, which equal JAX's)."""
    packed = port_render.render_tile_batch_packed(*_port_args(
        _raw(seed, 2, H, W), 2))
    y, cb, cr = P.packed_to_jpeg_coefficients(packed, q)
    return torch.cat([t.reshape(2, -1, 64) for t in (y, cb, cr)],
                     dim=1).numpy()


def _crafted(kind: str, H: int, W: int) -> np.ndarray:
    nb = (H // 8) * (W // 8) + 2 * (H // 16) * (W // 16)
    if kind == "all_zero":
        return np.zeros((1, nb, 64), np.int16)
    rng = np.random.default_rng(5)
    blocks = rng.integers(-2047, 2048, (2, nb, 64)).astype(np.int16)
    blocks[..., 1:] *= (rng.random((2, nb, 63)) < 0.2).astype(np.int16)
    blocks[:, ::3, 1:] = 0
    blocks[:, ::3, 49] = -7              # a run of 48: f0 and f1
    blocks[:, 1::3, 1:] = 0
    blocks[:, 1::3, 63] = 9              # a run of 62, no EOB
    blocks[:, 2::5, 1:18] = 0
    blocks[:, 2::5, 18] = 3              # a run of 16: one ZRL
    return blocks


CASES = {
    # name: (H, W, q or None, cap_words or None: the encoder's)
    "rendered_32x32_q50": (32, 32, 50, None),
    "rendered_48x64_q85": (48, 64, 85, None),
    "rendered_256x256_q95": (256, 256, 95, None),
    "all_zero_48x64": (48, 64, None, None),
    "noise_runs_32x32": (32, 32, None, 1024),
    "overflow_256x256_q95": (256, 256, 95, 300),
    "clamp_one_chunk_256x256_q95": (256, 256, 95, None),
    "clamp_chunk_start_256x256_q95": (256, 256, 95, None),
    "word_boundary_256x256_q95": (256, 256, 95, None),
    "b3_lengths_256x256_q95": (256, 256, 95, None),
}


CRAFTED = {"clamp_one": "clamp in chunk 1 only",
           "clamp_chunk": "clamps first in chunks 1-4",
           "word": "streams ending on a word",
           "b3": "B=3 of different lengths"}


def _case_blocks(name: str, H: int, W: int, q, cap: int) -> np.ndarray:
    if name.startswith(("rendered", "overflow")):
        return _rendered_blocks(sum(map(ord, name)) % 97, H, W, q)
    if name.startswith(("all", "noise")):
        return _crafted("all_zero" if name.startswith("all") else "noise",
                        H, W)
    # The inputs chip_smoke.py holds K6 to on the card, made on the CPU.
    crafted = dict(chip_smoke.bitpack_crafted(
        torch, P, torch.from_numpy(_rendered_blocks(7, H, W, q)),
        P._mcu_scan_index(H // 16, W // 16), cap, KJ.BIT_CHUNK_BLOCKS))
    kind = next(k for k in CRAFTED if name.startswith(k))
    return crafted[CRAFTED[kind]].numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_bitpack_fixed_plain_matches_jax(name):
    H, W, q, cap = CASES[name]
    cap = cap or P.BitpackJpegEncoder(H, W, q or 85).cap_words
    blocks = _case_blocks(name, H, W, q, cap)
    want_w, want_b = _jax_words(blocks, H, W, cap)
    got_w, got_b = P.bitpack_fixed_plain(
        torch.from_numpy(blocks), P._mcu_scan_index(H // 16, W // 16),
        *P.huffman_spec_arrays(), cap)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    over = got_b.numpy() > 32 * cap
    assert over.all() if name.startswith("overflow") else not over.any()
    scan = P._mcu_scan_index(H // 16, W // 16).reshape(-1)
    if name.startswith("noise"):
        # The clamp: the luma chain has DC differences of 2048 and more.
        y_chain = P._mcu_scan_index(H // 16, W // 16)[:, :4].reshape(-1)
        dc = blocks[0, y_chain, 0].astype(np.int32)
        assert np.abs(np.diff(dc)).max() >= 2048
    if name.startswith("clamp_one"):
        # Values below -2047 lie in chunk 1 only, and the clamp changed
        # the stream.
        low = (blocks[:, scan] < -2047).any(axis=2)
        chunks = np.unique(np.nonzero(low)[1] // KJ.BIT_CHUNK_BLOCKS)
        assert chunks.tolist() == [1]
        assert not np.array_equal(
            want_w, _jax_words(_rendered_blocks(7, H, W, q), H, W, cap)[0])
    if name.startswith("clamp_chunk"):
        # Each clamp is the first field of its chunk: its spill reaches
        # the previous chunk's last word (where the chunk starts inside
        # a word).
        for k in range(1, 5):
            g = k * KJ.BIT_CHUNK_BLOCKS
            diff = blocks[:, scan[g], 0].astype(np.int32) \
                - blocks[:, scan[chip_smoke.dc_pred_pos(g)], 0]
            assert (diff <= -2048).all()
    if name.startswith("word"):
        assert (got_b.numpy() % 32 == 0).all()
        assert (got_b.numpy() > 32 * 100).all()
    if name.startswith("b3"):
        assert len(set(got_b.tolist())) == 3


@pytest.mark.parametrize("H, W, q", [(64, 64, 85), (32, 48, 75),
                                     (16, 16, 95)])
def test_encoder_bytes_match_tpu_jpeg_encoder(H, W, q):
    raw = _raw(H * W + q, 2, H, W)
    _, settings = jax_flagship(2)
    want = J.TpuJpegEncoder(H, W, quality=q).encode_batch(
        *jax_batched_args(settings, raw))
    got = P.BitpackJpegEncoder(H, W, quality=q).encode_batch(
        *_port_args(raw, 2))
    assert got == want
    assert got[0][:2] == b"\xff\xd8"


def test_encoder_overflow_takes_the_dense_fallback():
    raw = _raw(1, 1, 32, 32)
    _, settings = jax_flagship(2)
    jax_enc = J.TpuJpegEncoder(32, 32, quality=95, cap_bytes=64)
    port_enc = P.BitpackJpegEncoder(32, 32, quality=95, cap_bytes=64)
    for enc, args in ((jax_enc, jax_batched_args(settings, raw)),
                      (port_enc, _port_args(raw, 2))):
        with pytest.raises(ValueError, match="overflow"):
            enc.encode_batch(*args)
        assert enc.encode_batch(*args, dense_fallback=lambda i: b"dense") \
            == [b"dense"]


# ------------------------------------------------- the direct apps

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("bitpack_apps")))


def test_direct_apps_serve_bitpack_alike(tree, monkeypatch):
    """``jpeg-engine: bitpack`` with the batcher off in both apps: an
    MCU-aligned tile and two flipped ones are K6's streams (the fixed
    tables: two DHTs), a 100x60 region the sparse engine's (four), and
    every body equals JAX's."""
    calls = []
    plain = P.bitpack_fixed_plain

    def spy(blocks, *args):
        calls.append(tuple(blocks.shape))
        return plain(blocks, *args)
    monkeypatch.setattr(P, "bitpack_fixed_plain", spy)
    raw = {"data-dir": tree, "batcher": {"enabled": False},
           "renderer": {"jpeg-engine": "bitpack", "cpu-fallback-max-px": 0}}
    base = f"/webgateway/render_image_region/{IMG}/1/0/"
    # Narrow windows over the tree's noise leave a speckle that fits the
    # stream's capacity.
    ch = "c=1|59600:60000$FF0000,2|0:400$00FF00&m=c&format=jpeg"
    requests = [("GET", f"{base}?tile=0,0,0,256,256&{ch}", {}),
                ("GET", f"{base}?tile=0,0,0,256,256&{ch}&flip=h&q=0.9", {}),
                ("GET", f"{base}?region=16,32,128,96&{ch}&flip=hv", {}),
                ("GET", f"{base}?region=3,5,100,60&{ch}", {})]
    jax_answers, port_answers = exchange(raw, requests)
    tables = []
    for (js, _, jb), (ps, _, pb) in zip(jax_answers, port_answers):
        assert ps == js == 200
        assert pb == jb and pb[:2] == b"\xff\xd8"
        tables.append(pb[:pb.index(b"\xff\xda")].count(b"\xff\xc4"))
    assert tables == [2, 2, 2, 4]
    assert calls == [(1, 1536, 64), (1, 1536, 64), (1, 288, 64)]
