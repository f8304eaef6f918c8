"""Port JPEG route (plain PyTorch path) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart:

* tables and cap rules: equal;
* K3 ``packed_to_jpeg_coefficients``: within 1 of JAX on every
  coefficient, at most 1e-4 of them off (XLA's einsum sums in another
  order than the port's fixed one); the flip and edge-replication folding
  against JAX ``pad_planes_to_mcu`` of the flipped tile;
* K4a ``sparse_pack`` and K4b ``_compact_rows`` (with the row lengths of
  ``render_to_jpeg_sparse_compact``): byte-exact, full buffers;
* the native coder: the same JFIF bytes;
* ``render_batch_to_jpeg``: the same JFIF bytes as the JAX sparse engine,
  on the refimpl-golden content and on noise that forces the 2x cap retry
  and the dense route.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
from omero_ms_image_region_tpu import native as jax_native
from omero_ms_image_region_tpu.flagship import (
    batched_args as jax_batched_args, flagship_settings as jax_flagship,
    synthetic_wsi_tiles,
)
from omero_ms_image_region_tpu.ops import jpegenc as J
from omero_ms_image_region_tpu_torch import native
from omero_ms_image_region_tpu_torch.flagship import flagship_rdef
from omero_ms_image_region_tpu_torch.kernels import build
from omero_ms_image_region_tpu_torch.kernels import jpeg as kernels
from omero_ms_image_region_tpu_torch.ops import jpegenc as P
from omero_ms_image_region_tpu_torch.ops import render as port_render

MISMATCH_SHARE = 1e-4
_jax_sparse_pack = jax.jit(J.sparse_pack, static_argnames=("cap",))


def _packed(rng, B, H, W):
    """u32[B, H, W] RGBA: smooth blobs plus noise of a different strength
    per tile (coefficients from dense to sparse)."""
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((B, H, W, 3), np.float32)
    for b in range(B):
        for _ in range(6):
            cy, cx = rng.integers(0, H), rng.integers(0, W)
            s = rng.uniform(3, max(4, min(H, W) / 3))
            img[b] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                             / (2 * s * s))[..., None] * rng.uniform(0, 255, 3)
        img[b] += rng.normal(0, 4 * b, (H, W, 3))
    img = np.clip(img, 0, 255).astype(np.uint32)
    return (img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16)
            | np.uint32(0xFF000000))


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _jax_coeffs(packed, q):
    qy, qc = (t.astype(np.int32) for t in J.quant_tables(q))
    return [np.asarray(a) for a in
            J.packed_to_jpeg_coefficients(packed, qy, qc)]


def _assert_within_one(got, want, label):
    diffs = [np.abs(g.astype(np.int32) - w) for g, w in zip(got, want)]
    n_off = sum(int((d > 0).sum()) for d in diffs)
    n = sum(d.size for d in diffs)
    print(f"{label}: {n_off} of {n} coefficients differ by 1 "
          f"(share {n_off / n:.2e})")
    assert max(int(d.max()) for d in diffs) <= 1
    assert n_off <= MISMATCH_SHARE * n


@pytest.fixture(autouse=True)
def _clear_cap_memos():
    J._CAP_MEMO.clear()
    P._CAP_MEMO.clear()
    yield
    J._CAP_MEMO.clear()
    P._CAP_MEMO.clear()


# ----------------------------------------------------- tables and cap rules

def test_tables_match_jax():
    for q in range(1, 101):
        for got, want in zip(P.quant_tables(q), J.quant_tables(q)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    np.testing.assert_array_equal(P.zigzag_order(), J.zigzag_order())
    np.testing.assert_array_equal(P.dct_matrix(), J.dct_matrix())
    assert P.ENTRY_BITS == J.ENTRY_BITS


@pytest.mark.parametrize("H,W", [(16, 16), (30, 40), (1024, 1024),
                                 (2048, 720)])
def test_cap_rules_match_jax(H, W):
    for q in (None, 50, 87, 88, 95):
        assert P.default_sparse_cap(H, W, q) == J.default_sparse_cap(H, W, q)
        assert P._quality_widen(q) == J._quality_widen(q)
    assert P.max_sparse_cap(H, W) == J.max_sparse_cap(H, W)
    for cap in (1, 77, P.default_sparse_cap(H, W)):
        assert P.sparse_wire_width(H, W, cap) == J.sparse_wire_width(H, W, cap)
    for total in (0, 1, 5, 999):
        assert P.sparse_prefix_bytes(total, H, W) == \
            J.sparse_prefix_bytes(total, H, W)
    assert P.blocks_per_tile(H, W) * 64 == J.max_sparse_cap(
        H + (-H) % 16, W + (-W) % 16)


def test_wire_helpers_match_jax():
    """row_header_i32, sparse_to_dense and slice_block_subgrid on a JAX
    wire row (an unaligned slice, as compacted rows are)."""
    rng = np.random.default_rng(5)
    H, W = 32, 48
    y, cb, cr = _jax_coeffs(_packed(rng, 1, H, W), 85)
    wire = np.asarray(_jax_sparse_pack(y, cb, cr, cap=500))
    row = np.concatenate([[7], wire[0]]).astype(np.uint8)[1:]
    assert P.row_header_i32(row, 0) == J.row_header_i32(row, 0)
    for cap in (500, 10):
        got, want = P.sparse_to_dense(row, H, W, cap), \
            J.sparse_to_dense(row, H, W, cap)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(P.slice_block_subgrid(*got, H, W, 20, 12),
                        J.slice_block_subgrid(*want, H, W, 20, 12)):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------ K3: coefficients

@pytest.mark.parametrize("q", [50, 85, 95])
def test_coefficients_match_jax(q):
    rng = np.random.default_rng(q)
    packed = _packed(rng, 3, 64, 96)
    got = [a.numpy() for a in
           P.packed_to_jpeg_coefficients(_t(packed), q)]
    want = _jax_coeffs(packed, q)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    _assert_within_one(got, want, f"q{q}")


@pytest.mark.parametrize("flip", ["", "h", "v", "hv"])
def test_coefficients_fold_flip_and_edge_replication(flip):
    """An unaligned 40x30 tile: the port reads the unflipped tile at
    mirrored, clamped coordinates; JAX pads the flipped tile by edge
    replication (``pad_planes_to_mcu``) and transforms that."""
    rng = np.random.default_rng(11)
    h, w = 30, 40
    packed = _packed(rng, 1, h, w)[0]
    flipped = packed[::-1] if "v" in flip else packed
    flipped = flipped[:, ::-1] if "h" in flip else flipped
    padded = J.pad_planes_to_mcu(np.ascontiguousarray(flipped)[None])
    assert padded.shape == (1, 32, 48)
    want = _jax_coeffs(padded, 85)
    got = [a.numpy() for a in P.packed_to_jpeg_coefficients(
        _t(packed[None]), 85, 32, 48, "h" in flip, "v" in flip)]
    _assert_within_one(got, want, f"flip {flip!r}")


def test_coefficients_on_a_larger_frame_replicate_the_edge():
    """grid larger than the tile's ceil-16 frame (a bucketed batch)."""
    rng = np.random.default_rng(12)
    packed = _packed(rng, 2, 16, 16)
    padded = np.pad(packed, ((0, 0), (0, 16), (0, 32)), mode="edge")
    got = [a.numpy() for a in
           P.packed_to_jpeg_coefficients(_t(packed), 85, 32, 48)]
    _assert_within_one(got, _jax_coeffs(padded, 85), "larger frame")
    with pytest.raises(ValueError, match="grid"):
        P.packed_to_jpeg_coefficients(_t(packed), 85, 8, 16)


def _kernel_dct():
    """K3's D as jpeg.cu bakes it (``constexpr float kDct[64]``)."""
    import re

    src = kernels.SOURCE.read_text()
    body = re.search(r"constexpr float kDct\[64\] = \{([^}]*)\};",
                     src).group(1)
    vals = [float.fromhex(v.strip().rstrip("f"))
            for v in body.split(",") if v.strip()]
    return np.array(vals, np.float64).reshape(8, 8)


def test_k3_baked_constants_match_tables():
    """The kernel's D equals ``dct_matrix()`` in float32 bit for bit (each
    literal exactly a float32), and its table offsets are where
    ``device_tables`` puts the quant tables and zigzag positions."""
    D = _kernel_dct()
    assert (D.astype(np.float32).astype(np.float64) == D).all()
    np.testing.assert_array_equal(D.astype(np.float32).view(np.int32),
                                  P.dct_matrix().view(np.int32))
    c = _kernel_constants(["kTabQy", "kTabQc", "kTabZpos", "kTabSize"])
    for q in (1, 50, 85, 90, 100):
        tab = P.device_tables(q, "cpu").numpy()
        assert tab.shape == (c["kTabSize"],)
        qy, qc = P.quant_tables(q)
        np.testing.assert_array_equal(tab[c["kTabQy"]:c["kTabQy"] + 64],
                                      qy.ravel())
        np.testing.assert_array_equal(tab[c["kTabQc"]:c["kTabQc"] + 64],
                                      qc.ravel())
        zpos = tab[c["kTabZpos"]:c["kTabZpos"] + 64].astype(np.int64)
        np.testing.assert_array_equal(P.zigzag_order()[zpos], np.arange(64))


def test_k3_quantizer_reciprocal_division_is_correctly_rounded():
    """K3's divide_q: with inv = RN(1/q), r = RN(acc inv) and one fused
    correction give IEEE acc / q, for every quant value 1..255 and
    accumulators that land on exact halves, at the clip edges, small and
    at random.  Then K3's quantize: below 1025 in magnitude (every
    quotient K3 meets), the low 16 bits of the float x + 1.5 * 2^23 are
    the plain version's rint, clipped to +-2047, as an i16."""
    rng = np.random.default_rng(4)
    q = np.arange(1, 256, dtype=np.float32)[:, None]
    k = rng.integers(-2100, 2100, (255, 400)).astype(np.float32)
    acc = np.concatenate([
        (k + np.float32(0.5)) * q,                        # exact halves
        k * q,                                            # exact integers
        np.float32([2046.5, 2047.0, 2047.5, 2048.0, -2046.5, -2047.0,
                    -2047.5, -2048.0]) * q,               # clip edges
        np.nextafter((np.float32(2047.5) * q).repeat(2, 1),
                     np.float32([[0, np.inf]]).repeat(255, 0)),
        ((rng.random((255, 600)) * 2 - 1) * 2048 * q),     # at random
        (rng.random((255, 100)) * 2.0 ** rng.integers(-83, -20,
                                                      (255, 100))),
    ], axis=1).astype(np.float32)
    q = np.broadcast_to(q, acc.shape).astype(np.float32)
    inv = (np.float32(1) / q).astype(np.float32)
    r = torch.from_numpy(acc * inv)
    acc_t, q_t, inv_t = (torch.from_numpy(np.ascontiguousarray(x))
                         for x in (acc, q, inv))
    got = P.fma(P.fma(-r, q_t, acc_t), inv_t, r).numpy()
    want = (acc / q).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    inside = np.abs(want) < 1025
    assert inside.mean() > 0.4
    magic = (got[inside] + np.float32(12582912)).astype(np.float32)
    np.testing.assert_array_equal(
        (magic.view(np.int32) & 0xFFFF).astype(np.uint16).view(np.int16),
        np.clip(np.rint(want[inside]), -2047, 2047).astype(np.int16))


# ------------------------------------------------------- K4a, K4b: wire

def _coeff_case():
    rng = np.random.default_rng(21)
    return _jax_coeffs(_packed(rng, 3, 32, 48), 85)


@pytest.mark.parametrize("cap", [2000, 400, 1])
def test_sparse_pack_matches_jax(cap):
    """Full wire buffers, zero tail included; cap 400 overflows the
    noisiest tile, cap 1 every tile."""
    y, cb, cr = _coeff_case()
    want = np.asarray(_jax_sparse_pack(y, cb, cr, cap=cap))
    got = P.sparse_pack(_t(y), _t(cb), _t(cr), cap).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _kernel_constants(names):
    """constexpr ints of ``kernels/csrc/jpeg.cu``, so that the model below
    follows the kernel's own partition and window sizes."""
    import re

    src = kernels.SOURCE.read_text()
    env = {}
    for name in names:
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        # C integer division on non-negative ints
        env[name] = eval(m.group(1).replace("/", "//"), {},  # noqa: S307
                         dict(env))
    return env


def _k4a_model(y, cb, cr, cap, base, order_rng, window=None):
    """K4a's kernel step by step, in numpy: the memset, then per partition
    of blocks (8 lanes per block) the counts, the in-place scan, the last
    entry from the last nonzero block, each nonzero's entry at its block's
    offset plus its 8-lane rank, the
    block-wide decoupled lookback over statuses resolved in ``order_rng``'s
    order (the prefix and the field of the entry before the partition),
    and the
    stream bytes whose last bit lies in its kept entries, stored on
    16-byte aligned addresses from the wire's ``base`` address.  No byte
    may be written by two blocks.  ``window`` narrows the lookback's step
    (the kernel's is its block size) to reach its later steps."""
    c = _kernel_constants(["kEntryBits", "kPackThreads", "kPartBlocks"])
    bits, threads, part_blocks = (c["kEntryBits"], c["kPackThreads"],
                                  c["kPartBlocks"])
    groups = threads // 8
    window = window or threads
    B, nby = y.shape[:2]
    nb = nby + 2 * cb.shape[1]
    blocks = np.concatenate([y, cb, cr], axis=1).astype(np.int64)
    nbytes = (bits * cap + 7) // 8
    head, width = 4 + nb, 4 + nb + nbytes
    wire = np.zeros((B, width), np.int64)            # the memset
    writes = np.zeros((B, width), np.int64)

    def put(b, j, v):
        wire[b, j] = v
        writes[b, j] += 1

    parts = max(1, -(-nb // part_blocks))
    local, status = {}, {}       # status: (flag, count, has field, field)
    for p in range(B * parts):                 # block p: partition p
        b, i = divmod(p, parts)
        blk0 = i * part_blocks
        n = max(0, min(part_blocks, nb - blk0))
        cnt = np.zeros(part_blocks, np.int64)
        for r in range(part_blocks // groups):
            for g in range(groups):
                k = r * groups + g
                if k < n:
                    # the 8 lanes' popcounts, reduced by shfl_xor 1, 2, 4
                    cnt[k] = sum(int((blocks[b, blk0 + k, 8 * q:8 * q + 8]
                                      != 0).sum()) for q in range(8))
                    put(b, 4 + blk0 + k, cnt[k])
        incl = np.zeros(part_blocks, np.int64)
        for w in range(part_blocks // 32):
            incl[32 * w:32 * w + 32] = np.cumsum(cnt[32 * w:32 * w + 32])
        warp = incl[31::32]
        offs = [int(warp[:k // 32].sum() + incl[k] - cnt[k])
                for k in range(n)]
        ent = {}
        for k in range(n):
            coeffs = blocks[b, blk0 + k]
            rank = 0
            for part in range(8):
                e = offs[k] + rank
                for q in range(8):
                    if coeffs[8 * part + q]:
                        ent[e] = ((8 * part + q) << 12) | (
                            coeffs[8 * part + q] & 0xFFF)
                        e += 1
                rank += int((coeffs[8 * part:8 * part + 8] != 0).sum())
        agg = int(warp.sum())
        assert sorted(ent) == list(range(agg))
        own = 0
        if agg:
            # the last nonzero of the block whose count is nonzero and
            # whose inclusive prefix is the partition's count
            k = [k for k in range(n) if cnt[k] and offs[k] + cnt[k] == agg]
            assert len(k) == 1
            coeffs = blocks[b, blk0 + k[0]]
            q = np.flatnonzero(coeffs)[-1]
            own = (int(q) << 12) | (coeffs[q] & 0xFFF)
            assert own == ent[agg - 1]
        local[p] = (b, i, agg, ent)
        status[p] = ("agg", agg, agg > 0, own)
    resolved = {}
    for p in order_rng.permutation(B * parts):
        b, i, agg, ent = local[p]
        excl, has, prev = 0, False, 0
        if i > 0:
            j = i - 1
            while True:
                window_st = [status[b * parts + j - t] if j - t >= 0
                             else ("incl", 0, False, 0)
                             for t in range(window)]
                done = [lane for lane, st in enumerate(window_st)
                        if st[0] == "incl"]
                stop = done[0] if done else window - 1
                excl += sum(st[1] for st in window_st[:stop + 1])
                with_field = [st for st in window_st[:stop + 1] if st[2]]
                if not has and with_field:
                    has, prev = True, with_field[0][3]
                if done:
                    break
                j -= window
        last = ent[agg - 1] if agg else prev
        status[p] = ("incl", excl + agg, agg > 0 or has, last)
        resolved[p] = (excl, prev, last)

    def write_stream(b, jlo, jhi, byte):
        lead = (base + b * width + head) % 16
        c = (jlo + lead) // 16
        while 16 * c - lead < jhi:
            j0 = 16 * c - lead
            if j0 >= jlo and j0 + 16 <= jhi:
                assert (base + b * width + head + j0) % 16 == 0
            for j in range(max(j0, jlo), min(j0 + 16, jhi)):
                put(b, head + j, byte(j - jlo))
            c += 1

    def stream_byte(lb, entry):
        assert lb >= -bits
        e0 = (lb + bits) // bits - 1
        off = lb - bits * e0
        part1 = entry(e0 + 1) >> (28 - off) if off > 10 else 0
        return ((((entry(e0) << off) & 0x3FFFF) >> 10) | part1) & 0xFF

    for p, (b, i, agg, ent) in local.items():
        o_start, prev, last = resolved[p]
        o_end = o_start + agg
        kept = min(o_end, cap)
        if o_start < kept:
            def entry(e, ent=ent, n_kept=kept - o_start, prev=prev):
                assert e >= -1
                return prev if e < 0 else (ent[e] if e < n_kept else 0)

            jlo = bits * o_start // 8
            jhi = ((bits * kept + 7) // 8 if o_end >= cap
                   else bits * kept // 8)
            c0 = 8 * jlo - bits * o_start
            write_stream(b, jlo, jhi, lambda l, entry=entry, c0=c0:
                         stream_byte(8 * l + c0, entry))
        if i == parts - 1:
            total = o_end
            for q in range(4):
                put(b, q, (total >> (8 * q)) & 0xFF)
            if 0 < total < cap and (bits * total) % 8:
                j = bits * total // 8
                put(b, head + j, stream_byte(
                    8 * j - bits * (total - 1),
                    lambda e: last if e == 0 else 0))
    assert (writes <= 1).all()
    return wire.astype(np.uint8)


def _k4a_case(name):
    """(y, cb, cr, cap) of i16 coefficients of 128x128 tiles: 384 blocks
    a tile, three of launch 1's partitions."""
    import zlib

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    nby, nbc = 256, 64

    def tiles(B, density, blocks=None):
        out = []
        for _ in range(B):
            v = rng.integers(-2047, 2048, (nby + 2 * nbc, 64))
            keep = rng.random(v.shape) < density
            if blocks is not None:
                keep[~np.isin(np.arange(len(v)), blocks)] = False
            out.append(np.where(keep, v, 0))
        c = np.asarray(out, np.int16)
        return c[:, :nby], c[:, nby:nby + nbc], c[:, nby + nbc:]

    if name == "all_zero":
        return (*tiles(1, 0.0), 2000)
    if name == "partition_straddle":
        # a sparse run of blocks across launch 1's first partition edge,
        # long zero runs for launch 2's search to cross
        return (*tiles(1, 0.6, np.r_[3, 120:137, 380]), 2000)
    if name == "lookback_windows":
        return (*tiles(2, 0.08), 2000)
    if name == "mixed_b3":
        y, cb, cr = (np.concatenate(t) for t in zip(
            tiles(1, 0.08), tiles(1, 0.005), tiles(1, 0.0)))
        return y, cb, cr, 1500
    y, cb, cr = tiles(1, 0.08)
    total = int(sum((t != 0).sum() for t in (y, cb, cr)))
    cap = {"total_eq_cap": total, "total_eq_cap_plus_1": total - 1,
           "cap_1": 1, "random_cap2000": 2000, "random_cap400": 400}[name]
    return y, cb, cr, cap


@pytest.mark.parametrize("name", [
    "all_zero", "total_eq_cap", "total_eq_cap_plus_1", "cap_1",
    "partition_straddle", "random_cap2000", "random_cap400", "mixed_b3",
    "lookback_windows"])
def test_sparse_pack_kernel_index_model_matches_plain_and_jax(name):
    """K4a's index arithmetic (block partition, chained prefix with the
    field before each partition, rank select, byte ownership), modelled in
    numpy, gives the wire of ``sparse_pack_plain`` and of the JAX
    ``sparse_pack``, byte for byte."""
    y, cb, cr, cap = _k4a_case(name)
    rng = np.random.default_rng(3)
    want = np.asarray(_jax_sparse_pack(y, cb, cr, cap=cap))
    np.testing.assert_array_equal(
        P.sparse_pack_plain(_t(y), _t(cb), _t(cr), cap).numpy(), want)
    window = 2 if name == "lookback_windows" else None
    for base in (0, 7):
        np.testing.assert_array_equal(
            _k4a_model(y, cb, cr, cap, base, rng, window), want)


@pytest.mark.parametrize("n_valid", [3, 2, 0])
def test_compact_rows_match_jax(n_valid):
    """Row lengths as ``render_to_jpeg_sparse_compact`` takes them (an
    overflowing row keeps header and counts only; rows past n_valid
    none), then ``_compact_rows``: the full buffers agree."""
    y, cb, cr = _coeff_case()
    cap = 400
    wire = np.asarray(_jax_sparse_pack(y, cb, cr, cap=cap))
    nb = P.blocks_per_tile(32, 48)
    total = wire[:, :4].copy().view(np.int32).ravel()
    assert (total > cap).any() and (total <= cap).any()
    used = 4 + nb + (18 * np.minimum(total, cap) + 7) // 8
    lengths = np.where(total <= cap, used, 4 + nb)
    lengths = np.where(np.arange(3) < n_valid, lengths, 0).astype(np.int32)
    np.testing.assert_array_equal(
        P.sparse_row_lengths(_t(wire), n_valid, cap, nb).numpy(), lengths)
    want = np.asarray(J._compact_rows(wire, lengths))
    got = P.compact_sparse_rows(_t(wire), n_valid, cap, nb).numpy()
    np.testing.assert_array_equal(got, want)
    rows = P.fetch_rows(torch.from_numpy(got), 3)
    assert [len(r) for r in rows] == list(lengths)


def _k4b_model(wire, n_valid, cap, nb, src_base, out_base):
    """K4b's single launch step by step, in numpy: the row lengths from
    the headers and their exclusive scan by 32-row chunks (a warp scan
    with a carry), then the output in 16-byte runs of aligned addresses
    from ``out_base``: a run inside one row's prefix from the aligned
    32-bit source words around it (the wire at ``src_base``) by funnel
    shifts, a run of the zero tail as zeros, any other run (the lengths
    header, a row boundary, the data's end, an end of the output) byte
    by byte.  Every output byte is written once."""
    bits = _kernel_constants(["kEntryBits"])["kEntryBits"]
    B, width = wire.shape
    mem = np.zeros(src_base + B * width + 8, np.uint8)
    mem[src_base:src_base + B * width] = wire.ravel()

    def word(addr):
        assert addr % 4 == 0
        # an aligned word is read only where it holds a byte of the wire
        assert src_base - 3 <= addr < src_base + B * width
        return int.from_bytes(mem[addr:addr + 4].tobytes(), "little")

    offs = np.zeros(B + 1, np.int64)
    carry = 0
    for c in range(0, B, 32):
        lens = []
        for r in range(c, min(c + 32, B)):
            total = int(wire[r, :4].copy().view(np.int32)[0])
            kept = min(total, cap)
            n = (4 + nb + (bits * kept + 7) // 8 if total <= cap
                 else 4 + nb)
            lens.append(n if r < n_valid else 0)
        incl = np.cumsum(lens)
        offs[c:c + len(lens)] = carry + incl - lens
        carry += int(incl[-1])
    offs[B] = carry
    head, data = 4 * B, int(offs[B])
    n = head + B * width
    out = np.zeros(n, np.int64)
    writes = np.zeros(n, np.int64)
    lead = out_base % 16

    def row_of(d):
        return int(np.searchsorted(offs, d, side="right")) - 1

    def byte_at(o):
        if o < head:
            return int(offs[o // 4 + 1] - offs[o // 4]) >> (8 * (o % 4)) & 255
        d = o - head
        if d >= data:
            return 0
        r = row_of(d)
        return int(wire[r, d - offs[r]])

    for c in range((n + lead + 15) // 16):
        o0 = 16 * c - lead
        whole = o0 >= 0 and o0 + 16 <= n
        if whole:
            assert (out_base + o0) % 16 == 0
        if whole and o0 >= head + data:
            run = [0] * 16
        elif (whole and o0 >= head
              and o0 - head + 16 <= offs[row_of(o0 - head) + 1]):
            d0 = o0 - head
            r = row_of(d0)
            src = src_base + r * width + d0 - int(offs[r])
            sh = src % 4
            w = [word(src - sh + 4 * i) for i in range(4)]
            w.append(word(src - sh + 16) if sh else 0)
            words = [((w[i + 1] << 32 | w[i]) >> (8 * sh)) & 0xFFFFFFFF
                     for i in range(4)]
            run = [(x >> (8 * q)) & 255 for x in words for q in range(4)]
        else:
            run = [byte_at(o0 + i) if 0 <= o0 + i < n else None
                   for i in range(16)]
        for i, v in enumerate(run):
            if v is not None and 0 <= o0 + i < n:
                out[o0 + i] = v
                writes[o0 + i] += 1
    assert (writes == 1).all()
    return out.astype(np.uint8)


def _k4b_case(name):
    """(wire, n_valid, cap, nb): wires of K4a's layout, some rows over
    their cap, widths that are not multiples of 16."""
    if name == "jax_wire_b3":
        y, cb, cr = _coeff_case()
        cap = 400
        return (np.asarray(_jax_sparse_pack(y, cb, cr, cap=cap)), 2, cap,
                P.blocks_per_tile(32, 48))
    rng = np.random.default_rng(len(name))
    B, nb, cap, n_valid = {"b1": (1, 54, 37, 1),
                           "b8_odd_width": (8, 54, 46, 8),
                           "b8_n_valid5": (8, 13, 61, 5),
                           "b40_chunks": (40, 6, 9, 37)}[name]
    width = 4 + nb + (18 * cap + 7) // 8
    wire = rng.integers(0, 256, (B, width)).astype(np.uint8)
    totals = rng.integers(0, 2 * cap, B).astype(np.int32)
    totals[0] = cap + 1                       # overflowed
    wire[:, :4] = totals.view(np.uint8).reshape(B, 4)
    return wire, n_valid, cap, nb


@pytest.mark.parametrize("name", ["b1", "jax_wire_b3", "b8_odd_width",
                                  "b8_n_valid5", "b40_chunks"])
def test_compact_rows_kernel_index_model_matches_plain_and_jax(name):
    """K4b's index arithmetic (per-block length scan, 16-byte runs built
    by funnel shifts from aligned words, bytes at the run edges, the zero
    tail), modelled in numpy at several source and output alignments,
    gives the output of ``compact_rows_plain`` and JAX ``_compact_rows``
    byte for byte."""
    wire, n_valid, cap, nb = _k4b_case(name)
    assert wire.shape[1] % 16
    t = _t(wire)
    lengths = P.sparse_row_lengths(t, n_valid, cap, nb)
    want = np.asarray(J._compact_rows(wire, lengths.numpy().astype(
        np.int32)))
    np.testing.assert_array_equal(
        P.compact_rows_plain(t, lengths).numpy(), want)
    for src_base, out_base in ((0, 0), (1, 3), (3, 9), (2, 15)):
        np.testing.assert_array_equal(
            _k4b_model(wire, n_valid, cap, nb, src_base, out_base), want)


def test_device_program_matches_jax_render_to_jpeg_sparse_compact():
    """The whole device half: raw + settings -> compacted wire, the port's
    K1 -> K3 -> K4a -> K4b against JAX ``render_to_jpeg_sparse_compact``."""
    rng = np.random.default_rng(3)
    _, settings = jax_flagship(2)
    raw = synthetic_wsi_tiles(rng, 3, 2, 32, 32)
    args = jax_batched_args(settings, raw)
    q, cap, n_valid = 85, 300, 2
    qy, qc = (np.asarray(t, np.int32) for t in J.quant_tables(q))
    want = np.asarray(J.render_to_jpeg_sparse_compact(
        *args, qy, qc, np.int32(n_valid), cap=cap))
    s = port_render.settings_to_tensors(
        port_render.pack_settings(flagship_rdef(2)), "cpu")
    packed = port_render.render_tile_batch_packed(
        port_render.raw_to_tensor(raw, "cpu"),
        *port_render.batched_settings(s, 3))
    y, cb, cr = P.packed_to_jpeg_coefficients(packed, q)
    wire = P.sparse_pack(y, cb, cr, cap)
    got = P.compact_sparse_rows(wire, n_valid, cap,
                                P.blocks_per_tile(32, 32)).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ native coder

@pytest.mark.parametrize("q", [50, 90])
def test_native_coder_matches_jax(q):
    """Dense and sparse entry points, exact and unaligned true sizes, and
    the overflow signal."""
    rng = np.random.default_rng(q)
    y, cb, cr = _jax_coeffs(_packed(rng, 2, 32, 48), q)
    for i in range(2):
        for w, h in ((48, 32), (41, 27)):
            assert native.jpeg_encode(y[i], cb[i], cr[i], w, h, q) == \
                jax_native.jpeg_encode_native(y[i], cb[i], cr[i], w, h, q)
    wire = np.asarray(_jax_sparse_pack(y, cb, cr, cap=2000))
    for i in range(2):
        assert native.jpeg_encode_sparse(wire[i], 48, 32, q, 2000) == \
            jax_native.jpeg_encode_sparse_native(wire[i], 48, 32, q, 2000)
    with pytest.raises(native.SparseOverflowError):
        native.jpeg_encode_sparse(wire[1], 48, 32, q, 1)
    with pytest.raises(ValueError, match="do not match"):
        native.jpeg_encode(y[0], cb[0], cr[0], 64, 64, q)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "jpegenc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


@pytest.mark.parametrize("helper", ["native", "kernels"])
def test_concurrent_builds_of_one_source_agree(monkeypatch, tmp_path,
                                               helper):
    """Threads of one process that build the same source at once (the
    prewarm's ``build_all`` and a first use on another thread) each get
    the library; no build renames another's file away.  The kernel
    helper runs a stand-in for nvcc that writes its output slowly."""
    import threading

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    if helper == "native":
        src = tmp_path / "seven.cpp"
        src.write_text('extern "C" int seven() { return 7; }\n')
        run = native.build
    else:
        src = tmp_path / "seven.cu"
        src.write_text("// a kernel source\n")
        fake = tmp_path / "nvcc"
        fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                        'printf lib > "$2"; sleep 0.3; printf rary >> "$2"\n')
        fake.chmod(0o755)
        monkeypatch.setattr(build, "nvcc", lambda: str(fake))

        def run(source):
            return build.build(source, ("-O3",))[0]
    gate = threading.Barrier(4)
    paths, errors = [], []

    def one():
        gate.wait()
        try:
            paths.append(run(src))
        except Exception as e:      # recorded, then asserted empty
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(set(paths)) == 1 and len(paths) == 4
    lib = paths[0]
    assert not list(lib.parent.glob("*.tmp.so"))
    if helper == "native":
        assert ctypes.CDLL(str(lib)).seven() == 7
    else:
        assert lib.read_text() == "library"


# ------------------------------------------------- render_batch_to_jpeg

def _port_args(raw: np.ndarray, rdef):
    s = port_render.settings_to_tensors(port_render.pack_settings(rdef),
                                        "cpu")
    return (port_render.raw_to_tensor(raw, "cpu"),
            *port_render.batched_settings(s, raw.shape[0]))


def test_render_batch_to_jpeg_matches_jax_on_golden_content():
    """The content of the JAX package's TestFusedPathsMatchRefimplGolden
    (tests/test_jpeg.py:948): soft blobs within the default cap."""
    B, C, H, W, q = 3, 2, 32, 32, 85
    rdef, settings = jax_flagship(C)
    raw = (synthetic_wsi_tiles(np.random.default_rng(42), B, C, H, W)
           .astype(np.float32) / 8.0 + 15000.0)
    dims = [(W, H)] * B
    want = J.render_batch_to_jpeg(*jax_batched_args(settings, raw),
                                  quality=q, dims=dims, engine="sparse")
    got = P.render_batch_to_jpeg(*_port_args(raw, flagship_rdef(C)),
                                 quality=q, dims=dims)
    assert got == want
    assert P._CAP_MEMO == J._CAP_MEMO == {}


def test_render_batch_to_jpeg_matches_jax_on_retry_and_dense_route():
    """Noise tiles: one under the cap, one between it and twice it (the
    one-shot 2x retry), one over twice it (the per-tile dense route); an
    unaligned true size (block subgrid) and a padding row past dims."""
    C, H, W, q = 2, 32, 32, 85
    rng = np.random.default_rng(7)
    raw = np.concatenate([
        15000 + rng.normal(0, amp, (1, C, H, W)) for amp in
        (500, 1000, 4000, 300)]).astype(np.float32)
    _, settings = jax_flagship(C)
    dims = [(20, 12), (W, H), (W, H)]
    cap = J.default_sparse_cap(H, W, q)
    want = J.render_batch_to_jpeg(*jax_batched_args(settings, raw),
                                  quality=q, dims=dims, engine="sparse")
    assert J._CAP_MEMO == {("sparse", H, W, q): True}
    got = P.render_batch_to_jpeg(*_port_args(raw, flagship_rdef(C)),
                                 quality=q, dims=dims)
    assert got == want
    assert P._CAP_MEMO == J._CAP_MEMO
    # The memo now starts the workload at the doubled cap, in both.
    assert P.render_batch_to_jpeg(*_port_args(raw, flagship_rdef(C)),
                                  quality=q, dims=dims) == want
    rows = P.wire_rows(*P.packed_to_jpeg_coefficients(
        port_render.render_tile_batch_packed(
            *_port_args(raw, flagship_rdef(C))), q), 2 * cap, 3)
    totals = [P.row_header_i32(r, 0) for r in rows]
    assert totals[0] <= cap < totals[1] <= 2 * cap < totals[2]


def test_render_batch_to_jpeg_refuses_unaligned_frames():
    raw = np.zeros((1, 2, 20, 32), np.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        P.render_batch_to_jpeg(*_port_args(raw, flagship_rdef(2)),
                               quality=85, dims=[(32, 20)])


# ------------------------------------------------------------- kernels

def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA or raises; it never falls back."""
    before = dict(kernels.LAUNCHES)
    packed = torch.zeros((1, 16, 16), dtype=torch.int32)
    coeffs = torch.zeros((1, 4, 64), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.jpeg_coefficients(packed, torch.zeros(192), 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sparse_pack(coeffs, coeffs[:, :1], coeffs[:, :1], 10)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.compact_rows(torch.zeros((1, 40), dtype=torch.uint8), 1, 10,
                             6)
    assert kernels.LAUNCHES == before


def test_kernel_build_needs_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 96), (1, 30, 40), (3, 128, 128)])
def test_jpeg_kernels_match_plain_on_the_card(shape):
    """On a CUDA card: K3 exact (flipped h, v and hv, an unaligned tile,
    a larger frame, a base that is not 16-byte aligned), K4a and K4b byte
    for byte, against their plain versions; K4a also on an
    all-zero tile, on the mixed-density B=3 batch of the index model and on
    a tile of 98304 blocks (768 partitions: three steps of lookback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    B, h, w = shape
    dev = torch.device("cuda")
    packed = _t(_packed(np.random.default_rng(1), B, h, w))
    gh, gw = h + (-h) % 16, w + (-w) % 16
    on_card = packed.to(dev)
    # a base 4 bytes past a 16-byte boundary: the scalar path
    unaligned = torch.cat([on_card.reshape(-1)[:1], on_card.reshape(-1)])[
        1:].view(B, h, w)
    assert unaligned.data_ptr() % 16 == 4
    for tile, grid, flip in (
            (on_card, (gh, gw), (True, True)),
            (on_card, (gh, gw), (True, False)),
            (on_card, (gh, gw), (False, True)),
            (on_card, (gh + 16, gw + 32), (False, True)),   # larger frame
            (unaligned, (gh, gw), (True, False)),
            (on_card, (gh, gw), (False, False))):
        got = P.packed_to_jpeg_coefficients(tile, 90, *grid, *flip)
        want = P.packed_to_jpeg_coefficients_plain(tile, 90, *grid, *flip)
        for g, wt in zip(got, want):
            assert torch.equal(g, wt)
    y, cb, cr = got
    nb = P.blocks_per_tile(gh, gw)
    for cap in (P.default_sparse_cap(gh, gw, 90), 5):
        wire = P.sparse_pack(y, cb, cr, cap)
        assert torch.equal(wire, P.sparse_pack_plain(y, cb, cr, cap))
        for n_valid in (B, B - 1):
            assert torch.equal(
                P.compact_sparse_rows(wire, n_valid, cap, nb),
                P.compact_rows_plain(
                    wire, P.sparse_row_lengths(wire, n_valid, cap, nb)))
    mixed = _k4a_case("mixed_b3")
    rng = np.random.default_rng(2)
    wide = [np.where(rng.random((1, n, 64)) < 0.05,
                     rng.integers(-2047, 2048, (1, n, 64)), 0).astype(
                         np.int16) for n in (65536, 16384, 16384)]
    for c, cap in (([torch.zeros_like(t[:1]) for t in (y, cb, cr)], 1000),
                   ([_t(a).to(dev) for a in mixed[:3]], mixed[3]),
                   ([_t(a).to(dev) for a in wide], 400000)):
        assert torch.equal(P.sparse_pack(*c, cap),
                           P.sparse_pack_plain(*c, cap))


def _f32_nearest(v):
    """The float32 nearest the exact rational ``v``, ties to even."""
    from fractions import Fraction

    f = np.float32(float(v))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    best = min(abs(Fraction(float(c)) - v) for c in cands)
    ties = [c for c in cands if abs(Fraction(float(c)) - v) == best]
    return min(ties, key=lambda c: int(np.float32(c).view(np.int32)) & 1)


def test_fma_is_correctly_rounded():
    """``ops.jpegenc.fma`` (the plain version's stand-in for the kernel's
    __fmaf_rn) against the exact a*b + c rounded to float32, including
    cancellations and operands far apart in magnitude."""
    from fractions import Fraction

    rng = np.random.default_rng(8)
    n = 3000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-50, 50, n)).astype(
        np.float32)
    c[:n // 2] = (-(a[:n // 2].astype(np.float64) * b[:n // 2])
                  * (1 + rng.standard_normal(n // 2) * 1e-7)).astype(
        np.float32)
    got = P.fma(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_f32_nearest(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
