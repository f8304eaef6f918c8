"""The JPEG route: coefficient front end, the sparse and the Huffman
wire engines, host tails.

Counterpart of the JAX package's ``ops/jpegenc.py``
(``render_batch_to_jpeg(engine=...)``, ``:1448``): the sparse engine and,
since the Huffman engine joined it, the device Huffman engine too.  On the
card the route is

    K1 render (kernels/render.py)  ->  K3 jpeg_coefficients  ->
    K4a sparse_pack    ->  K4b compact_rows (sparse rows)    [sparse]
    K5 huffman_pack    ->  K4b compact_rows (Huffman rows)   [huffman]

and only the compacted wire (the used bytes of every row behind an i32
lengths header) crosses to the host.  There the native coder
(``native/jpegenc.cpp``) codes each sparse row to JFIF; a Huffman row is
already the entropy stream, which the host byte-swaps, 0xFF-stuffs and
frames (``jfif.py``), about 3x fewer wire bytes than the sparse row.  The
Huffman engine codes with the fixed shared tables until a workload's tuned
tables are built (once, on a thread, from one tile); a group whose tiles
are not all grid-exact takes the sparse engine, as in JAX.  A tile over
its budgets is coded from its dense coefficients.  The wire's D2H is
timed and reported to the fetch observer (:func:`set_fetch_observer`),
which the adaptive engine (``utils.adaptive``) reads.

Each device stage has a dispatcher here that sends a CPU tensor to its plain
PyTorch version (``*_plain``, also what the kernels are held against on the
card) and a CUDA tensor to its kernel in ``kernels/jpeg.py`` (or raises).

Coefficient layout (the JAX package's contract with the entropy coder):
  * ``y``  i16[B, (H/8)*(W/8),   64]  luma blocks, raster order, zigzagged
  * ``cb`` i16[B, (H/16)*(W/16), 64]  subsampled chroma, raster, zigzagged
  * ``cr`` i16[B, (H/16)*(W/16), 64]
for an (H, W) frame of 16x16 MCUs.  A tile of another size is coded over
its ceil-16 frame with the edge replicated, and its true size goes into the
SOF0 header.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..utils.stopwatch import stopwatch

# ---------------------------------------------------------------- tables

# Annex K base quantization tables (natural 8x8 order).
BASE_LUMA_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.int32)

BASE_CHROMA_QUANT = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.int32)

# BT.601 full-range weights as float32 (the kernel's literals).
_Y = np.float32([0.299, 0.587, 0.114])
_CB = np.float32([-0.168736, 0.331264, 0.5])
_CR = np.float32([0.5, 0.418688, 0.081312])


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling of the Annex K tables -> (luma, chroma) u8[8,8]."""
    quality = int(max(1, min(100, quality)))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality

    def scaled(base):
        t = (base * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.uint8)
    return scaled(BASE_LUMA_QUANT), scaled(BASE_CHROMA_QUANT)


@functools.lru_cache(maxsize=1)
def zigzag_order() -> np.ndarray:
    """Flat indices (into a row-major 8x8 block) in JPEG zigzag order."""
    order = sorted(
        ((r, c) for r in range(8) for c in range(8)),
        key=lambda rc: (rc[0] + rc[1],
                        rc[1] if (rc[0] + rc[1]) % 2 == 0 else rc[0]),
    )
    return np.array([r * 8 + c for r, c in order], dtype=np.int32)


@functools.lru_cache(maxsize=1)
def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix == the JPEG FDCT normalization."""
    k = np.arange(8)
    D = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    D[0] *= 1.0 / np.sqrt(2.0)
    return D.astype(np.float32)


def device_tables(quality: int, device) -> torch.Tensor:
    """K3's f32[192] table block on ``device``: the luma and chroma quant
    tables (natural order) and each natural index's zigzag position."""
    return _device_tables(int(quality), str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _device_tables(quality: int, device: str) -> torch.Tensor:
    qy, qc = quant_tables(quality)
    host = np.concatenate([qy.ravel(), qc.ravel(),
                           np.argsort(zigzag_order())]).astype(np.float32)
    return torch.from_numpy(host).to(device)


# -------------------------------------------------------------- cap rules

ENTRY_BITS = 18      # 6-bit zigzag position + 12-bit value (two's compl.)


def sparse_wire_width(H: int, W: int, cap: int) -> int:
    """Total wire-buffer bytes per tile."""
    h16, w16 = (H + 15) // 16, (W + 15) // 16
    nb = h16 * w16 * 6
    return 4 + nb + (ENTRY_BITS * cap + 7) // 8


def sparse_prefix_bytes(total: int, H: int, W: int) -> int:
    """Bytes of a tile's wire buffer actually carrying data: the header,
    the per-block counts, and ``total`` 18-bit entries."""
    h16, w16 = (H + 15) // 16, (W + 15) // 16
    nb = h16 * w16 * 6
    return 4 + nb + (ENTRY_BITS * int(total) + 7) // 8


def _quality_widen(quality: Optional[int]) -> int:
    """Cap multiplier for high-quality quant tables: WSI content runs ~5%
    coefficient density at q80 but ~12% at q90, past the 1/8 default."""
    return 2 if quality is not None and quality >= 88 else 1


def default_sparse_cap(H: int, W: int,
                       quality: Optional[int] = None) -> int:
    """Wire entry budget per tile: 1/8 of all coefficient slots (1/4 for
    quality >= 88)."""
    return max_sparse_cap(H, W) // 8 * _quality_widen(quality)


def max_sparse_cap(H: int, W: int) -> int:
    """Every coefficient slot of the (16-aligned) frame: the cap at which
    no tile can overflow."""
    nb = (H // 8) * (W // 8) + 2 * (H // 16) * (W // 16)
    return nb * 64


def blocks_per_tile(H: int, W: int) -> int:
    """Coefficient blocks of a tile's ceil-16 frame (luma + both chroma)."""
    return ((H + 15) // 16) * ((W + 15) // 16) * 6


def row_header_i32(row: np.ndarray, word: int) -> int:
    """Header field ``word`` of one wire row (compacted rows may sit at
    unaligned offsets, so go through bytes, not a view)."""
    return int.from_bytes(row[4 * word:4 * word + 4].tobytes(),
                          "little", signed=True)


def sparse_to_dense(buf: np.ndarray, H: int, W: int, cap: int):
    """Rebuild (y, cb, cr) dense coefficient blocks from one wire row, or
    None if the row overflowed ``cap``.  ``buf`` may be any length from
    its used prefix on."""
    h16, w16 = (H + 15) // 16, (W + 15) // 16
    nb_y = h16 * w16 * 4
    nb_c = h16 * w16
    nb = nb_y + 2 * nb_c
    total = int(buf[:4].view(np.int32)[0])
    if total > cap:
        return None
    need = 4 + nb + (ENTRY_BITS * total + 7) // 8
    if len(buf) < need:
        raise ValueError(
            f"sparse buffer too short: {len(buf)} bytes < {need} needed")
    counts = buf[4:4 + nb].astype(np.int64)
    if int(counts.sum()) != total:
        raise ValueError("sparse buffer malformed: counts do not sum to "
                         "total")
    # Entry j lives MSB-first at bit 18j: read a 32-bit big-endian window
    # at its byte and shift.
    stream = np.pad(buf[4 + nb:], (0, 4)).astype(np.uint32)
    j = np.arange(total)
    bit = j * ENTRY_BITS
    byte0 = bit >> 3
    shift = bit & 7
    window = ((stream[byte0] << 24) | (stream[byte0 + 1] << 16)
              | (stream[byte0 + 2] << 8) | stream[byte0 + 3])
    field = (window >> (32 - 18 - shift)) & 0x3FFFF
    ps = (field >> 12).astype(np.int64)
    vs = (field & 0xFFF).astype(np.int16)
    vs = np.where(vs >= 2048, vs - 4096, vs).astype(np.int16)
    dense = np.zeros((nb, 64), np.int16)
    block_ids = np.repeat(np.arange(nb), counts)
    dense[block_ids, ps] = vs
    return (dense[:nb_y].reshape(nb_y, 64),
            dense[nb_y:nb_y + nb_c].reshape(nb_c, 64),
            dense[nb_y + nb_c:].reshape(nb_c, 64))


def slice_block_subgrid(y, cb, cr, grid_h: int, grid_w: int,
                        width: int, height: int):
    """The top-left ceil-16 subgrid of dense coefficient blocks: a wire
    row may cover a (grid_h, grid_w) frame larger than the tile, and
    baseline JPEG decodes exactly ceil(h/16) x ceil(w/16) MCUs."""
    gh16, gw16 = grid_h // 16, grid_w // 16
    th16, tw16 = (height + 15) // 16, (width + 15) // 16
    y = y.reshape(gh16 * 2, gw16 * 2, 64)[:th16 * 2, :tw16 * 2]
    cb = cb.reshape(gh16, gw16, 64)[:th16, :tw16]
    cr = cr.reshape(gh16, gw16, 64)[:th16, :tw16]
    return (np.ascontiguousarray(y).reshape(-1, 64),
            np.ascontiguousarray(cb).reshape(-1, 64),
            np.ascontiguousarray(cr).reshape(-1, 64))


# ------------------------------------------------------ K3: coefficients

def _frame_index(n: int, grid: int, flip: bool, device) -> torch.Tensor:
    """Source index of each frame position along one axis: the edge
    replicated past ``n``, then mirrored when ``flip``."""
    idx = torch.arange(grid, device=device).clamp(max=n - 1)
    return (n - 1) - idx if flip else idx


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as CUDA's ``__fmaf_rn`` and a
    CPU's FMA instruction give it.

    The product is exact in float64; the sum is taken in float64 rounded
    to odd (TwoSum finds its error; an inexact sum with an even last bit
    moves one ulp toward the exact value), and rounding that to float32
    is then correctly rounded (53 >= 24 + 2 bits).
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _dot8(terms) -> torch.Tensor:
    """sum of eight products ``(a, b)`` in XLA's order (the kernel's):
    four lanes, lane s = fma(a[s+4], b[s+4], a[s] * b[s]), then
    (l0 + l1) + (l2 + l3)."""
    terms = list(terms)
    lanes = [fma(*terms[s + 4], terms[s][0] * terms[s][1])
             for s in range(4)]
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def _dct_quant_zigzag(x: torch.Tensor, qtable: np.ndarray) -> torch.Tensor:
    """[B, h, w] f32 samples (h, w multiples of 8) -> i16[B, nb, 64]."""
    Bq, h, w = x.shape
    X = x.reshape(Bq, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    X = X.reshape(Bq, -1, 8, 8)                        # [B, nb, x, y]
    D = torch.from_numpy(dct_matrix()).to(x.device)
    # T[u][y] = sum_x D[u][x] X[x][y]
    T = _dot8((D[None, None, :, k, None], X[:, :, None, k, :])
              for k in range(8))                       # [B, nb, u, y]
    # C[u][v] = sum_y T[u][y] D[v][y]
    C = _dot8((T[:, :, :, k, None], D[None, None, None, :, k])
              for k in range(8))                       # [B, nb, u, v]
    qt = torch.from_numpy(qtable.astype(np.float32)).to(x.device)
    q = torch.round(C / qt)
    q = torch.clamp(q, -2047.0, 2047.0).to(torch.int16).reshape(Bq, -1, 64)
    zig = torch.from_numpy(zigzag_order()).to(device=x.device,
                                               dtype=torch.int64)
    return q[..., zig]


def packed_to_jpeg_coefficients_plain(packed: torch.Tensor, quality: int,
                                      grid_h: Optional[int] = None,
                                      grid_w: Optional[int] = None,
                                      flip_h: bool = False,
                                      flip_v: bool = False):
    """Plain PyTorch K3: packed i32[B, h, w] RGBA -> (y, cb, cr) over the
    (grid_h, grid_w) frame (default: the ceil-16 frame), the tile first
    mirrored by ``flip_h``/``flip_v`` and its edge replicated.

    The operations and their order are XLA's for the JAX function (on a
    CPU), as ``csrc/jpeg.cu`` states them: f32 products and sums rounded
    one by one, and the fused multiply-adds XLA makes done by :func:`fma`.
    So the kernel agrees with this exactly, and both with JAX.
    """
    B, h, w = packed.shape
    grid_h = grid_h if grid_h is not None else h + (-h) % 16
    grid_w = grid_w if grid_w is not None else w + (-w) % 16
    if grid_h % 16 or grid_w % 16 or grid_h < h or grid_w < w:
        raise ValueError(f"bad MCU grid ({grid_h}, {grid_w}) for ({h}, {w})")
    dev = packed.device
    rows = _frame_index(h, grid_h, flip_v, dev)
    cols = _frame_index(w, grid_w, flip_h, dev)
    p = packed.index_select(1, rows).index_select(2, cols)
    r = (p & 0xFF).to(torch.float32)
    g = ((p >> 8) & 0xFF).to(torch.float32)
    b = ((p >> 16) & 0xFF).to(torch.float32)

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    y = fma(c(_Y[2]), b, fma(c(_Y[0]), r, c(_Y[1]) * g)) - c(128.0)
    cb = fma(c(_CB[2]), b, fma(c(_CB[0]), r, -(c(_CB[1]) * g)))
    cr = fma(-c(_CR[2]), b, fma(c(_CR[0]), r, -(c(_CR[1]) * g)))

    def sub(x):
        return ((x[:, 0::2, 0::2] + x[:, 0::2, 1::2])
                + (x[:, 1::2, 0::2] + x[:, 1::2, 1::2])) / c(4.0)

    qy, qc = quant_tables(quality)
    return (_dct_quant_zigzag(y, qy), _dct_quant_zigzag(sub(cb), qc),
            _dct_quant_zigzag(sub(cr), qc))


def packed_to_jpeg_coefficients(packed: torch.Tensor, quality: int,
                                grid_h: Optional[int] = None,
                                grid_w: Optional[int] = None,
                                flip_h: bool = False, flip_v: bool = False):
    """K3 dispatcher: the plain version for a CPU tensor, the kernel
    (``kernels.jpeg.jpeg_coefficients``) for a CUDA tensor."""
    if packed.device.type == "cpu":
        return packed_to_jpeg_coefficients_plain(
            packed, quality, grid_h, grid_w, flip_h, flip_v)
    from ..kernels import jpeg as kernels

    B, h, w = packed.shape
    return kernels.jpeg_coefficients(
        packed, device_tables(quality, packed.device),
        grid_h if grid_h is not None else h + (-h) % 16,
        grid_w if grid_w is not None else w + (-w) % 16, flip_h, flip_v)


# ------------------------------------------------------- K4a: sparse wire

def sparse_pack_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """Plain PyTorch K4a: coefficients -> u8[B, width] wire rows

        [ total i32 LE | per-block nonzero counts u8[nb] |
          18-bit entries u8[ceil(18 cap / 8)] ]

    entry j (MSB-first at bit 18j) being ``pos << 12 | val & 0xFFF`` of
    the j-th nonzero in (block, zigzag) order, blocks luma, Cb, Cr.
    Entries past ``cap`` are dropped (the host sees total > cap) and the
    stream's unused bytes are zero.
    """
    B = y.shape[0]
    dev = y.device
    flat = torch.cat([y.reshape(B, -1), cb.reshape(B, -1),
                      cr.reshape(B, -1)], dim=1).to(torch.int64)
    N = flat.shape[1]
    nb = N // 64
    mask = flat != 0
    counts = mask.reshape(B, nb, 64).sum(-1).to(torch.uint8)
    wi = torch.cumsum(mask, dim=1) - 1                     # [B, N]
    total = mask.sum(dim=1).to(torch.int32)
    pos = torch.arange(N, device=dev) % 64
    field = (pos << 12) | (flat & 0xFFF)
    # Kept entries land at their running index; every other one writes a
    # zero to slot `cap`, which is also the e0 + 1 guard below.
    kept = mask & (wi < cap)
    comp = torch.zeros((B, cap + 1), dtype=torch.int64, device=dev)
    comp.scatter_(1, torch.where(kept, wi, torch.full_like(wi, cap)),
                  torch.where(kept, field, torch.zeros_like(field)))
    nbytes = (ENTRY_BITS * cap + 7) // 8
    bitpos = torch.arange(nbytes, device=dev) * 8
    e0 = bitpos // ENTRY_BITS
    off = bitpos - e0 * ENTRY_BITS                         # 0..17
    f0 = comp[:, e0]
    f1 = comp[:, e0 + 1]
    part0 = ((f0 << off) & 0x3FFFF) >> 10
    part1 = torch.where(off > 10, f1 >> (28 - off), torch.zeros_like(f1))
    stream = ((part0 | part1) & 0xFF).to(torch.uint8)
    header = total.reshape(B, 1).view(torch.uint8)         # little-endian
    return torch.cat([header, counts, stream], dim=1)


def sparse_pack(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                cap: int) -> torch.Tensor:
    """K4a dispatcher (plain version on CPU, kernel on CUDA)."""
    if y.device.type == "cpu":
        return sparse_pack_plain(y, cb, cr, cap)
    from ..kernels import jpeg as kernels

    return kernels.sparse_pack(y, cb, cr, cap)


# ---------------------------------------------------- K4b: row compaction

def sparse_row_lengths(wire: torch.Tensor, n_valid: int, cap: int,
                       nb: int) -> torch.Tensor:
    """Used bytes of each wire row: header, counts and the kept entries;
    only header and counts for a row that overflowed ``cap`` (enough for
    the host to see it); 0 for rows at or past ``n_valid``."""
    B = wire.shape[0]
    total = wire[:, :4].reshape(-1).view(torch.int32).to(torch.int64)
    used = 4 + nb + (ENTRY_BITS * torch.clamp(total, max=cap) + 7) // 8
    lengths = torch.where(total <= cap, used, torch.full_like(used, 4 + nb))
    keep = torch.arange(B, device=wire.device) < n_valid
    return torch.where(keep, lengths, torch.zeros_like(lengths))


def compact_rows_plain(wire: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Pack each row's first ``lengths[b]`` bytes contiguously behind an
    i32 LE lengths header: u8[4B + B*width],

        [ lengths i32 LE x B | row0[:len0] | row1[:len1] | ... | zeros ]
    """
    B, width = wire.shape
    lengths = lengths.to(torch.int64)
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=wire.device),
                     torch.cumsum(lengths, 0)])
    col = torch.arange(width, device=wire.device)
    keep = col[None, :] < lengths[:, None]
    data = torch.zeros(B * width, dtype=torch.uint8, device=wire.device)
    data[(cum[:-1, None] + col[None, :])[keep]] = wire[keep]
    header = lengths.to(torch.int32).view(torch.uint8)
    return torch.cat([header, data])


def compact_sparse_rows(wire: torch.Tensor, n_valid: int, cap: int,
                        nb: int) -> torch.Tensor:
    """K4b dispatcher: :func:`compact_rows_plain` over
    :func:`sparse_row_lengths` on CPU, the kernel on CUDA."""
    if wire.device.type == "cpu":
        return compact_rows_plain(
            wire, sparse_row_lengths(wire, n_valid, cap, nb))
    from ..kernels import jpeg as kernels

    return kernels.compact_rows(wire, n_valid, cap, nb)


# The wire-fetch observer: fn(nbytes, seconds), fed by fetch_rows so an
# adaptive engine (utils.adaptive) can track the live device-to-host rate;
# None: off.
_FETCH_OBSERVER = None


def set_fetch_observer(fn) -> None:
    global _FETCH_OBSERVER
    _FETCH_OBSERVER = fn


def _observe_fetch(nbytes: int, seconds: float) -> None:
    """Report one wire fetch (a transfer alone: the device's work was
    waited for before it).  An observer's failure never reaches the
    serving path."""
    obs = _FETCH_OBSERVER
    if obs is not None:
        try:
            obs(nbytes, seconds)
        except Exception:   # pragma: no cover - observer bugs stay there
            pass


def fetch_rows(compact: torch.Tensor, B: int) -> List[np.ndarray]:
    """The compacted wire to the host: its lengths header, then exactly
    the bytes the rows use.  Returns each row as a u8 array (rows that
    carry nothing come back empty).  The header's copy waits for the
    device's work; the body's is the transfer alone, timed for the fetch
    observer."""
    lengths = compact[:4 * B].cpu().numpy().view(np.int32).astype(np.int64)
    used = int(lengths.sum())
    t0 = time.perf_counter()
    body = compact[4 * B:4 * B + used].cpu().numpy()
    _observe_fetch(used, time.perf_counter() - t0)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    return [body[offs[i]:offs[i + 1]] for i in range(B)]


# ------------------------------------------------------------- host tail

# Process-wide overflow memo: once a (shape, quality) workload overflows
# its default cap, later calls start at the doubled cap.
_CAP_MEMO: dict = {}


def finish_sparse_to_jpegs(bufs, dims, H: int, W: int, quality: int,
                           cap: int, dense_coefficients: Callable,
                           on_tile: Optional[Callable] = None) -> list:
    """Fetched wire rows -> JFIF per tile.

    ``dims`` gives each tile's true ``(width, height)``.  A tile whose own
    ceil-16 frame is smaller than (H, W) is coded from the top-left block
    subgrid; a tile that overflowed ``cap`` is coded from
    ``dense_coefficients(i) -> (y, cb, cr)`` with the dense coder.
    ``on_tile(i, data)``, when given, is called with each tile's bytes as
    soon as they exist (the batcher's first-tile-out settlement).
    """
    out = []
    for i, (w_, h_) in enumerate(dims):
        exact = ((h_ + 15) // 16 * 16 == H and (w_ + 15) // 16 * 16 == W)
        try:
            if exact:
                out.append(native.jpeg_encode_sparse(bufs[i], w_, h_,
                                                     quality, cap))
                if on_tile is not None:
                    on_tile(i, out[-1])
                continue
            dense = sparse_to_dense(bufs[i], H, W, cap)
            if dense is None:
                raise native.SparseOverflowError(f"overflow (cap={cap})")
        except native.SparseOverflowError:
            dense = dense_coefficients(i)
        y, cb, cr = slice_block_subgrid(*dense, H, W, w_, h_) \
            if not exact else dense
        out.append(native.jpeg_encode(y, cb, cr, w_, h_, quality))
        if on_tile is not None:
            on_tile(i, out[-1])
    return out


def wire_rows(y, cb, cr, cap: int, n_valid: int) -> List[np.ndarray]:
    """K4a + K4b on the coefficients' device, then the compacted wire's
    used bytes to the host: the first ``n_valid`` rows."""
    B = y.shape[0]
    nb = y.shape[1] + 2 * cb.shape[1]
    wire = sparse_pack(y, cb, cr, cap)
    return fetch_rows(compact_sparse_rows(wire, n_valid, cap, nb),
                      B)[:n_valid]


# ------------------------------------------------- K5: the Huffman wire

def default_words_cap(H: int, W: int, quality: Optional[int] = None) -> int:
    """Stream-word budget per tile of the Huffman wire: H*W/8 bytes
    (doubled for quality >= 88); a tile past it takes the dense path."""
    return (H * W) // 8 // 4 * _quality_widen(quality)


def huffman_spec_arrays() -> tuple:
    """``(dc_code, dc_len, ac_code, ac_len)`` i32 arrays of the fixed
    spec (``jfif.fixed_huffman_spec``)."""
    from ..jfif import fixed_huffman_spec
    return spec_kernel_arrays(fixed_huffman_spec())


def spec_kernel_arrays(spec8) -> tuple:
    """A jfif 8-tuple spec -> the ``(dc_code, dc_len, ac_code, ac_len)``
    i32 arrays the packer takes (one projection for the fixed spec, the
    tuner and the checks)."""
    return (spec8[2].astype(np.int32), spec8[3].astype(np.int32),
            spec8[6].astype(np.int32), spec8[7].astype(np.int32))


def spec_tensor(spec_arrays, device) -> torch.Tensor:
    """K5's i32[1024] spec block on ``device``: dc_code, dc_len, ac_code
    and ac_len, 256 entries each.  Refuses a spec whose codes pass 16
    bits or whose ZRL code passes 10 (three fold into one field)."""
    arrays = [np.asarray(a, np.int32).ravel() for a in spec_arrays]
    host = np.zeros(1024, np.int32)
    for i, a in enumerate(arrays):
        if a.size > 256:
            raise ValueError(f"spec array {i} has {a.size} > 256 entries")
        host[256 * i:256 * i + a.size] = a
    lens = np.concatenate([host[256:512], host[768:1024]])
    if lens.max() > 16 or host[768 + 0xF0] > 10:
        raise ValueError("spec codes must be <= 16 bits, the ZRL code "
                         "<= 10 bits")
    return _spec_tensor(host.tobytes(), str(torch.device(device)))


@functools.lru_cache(maxsize=16)
def _spec_tensor(host: bytes, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(host, np.int32).copy()).to(device)


def _category_t(x: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude category (``_category``: bit length, held to 11)."""
    a = x.abs()
    return sum((a >= (1 << b)).to(torch.int64) for b in range(11))


def _amplitude_t(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Amplitude bits: the value, or its ones' complement in s bits."""
    return torch.where(x >= 0, x, x + (1 << s) - 1)


def huffman_pack_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                       cap_words: int, spec: torch.Tensor, h16: int,
                       w16: int) -> torch.Tensor:
    """Plain PyTorch K5: zigzag coefficients of B tiles on a (16 h16,
    16 w16) frame -> u8[B, 8 + 4 cap_words] rows

        [ total nonzeros i32 LE | total bits i32 LE | words u32 LE ]

    the JPEG entropy stream of each tile coded with ``spec`` (the i32[1024]
    block of :func:`spec_tensor`): blocks in MCU scan order; each block's
    DC difference against its component's predecessor (Y0 <- the previous
    MCU's Y3, Y1..Y3 <- the Y before them, Cb and Cr <- their own block one
    MCU back, the first 0), code then amplitude; each nonzero AC
    coefficient's ZRL codes (up to three, one field) and run/size code and
    amplitude; an EOB unless position 63 is nonzero.  Stream bit 0 is the
    MSB of word 0; words past ``cap_words`` are dropped.

    The JAX ``huffman_pack`` computes the same stream over its compacted
    entry list (entries past ``cap`` dropped); this one, as K5 does,
    computes it per coefficient (cumsum, cummax and scatter-adds of
    disjoint bits), so the two agree word for word on every row within
    the budgets, and on a row over ``cap`` entries in ``total`` and the
    overflow decision (JAX's bit count is then of a cut stream)."""
    B = y.shape[0]
    total, total_bits, val, length, start, _ = huffman_fields_plain(
        y, cb, cr, spec, h16, w16)

    # Deposits: field bits [start, start + len) MSB first, i.e. at
    # 32 - rb - len of word start >> 5, the low part spilling into the
    # next word.  Disjoint bits, so adding is OR-ing; slot cap_words
    # takes the dropped words.
    w = start >> 5
    rb = start & 31
    live = length > 0
    sh0 = 32 - rb - length
    c0 = torch.where(sh0 >= 0, val << sh0.clamp(min=0),
                     val >> (-sh0).clamp(min=0)) & 0xFFFFFFFF
    cross = live & (rb + length > 32)
    c1 = (val << (64 - rb - length).clamp(0, 63)) & 0xFFFFFFFF
    words = torch.zeros((B, cap_words + 1), dtype=torch.int64,
                        device=y.device)
    dump = torch.full_like(w, cap_words)
    words.scatter_add_(1, torch.where(live & (w < cap_words), w, dump),
                       torch.where(live, c0, torch.zeros_like(c0)))
    words.scatter_add_(1, torch.where(cross & (w + 1 < cap_words), w + 1,
                                      dump),
                       torch.where(cross, c1, torch.zeros_like(c1)))
    words = words[:, :cap_words]
    word_bytes = torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)],
                             dim=-1).to(torch.uint8).reshape(B, -1)
    header = torch.stack([total, total_bits], dim=1).to(
        torch.int32).contiguous().view(torch.uint8)
    return torch.cat([header, word_bytes], dim=1)


def huffman_fields_plain(y: torch.Tensor, cb: torch.Tensor,
                         cr: torch.Tensor, spec: torch.Tensor, h16: int,
                         w16: int) -> tuple:
    """The fields of :func:`huffman_pack_plain`'s stream, each tile's
    ``(total nonzeros [B], total bits [B], val, length, start, block
    start)``: ``val``, ``length`` and ``start`` i64[B, F] of every field
    slot (DC, ZRL, run/size, EOB; a slot of length 0 codes nothing), each
    field's bits ``[start, start + length)`` of the tile's stream, and the
    bit start of each block in scan order, i64[B, 6 h16 w16]."""
    B = y.shape[0]
    dev = y.device
    n_mcu = h16 * w16
    nb = 6 * n_mcu
    i64 = torch.int64
    yi = (y.to(i64).reshape(B, h16, 2, w16, 2, 64)
          .permute(0, 1, 3, 2, 4, 5).reshape(B, n_mcu, 4, 64))
    blocks = torch.cat([yi, cb.to(i64).reshape(B, n_mcu, 1, 64),
                        cr.to(i64).reshape(B, n_mcu, 1, 64)], dim=2)
    sp = spec.to(device=dev, dtype=i64)
    dc_code, dc_len = sp[0:256], sp[256:512]
    ac_code, ac_len = sp[512:768], sp[768:1024]
    total = (blocks != 0).sum((1, 2, 3))

    # DC fields: the difference against the component's predecessor.
    d6 = blocks[..., 0]                                    # [B, n_mcu, 6]
    prev_mcu = torch.cat([torch.zeros_like(d6[:, :1]), d6[:, :-1]], dim=1)
    pred = torch.cat([prev_mcu[:, :, 3:4], d6[:, :, 0:3],
                      prev_mcu[:, :, 4:6]], dim=2)
    blocks = blocks.reshape(B, nb, 64)
    dcdiff = (d6 - pred).reshape(B, nb)
    s_dc = _category_t(dcdiff)
    dc_val = (dc_code[s_dc] << s_dc) | _amplitude_t(dcdiff, s_dc)
    dc_flen = dc_len[s_dc] + s_dc

    # AC fields: each nonzero's run from the previous nonzero position.
    ac = blocks[..., 1:]                                   # [B, nb, 63]
    nz = ac != 0
    k = torch.arange(1, 64, dtype=i64, device=dev)
    prev_incl = torch.cummax(torch.where(nz, k, torch.zeros_like(k)),
                             dim=-1).values
    prev = torch.cat([torch.zeros_like(prev_incl[..., :1]),
                      prev_incl[..., :-1]], dim=-1)
    run = k - prev - 1
    s_ac = _category_t(ac)
    sym = ((run & 15) << 4) | s_ac
    zero = torch.zeros_like(ac)
    main_val = torch.where(nz, (ac_code[sym] << s_ac)
                           | _amplitude_t(ac, s_ac), zero)
    main_len = torch.where(nz, ac_len[sym] + s_ac, zero)
    z = torch.where(nz, run >> 4, zero)                    # 0..3 ZRLs
    zc, zl = ac_code[0xF0], ac_len[0xF0]
    two = (zc << zl) | zc
    three = (two << zl) | zc
    zrl_val = torch.where(z == 3, three, torch.where(
        z == 2, two, torch.where(z == 1, zc, zero)))
    zrl_len = z * zl
    has_eob = blocks[..., 63] == 0
    eob_val = torch.where(has_eob, ac_code[0], torch.zeros_like(dc_val))
    eob_len = torch.where(has_eob, ac_len[0], torch.zeros_like(dc_val))

    # Bit offsets: per-coefficient lengths summed within each block, the
    # block lengths summed over the tile in scan order.
    coeff_len = zrl_len + main_len
    within = torch.cumsum(coeff_len, dim=-1)
    block_ac = within[..., -1]
    block_bits = dc_flen + block_ac + eob_len              # [B, nb]
    block_end = torch.cumsum(block_bits, dim=1)
    block_start = block_end - block_bits
    total_bits = block_end[:, -1]
    zrl_start = (block_start + dc_flen)[..., None] + within - coeff_len
    main_start = zrl_start + zrl_len
    eob_start = block_start + dc_flen + block_ac

    val = torch.cat([dc_val, zrl_val.reshape(B, -1),
                     main_val.reshape(B, -1), eob_val], dim=1)
    length = torch.cat([dc_flen, zrl_len.reshape(B, -1),
                        main_len.reshape(B, -1), eob_len], dim=1)
    start = torch.cat([block_start, zrl_start.reshape(B, -1),
                       main_start.reshape(B, -1), eob_start], dim=1)
    return total, total_bits, val, length, start, block_start


def huffman_pack(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 cap_words: int, spec: torch.Tensor, h16: int,
                 w16: int) -> torch.Tensor:
    """K5 dispatcher: :func:`huffman_pack_plain` for a CPU tensor, the
    kernel (``kernels.jpeg.huffman_pack``) for a CUDA tensor."""
    if y.device.type == "cpu":
        return huffman_pack_plain(y, cb, cr, cap_words, spec, h16, w16)
    from ..kernels import jpeg as kernels

    return kernels.huffman_pack(y, cb, cr, cap_words, spec, h16, w16)


def huffman_row_lengths(wire: torch.Tensor, n_valid: int, cap: int,
                        cap_words: int) -> torch.Tensor:
    """Used bytes of each Huffman wire row (``:486-492``): the header and
    ``ceil(bits / 32)`` words; the header alone for a row over ``cap``
    entries or ``32 cap_words`` bits; 0 at or past ``n_valid``."""
    B = wire.shape[0]
    hdr = wire[:, :8].reshape(-1).view(torch.int32).reshape(B, 2).to(
        torch.int64)
    total, bits = hdr[:, 0], hdr[:, 1]
    ok = (total <= cap) & (bits <= cap_words * 32)
    words = torch.where(ok, (bits + 31) // 32, torch.zeros_like(bits))
    lengths = 8 + 4 * words
    keep = torch.arange(B, device=wire.device) < n_valid
    return torch.where(keep, lengths, torch.zeros_like(lengths))


def compact_huffman_rows(wire: torch.Tensor, n_valid: int, cap: int,
                         cap_words: int) -> torch.Tensor:
    """K4b with the Huffman row lengths: :func:`compact_rows_plain` over
    :func:`huffman_row_lengths` on CPU, the kernel on CUDA."""
    if wire.device.type == "cpu":
        return compact_rows_plain(
            wire, huffman_row_lengths(wire, n_valid, cap, cap_words))
    from ..kernels import jpeg as kernels

    return kernels.compact_rows(wire, n_valid, cap, 0, cap_words=cap_words)


def huffman_wire_rows(y, cb, cr, cap: int, cap_words: int,
                      spec: torch.Tensor, n_valid: int, h16: int,
                      w16: int) -> List[np.ndarray]:
    """K5 + K4b on the coefficients' device, then the compacted wire's
    used bytes to the host: the first ``n_valid`` rows."""
    B = y.shape[0]
    wire = huffman_pack(y, cb, cr, cap_words, spec, h16, w16)
    return fetch_rows(compact_huffman_rows(wire, n_valid, cap, cap_words),
                      B)[:n_valid]


def finish_huffman_batch(bufs, dims, H: int, W: int, quality: int,
                         cap: int, cap_words: int,
                         dense_fallback: Optional[Callable] = None,
                         spec=None, on_tile: Optional[Callable] = None
                         ) -> list:
    """Fetched Huffman wire rows -> JFIF per tile (the JAX function).

    Host work is the stream's bytes: byte swap, 0xFF stuffing and the
    frame (``jfif.finish_fixed_stream``, or ``finish_stream_with_spec``
    when ``spec``, a jfif 8-tuple, coded the stream).  A tile over its
    budgets, or whose ``dims`` entry is None, is coded by
    ``dense_fallback(i) -> bytes``."""
    from ..jfif import finish_fixed_stream, finish_stream_with_spec

    out = []
    for i, dim in enumerate(dims):
        row = bufs[i] if dim is not None else None
        if dim is not None:
            total = row_header_i32(row, 0)
            bits = row_header_i32(row, 1)
        if dim is None or total > cap or bits > cap_words * 32:
            if dense_fallback is None:
                raise ValueError(
                    f"tile {i} needs the dense path but no fallback was "
                    f"given" if dim is None else
                    f"huffman wire overflow (entries={total}, bits={bits})")
            out.append(dense_fallback(i))
        else:
            w_, h_ = dim
            nwords = (bits + 31) // 32
            # Compacted rows sit at any byte offset: re-base for the view.
            words = np.ascontiguousarray(row[8:8 + 4 * nwords]).view("<u4")
            out.append(finish_fixed_stream(words, bits, w_, h_, quality)
                       if spec is None else
                       finish_stream_with_spec(words, bits, w_, h_,
                                               quality, spec))
        if on_tile is not None:
            on_tile(i, out[-1])
    return out


# Per-workload tuned tables of the Huffman wire, keyed (H, W, quality):
# ``(spec arrays, jfif 8-tuple)``, or None when tuning failed (never
# retried).  Built once per workload on a background thread from one
# tile's coefficients; groups code with the fixed spec until then.  The
# spec is runtime data of K5, so the switch costs no rebuild.
_TUNED_TABLES: dict = {}
_TUNED_PENDING: set = set()
_TUNED_LOCK = threading.Lock()


def _compute_tuned_tables(key, sample) -> None:
    """Build and publish the tuned spec of ``key`` from ``sample``, one
    tile's (y, cb, cr) on the host; a failure publishes None."""
    from ..jfif import symbol_frequencies, tuned_huffman_spec
    try:
        spec8 = tuned_huffman_spec(*symbol_frequencies(*sample))
        result = (spec_kernel_arrays(spec8), spec8)
    except Exception:       # pragma: no cover - tuning never breaks serving
        result = None
    with _TUNED_LOCK:
        _TUNED_TABLES[key] = result
        _TUNED_PENDING.discard(key)


def _maybe_start_tuning(key, sample_fn: Callable) -> None:
    """Start tuning ``key`` once.  ``sample_fn() -> (y, cb, cr)`` numpy
    runs here, on the caller's thread and stream (the coefficients' copy
    to the host); the frequency count and table build run on a thread."""
    with _TUNED_LOCK:
        if key in _TUNED_TABLES or key in _TUNED_PENDING:
            return
        _TUNED_PENDING.add(key)
    try:
        sample = sample_fn()
    except Exception:       # pragma: no cover - as _compute_tuned_tables
        with _TUNED_LOCK:
            _TUNED_TABLES[key] = None
            _TUNED_PENDING.discard(key)
        return
    threading.Thread(target=_compute_tuned_tables, args=(key, sample),
                     name=f"hufftune-{key[0]}x{key[1]}", daemon=True).start()


def _huffman_to_jpegs(y, cb, cr, H: int, W: int, quality: int, dims,
                      cap: int, on_tile: Optional[Callable],
                      tune: bool) -> list:
    """The Huffman engine over coefficients on an exact (H, W) frame: the
    workload's tuned spec when ready (else the fixed one, whose tables the
    frame then declares), the cap policy of :func:`coefficients_to_jpegs`
    for entries and words together, and the dense coder for a tile still
    over its budgets."""
    n = len(dims)
    tuned = _TUNED_TABLES.get((H, W, quality))
    if tuned is not None:
        spec_arrays, frame_spec = tuned
    else:
        spec_arrays, frame_spec = huffman_spec_arrays(), None
    spec = spec_tensor(spec_arrays, y.device)
    cap_words = default_words_cap(H, W, quality)
    memo_key = ("huffman", H, W, quality)
    if _CAP_MEMO.get(memo_key):
        cap, cap_words = cap * 2, cap_words * 2
    h16, w16 = H // 16, W // 16
    rows = huffman_wire_rows(y, cb, cr, cap, cap_words, spec, n, h16, w16)
    totals = np.array([row_header_i32(r, 0) for r in rows])
    bits = np.array([row_header_i32(r, 1) for r in rows])
    over = (totals > cap) | (bits > cap_words * 32)
    rescuable = (totals <= 2 * cap) & (bits <= 2 * cap_words * 32)
    if memo_key not in _CAP_MEMO and (over & rescuable).any():
        # One retry of the whole batch at doubled budgets, and later
        # groups of the workload start there.
        _CAP_MEMO[memo_key] = True
        cap, cap_words = cap * 2, cap_words * 2
        rows = huffman_wire_rows(y, cb, cr, cap, cap_words, spec, n, h16,
                                 w16)

    def dense_tile(i):
        w_, h_ = dims[i]
        return native.jpeg_encode(y[i].cpu().numpy(), cb[i].cpu().numpy(),
                                  cr[i].cpu().numpy(), w_, h_, quality)

    if tuned is None and tune:
        _maybe_start_tuning((H, W, quality), lambda: (
            y[0].cpu().numpy(), cb[0].cpu().numpy(), cr[0].cpu().numpy()))
    with stopwatch("jfif.encodeBatch"):
        return finish_huffman_batch(rows, dims, H, W, quality, cap,
                                    cap_words, dense_fallback=dense_tile,
                                    spec=frame_spec, on_tile=on_tile)


def coefficients_to_jpegs(y, cb, cr, H: int, W: int, quality: int,
                          dims: Sequence[Tuple[int, int]],
                          cap: Optional[int] = None,
                          on_tile: Optional[Callable] = None,
                          engine: str = "sparse", tune: bool = True) -> list:
    """Coefficients of B tiles on an (H, W) frame -> JFIF for the first
    ``len(dims)`` of them through the ``engine``'s wire ("sparse" or
    "huffman"), its cap policy included.

    The wire starts at ``cap`` (default :func:`default_sparse_cap`; the
    Huffman engine also at :func:`default_words_cap` words; twice those
    once the workload's memo is set).  When a tile overflows and would fit
    in twice the budget, the whole batch is packed once more at the
    doubled budget and the memo set.  A tile still over it is coded from
    its dense coefficients, which stay on the device until then.  The
    Huffman engine serves only a group whose tiles are all grid-exact
    (their ceil-16 frame is (H, W)); any other takes the sparse engine.
    ``tune=False`` never starts the workload's table tuning.  ``on_tile``
    is called with each tile's bytes as soon as they exist.
    """
    n = len(dims)
    if cap is None:
        cap = default_sparse_cap(H, W, quality)
    if engine not in ("sparse", "huffman"):
        raise ValueError(f"jpeg engine must be 'sparse' or 'huffman', "
                         f"got {engine!r}")
    all_exact = all((h_ + 15) // 16 * 16 == H and (w_ + 15) // 16 * 16 == W
                    for (w_, h_) in dims)
    if engine == "huffman" and all_exact:
        return _huffman_to_jpegs(y, cb, cr, H, W, quality, dims, cap,
                                 on_tile, tune)
    memo_key = ("sparse", H, W, quality)
    if _CAP_MEMO.get(memo_key):
        cap = cap * 2
    rows = wire_rows(y, cb, cr, cap, n)
    totals = np.array([row_header_i32(r, 0) for r in rows])
    if (memo_key not in _CAP_MEMO
            and ((totals > cap) & (totals <= 2 * cap)).any()):
        _CAP_MEMO[memo_key] = True
        cap = cap * 2
        rows = wire_rows(y, cb, cr, cap, n)

    def dense_coefficients(i):
        return (y[i].cpu().numpy(), cb[i].cpu().numpy(),
                cr[i].cpu().numpy())

    with stopwatch("jfif.encodeBatch"):
        return finish_sparse_to_jpegs(rows, dims, H, W, quality, cap,
                                      dense_coefficients, on_tile)


def render_batch_to_jpeg(raw, window_start, window_end, family, coefficient,
                         reverse, cd_start, cd_end, tables, quality: int,
                         dims, cap: Optional[int] = None,
                         on_tile: Optional[Callable] = None,
                         engine: str = "sparse", tune: bool = True) -> list:
    """One batch of tiles -> JFIF per tile, on raw's device.

    ``raw`` is [B, C, H, W] with H, W multiples of 16 (callers edge-pad:
    the render is pointwise, so padding commutes with it) and per-tile
    settings stacked along B, as ``ops.render.render_tile_batch_packed``
    takes them.  ``dims`` gives the true ``(width, height)`` of each of
    the first ``len(dims)`` tiles for its SOF0 header; rows past them are
    batch padding and cost no wire bytes.  ``on_tile(i, data)`` is called
    with each tile's bytes as soon as they are coded.  ``engine`` and
    ``tune`` are :func:`coefficients_to_jpegs`'s.  The JAX package's
    ``render_batch_to_jpeg`` with the same engine (and the same tuned
    tables) gives the same bytes.
    """
    from .render import render_tile_batch_packed

    B, C, H, W = raw.shape
    if H % 16 or W % 16:
        raise ValueError(f"raw frame ({H}, {W}) is not a multiple of 16")
    packed = render_tile_batch_packed(raw, window_start, window_end, family,
                                      coefficient, reverse, cd_start,
                                      cd_end, tables)
    y, cb, cr = packed_to_jpeg_coefficients(packed, quality)
    return coefficients_to_jpegs(y, cb, cr, H, W, quality, dims, cap,
                                 on_tile, engine, tune)


def pad_planes_to_mcu(raw, target_h: Optional[int] = None,
                      target_w: Optional[int] = None, flip_h: bool = False,
                      flip_v: bool = False, out: Optional[np.ndarray] = None):
    """Edge-replicate [C, h, w] planes to a 16-aligned (target_h, target_w)
    frame (default: the planes' own ceil-16 frame), the planes first
    mirrored by ``flip_h`` / ``flip_v``.

    The render is pointwise, so padding the raw and rendering equals
    rendering and replicating the image's edge; replication (not zeros)
    keeps the padding out of the edge blocks' DCT energy.  Mirroring first
    puts the padding at the bottom and right of the flipped tile, where
    its SOF0 crop drops it.  A numpy array is padded on the host (into
    ``out`` when given); a tensor by one gather on its device with
    clamped, mirrored indices (uint16 in its int16 view).
    """
    h, w = raw.shape[-2:]
    th = target_h if target_h is not None else h + (-h) % 16
    tw = target_w if target_w is not None else w + (-w) % 16
    if th % 16 or tw % 16 or th < h or tw < w:
        raise ValueError(f"bad MCU pad target ({th}, {tw}) for ({h}, {w})")
    if isinstance(raw, np.ndarray):
        if flip_v:
            raw = raw[:, ::-1, :]
        if flip_h:
            raw = raw[:, :, ::-1]
        if out is None:
            if (th, tw) == (h, w):
                return raw
            out = np.empty(raw.shape[:-2] + (th, tw), raw.dtype)
        out[:, :h, :w] = raw
        out[:, :h, w:] = out[:, :h, w - 1:w]
        out[:, h:, :] = out[:, h - 1:h, :]
        return out
    if (th, tw) == (h, w) and not (flip_h or flip_v):
        return raw
    rows = _frame_index(h, th, flip_v, raw.device)
    cols = _frame_index(w, tw, flip_h, raw.device)
    src = raw.view(torch.int16) if raw.dtype == torch.uint16 else raw
    padded = src[:, rows[:, None], cols[None, :]]
    return padded.view(torch.uint16) if raw.dtype == torch.uint16 else padded


# ------------------------------------------- K6: the bitpack engine

@functools.lru_cache(maxsize=16)
def _mcu_scan_index(h16: int, w16: int) -> np.ndarray:
    """[n_mcu, 6] flat block indices (into [Y|Cb|Cr] raster blocks) in
    interleaved MCU scan order: 2x2 Y, then Cb, then Cr (T.81 A.2.3)."""
    nb_y = h16 * w16 * 4
    yw = w16 * 2
    my, mx = np.divmod(np.arange(h16 * w16), w16)
    idx = np.stack([
        (2 * my) * yw + 2 * mx, (2 * my) * yw + 2 * mx + 1,
        (2 * my + 1) * yw + 2 * mx, (2 * my + 1) * yw + 2 * mx + 1,
        nb_y + my * w16 + mx,
        nb_y + h16 * w16 + my * w16 + mx,
    ], axis=1)
    return idx.astype(np.int32)


def scan_index_tensor(h16: int, w16: int, device) -> torch.Tensor:
    """:func:`_mcu_scan_index` as i32[n_mcu, 6] on ``device`` (cached)."""
    return _scan_index_tensor(h16, w16, str(torch.device(device)))


@functools.lru_cache(maxsize=16)
def _scan_index_tensor(h16: int, w16: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_mcu_scan_index(h16, w16)).to(device)


def bitpack_fixed_plain(blocks: torch.Tensor, scan_idx, dc_code, dc_len,
                        ac_code, ac_len, cap_words: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K6, the tensor twin of the JAX ``_bitpack_fixed``
    (``ops/jpegenc.py:833``) over a batch: zigzag coefficients i16[B, nb,
    64] ([Y|Cb|Cr] raster blocks) -> ``(words, total_bits)``, the u32
    words of each tile's Huffman stream as i32[B, cap_words] (bit 0 of the
    stream is the MSB of word 0) and its full length in bits, i32[B].

    The fields in stream order, each block in MCU scan order
    (``scan_idx``, :func:`_mcu_scan_index`): the DC difference along its
    component's chain (Y over the four slots of each MCU in turn, Cb and
    Cr over the MCUs), then per AC coefficient the ZRL pair f0 (two ZRL
    codes as one field), the third ZRL f1 and the coefficient's run/size
    code and amplitude f2, then the EOB unless position 63 is nonzero.
    One exclusive cumsum turns the lengths into bit starts, and one int64
    ``index_add_`` deposits every field into at most two words: fields own
    disjoint bits, so add is or, as in JAX.  The arithmetic is JAX's int32
    arithmetic in int64 (the same low 32 bits), so a category-11 clamp
    (a DC difference of 2048 or more) packs the same words as JAX.  Words
    at or past ``cap_words`` are dropped; ``total_bits`` is always the
    whole stream's."""
    B = blocks.shape[0]
    dev = blocks.device
    i64 = torch.int64
    sidx = torch.as_tensor(scan_idx).to(device=dev, dtype=i64)
    dc_code, dc_len, ac_code, ac_len = (
        torch.as_tensor(np.asarray(a)).to(device=dev, dtype=i64)
        for a in (dc_code, dc_len, ac_code, ac_len))
    v = blocks.to(i64)[:, sidx]                       # [B, n_mcu, 6, 64]
    n_mcu = v.shape[1]

    # DC difference chains, one per component.
    dc = v[..., 0]

    def chain(x):
        flat = x.reshape(B, -1)
        prev = torch.cat([torch.zeros_like(flat[:, :1]), flat[:, :-1]],
                         dim=1)
        return (flat - prev).reshape(x.shape)
    dcdiff = torch.cat([chain(dc[..., :4]), chain(dc[..., 4:5]),
                        chain(dc[..., 5:6])], dim=2)
    s_dc = _category_t(dcdiff)
    dc_f_val = (dc_code[s_dc] << s_dc) | _amplitude_t(dcdiff, s_dc)
    dc_f_len = dc_len[s_dc] + s_dc

    # AC run-lengths from the gap to the previous nonzero position.
    ac = v[..., 1:]                                   # [B, n_mcu, 6, 63]
    nz = ac != 0
    k = torch.arange(1, 64, dtype=i64, device=dev)
    zero = torch.zeros_like(ac)
    prev_incl = torch.cummax(torch.where(nz, k, zero), dim=-1).values
    prev = torch.cat([torch.zeros_like(prev_incl[..., :1]),
                      prev_incl[..., :-1]], dim=-1)
    run = k - prev - 1
    z = torch.where(nz, run >> 4, zero)
    s_ac = _category_t(ac)
    sym = ((run & 15) << 4) | s_ac
    f2_val = torch.where(nz, (ac_code[sym] << s_ac)
                         | _amplitude_t(ac, s_ac), zero)
    f2_len = torch.where(nz, ac_len[sym] + s_ac, zero)
    zc, zl = ac_code[0xF0], ac_len[0xF0]              # ZRL
    f0_len = torch.clamp(z, max=2) * zl
    f0_val = torch.where(z >= 2, (zc << zl) | zc,
                         torch.where(z == 1, zc, zero))
    f1_len = torch.where(z >= 3, zl, zero)
    f1_val = torch.where(z >= 3, zc, zero)
    has_eob = prev_incl[..., -1] < 63
    eob_val = torch.where(has_eob, ac_code[0], torch.zeros_like(dc_f_val))
    eob_len = torch.where(has_eob, ac_len[0], torch.zeros_like(dc_f_len))

    # Stream offsets: [dc | (f0 f1 f2) per coefficient | eob] per block,
    # blocks in scan order.
    coeff_len = f0_len + f1_len + f2_len
    within = torch.cumsum(coeff_len, dim=-1)
    block_ac_bits = within[..., -1]
    block_bits = dc_f_len + block_ac_bits + eob_len   # [B, n_mcu, 6]
    block_end = torch.cumsum(block_bits.reshape(B, -1), dim=1).reshape(
        B, n_mcu, 6)
    block_start = block_end - block_bits
    total_bits = block_end.reshape(B, -1)[:, -1]
    f0_start = (block_start + dc_f_len)[..., None] + (within - coeff_len)
    f1_start = f0_start + f0_len
    f2_start = f1_start + f1_len
    eob_start = block_start + dc_f_len + block_ac_bits

    val = torch.cat([a.reshape(B, -1) for a in (
        dc_f_val, f0_val, f1_val, f2_val, eob_val)], dim=1)
    length = torch.cat([a.reshape(B, -1) for a in (
        dc_f_len, f0_len, f1_len, f2_len, eob_len)], dim=1)
    start = torch.cat([a.reshape(B, -1) for a in (
        block_start, f0_start, f1_start, f2_start, eob_start)], dim=1)
    w = start >> 5
    r = start & 31
    sh0 = 32 - r - length                     # in [-30, 32]
    c0 = torch.where(sh0 >= 0, val << sh0.clamp(0, 31),
                     val >> (-sh0).clamp(0, 31))
    sh1 = 64 - r - length                     # in [2, 64]
    c1 = torch.where(sh1 < 32, val << (sh1.clamp(min=0) & 31),
                     torch.zeros_like(val))
    live = length > 0
    c0 = torch.where(live, c0, torch.zeros_like(c0))
    c1 = torch.where(live, c1, torch.zeros_like(c1))
    # One flat deposit over the batch; slot cap_words of each row takes
    # the dropped words.
    row = (torch.arange(B, device=dev, dtype=i64) * (cap_words + 1))[:, None]
    words = torch.zeros(B * (cap_words + 1), dtype=i64, device=dev)
    dump = torch.full_like(w, cap_words)
    words.index_add_(0, (row + torch.where(w < cap_words, w, dump))
                     .reshape(-1), c0.reshape(-1))
    words.index_add_(0, (row + torch.where(w + 1 < cap_words, w + 1, dump))
                     .reshape(-1), c1.reshape(-1))
    words = words.reshape(B, cap_words + 1)[:, :cap_words] & 0xFFFFFFFF
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32), total_bits.to(torch.int32)


def bitpack_fixed(blocks: torch.Tensor, scan_idx, dc_code, dc_len,
                  ac_code, ac_len, cap_words: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 dispatcher: :func:`bitpack_fixed_plain` for a CPU tensor, the
    kernel (``kernels.jpeg.bitpack_fixed``) for a CUDA tensor, with
    ``scan_idx`` (best :func:`scan_index_tensor`, already on the card) and
    the code arrays as the card's i32 blocks."""
    if blocks.device.type == "cpu":
        return bitpack_fixed_plain(blocks, scan_idx, dc_code, dc_len,
                                   ac_code, ac_len, cap_words)
    from ..kernels import jpeg as kernels

    idx = torch.as_tensor(scan_idx).to(device=blocks.device,
                                       dtype=torch.int32)
    spec = spec_tensor((dc_code, dc_len, ac_code, ac_len), blocks.device)
    return kernels.bitpack_fixed(blocks, idx, spec, cap_words)


def render_to_jpeg_bits(raw, window_start, window_end, family, coefficient,
                        reverse, cd_start, cd_end, tables, quality: int,
                        cap_words: int, flip_h: bool = False,
                        flip_v: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``render_to_jpeg_bits`` (``:948``) on raw's device: K1 (or
    K2), K3 and K6, raw [B, C, H, W] (H, W multiples of 16) to each
    tile's fixed-table Huffman stream, ``(words i32[B, cap_words],
    total_bits i32[B])``.  ``flip_h``/``flip_v`` mirror every tile in
    K3's reads."""
    from .render import render_tile_batch_packed

    B, C, H, W = raw.shape
    if H % 16 or W % 16:
        raise ValueError(f"raw frame ({H}, {W}) is not a multiple of 16")
    packed = render_tile_batch_packed(raw, window_start, window_end, family,
                                      coefficient, reverse, cd_start,
                                      cd_end, tables)
    y, cb, cr = packed_to_jpeg_coefficients(packed, quality, H, W, flip_h,
                                            flip_v)
    return bits_from_coefficients(y, cb, cr, H, W, cap_words)


def bits_from_coefficients(y, cb, cr, H: int, W: int, cap_words: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 over K3's coefficients of an (H, W) frame with the fixed
    tables: the blocks joined as [Y|Cb|Cr] on their device, then the
    bit pack."""
    B = y.shape[0]
    blocks = torch.cat([y.reshape(B, -1, 64), cb.reshape(B, -1, 64),
                        cr.reshape(B, -1, 64)], dim=1)
    return bitpack_fixed(blocks, scan_index_tensor(H // 16, W // 16,
                                                   blocks.device),
                         *huffman_spec_arrays(), cap_words)


class BitpackJpegEncoder:
    """The host side of the bitpack engine at one tile shape: the port's
    counterpart of the JAX ``TpuJpegEncoder`` (``ops/jpegenc.py:1307``).

    Holds the per-shape constants (the MCU scan map, the fixed Huffman
    tables, the quality and the stream capacity, ``(H*W)//4 *
    _quality_widen(q) // 4`` words unless ``cap_bytes`` is given) and
    finishes fetched streams into JFIF files with
    ``jfif.finish_fixed_stream``; a tile whose stream overflows the
    capacity goes to ``dense_fallback(i)``."""

    def __init__(self, H: int, W: int, quality: int = 85,
                 cap_bytes: Optional[int] = None):
        if H % 16 or W % 16:
            raise ValueError("tile shape must be MCU (16) aligned")
        self.H, self.W, self.quality = H, W, quality
        self.cap_words = (cap_bytes or
                          (H * W) // 4 * _quality_widen(quality)) // 4

    def bits(self, y, cb, cr) -> Tuple[torch.Tensor, torch.Tensor]:
        """K6 over coefficients of this shape on their device."""
        return bits_from_coefficients(y, cb, cr, self.H, self.W,
                                      self.cap_words)

    def render_batch(self, raw, *settings_args, flip_h: bool = False,
                     flip_v: bool = False):
        """K1, K3 and K6 on raw's device; ``(words, total_bits)``."""
        return render_to_jpeg_bits(raw, *settings_args, self.quality,
                                   self.cap_words, flip_h, flip_v)

    def finish_batch(self, words, bits, dense_fallback=None) -> list:
        """Stream words (host or device) -> JFIF bytes per tile."""
        from ..jfif import finish_fixed_stream
        words = (words.cpu().numpy() if isinstance(words, torch.Tensor)
                 else np.asarray(words)).view(np.uint32)
        bits = (bits.cpu().numpy() if isinstance(bits, torch.Tensor)
                else np.asarray(bits))
        out = []
        for i in range(words.shape[0]):
            if bits[i] > self.cap_words * 32:
                if dense_fallback is None:
                    raise ValueError(
                        f"stream overflow: {bits[i]} bits > cap")
                out.append(dense_fallback(i))
            else:
                out.append(finish_fixed_stream(words[i], int(bits[i]),
                                               self.W, self.H,
                                               self.quality))
        return out

    def encode_batch(self, raw, *settings_args, dense_fallback=None,
                     flip_h: bool = False, flip_v: bool = False) -> list:
        return self.finish_batch(
            *self.render_batch(raw, *settings_args, flip_h=flip_h,
                               flip_v=flip_v),
            dense_fallback=dense_fallback)
