"""Hand-written CUDA kernels of the JPEG route: build, load, launch.

Counterparts of the stages of the JAX package's device program
``render_to_jpeg_sparse_compact`` (``ops/jpegenc.py:443``):

* :func:`jpeg_coefficients` (K3) replaces ``packed_to_jpeg_coefficients``
  (``ops/jpegenc.py:110``), with the MCU edge replication and the flips
  folded into its reads;
* :func:`sparse_pack` (K4a) replaces ``sparse_pack`` (``:191``);
* :func:`compact_rows` (K4b) replaces ``_compact_rows`` (``:400``) with the
  row lengths of ``:457-464`` (sparse rows) or ``:486-492`` (Huffman rows);
* :func:`huffman_pack` (K5) replaces ``huffman_pack`` (``:991``), the
  engine of ``render_to_jpeg_huffman_compact`` (``:470``);
* :func:`bitpack_fixed` (K6) replaces ``_bitpack_fixed`` (``:833``), the
  engine of ``render_to_jpeg_bits`` (``:948``) and ``TpuJpegEncoder``
  (``:1307``): the direct renderer's ``bitpack`` engine.

All five live in ``csrc/jpeg.cu`` behind a plain ``extern "C"`` interface,
built and loaded by :mod:`.build` on first use; a build failure raises.
Each wrapper takes CUDA tensors only, checks them, allocates its outputs
(and K4a's and K5's status words) with ``torch.empty``, launches on the
current stream, raises if a launch was refused, and counts one launch in
:data:`LAUNCHES` per call.  K6 takes its status words from the scratch
that it shares with K10 (:func:`.scratch.status_scratch`, an epoch a
call), so it is one launch with no memset.
The plain PyTorch versions are in ``ops/jpegenc.py``, whose dispatchers
send CPU tensors there and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from . import build
from .scratch import status_scratch

SOURCE = build.CSRC / "jpeg.cu"
# No contraction into FMAs: K3 rounds each product and sum as its plain
# version does.
NVCC_FLAGS = build.ARCH_FLAGS + ("-fmad=false",)
ENTRY_BITS = 18
# K5's chunk: the coefficient blocks one CTA codes (csrc/jpeg.cu
# kHuffBlocks).
HUFF_CHUNK_BLOCKS = 128
# K6's chunk (csrc/jpeg.cu kBitBlocks).
BIT_CHUNK_BLOCKS = 128

LAUNCHES: Dict[str, int] = {"jpeg_coefficients": 0, "sparse_pack": 0,
                            "compact_rows": 0, "huffman_pack": 0,
                            "bitpack_fixed": 0}
# K4b's row modes (csrc/jpeg.cu kSparseRows, kHuffmanRows).
SPARSE_ROWS, HUFFMAN_ROWS = 0, 1
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _configure(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jpeg_coefficients_launch.argtypes = [p, i, i, i, i, i, i, i,
                                             p, p, p, p, p]
    lib.sparse_pack_launch.argtypes = [p, p, p, i, ll, ll, i, p, ll, ll, p]
    lib.sparse_pack_status_words.argtypes = [i, ll]
    lib.sparse_pack_status_words.restype = ll
    lib.compact_rows_launch.argtypes = [p, i, ll, i, i, ll, i, ll, p, p]
    lib.huffman_pack_launch.argtypes = [p, p, p, i, i, i, p, ll, p, ll, p]
    lib.huffman_pack_status_words.argtypes = [i, ll]
    lib.huffman_pack_status_words.restype = ll
    lib.bitpack_fixed_launch.argtypes = [p, i, ll, p, p, ll, p, p, p, ll,
                                         ctypes.c_ulonglong, p]
    lib.bitpack_fixed_status_words.argtypes = [i, ll]
    lib.bitpack_fixed_status_words.restype = ll
    for fn in (lib.jpeg_coefficients_launch, lib.sparse_pack_launch,
               lib.compact_rows_launch, lib.huffman_pack_launch,
               lib.bitpack_fixed_launch):
        fn.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return build.load(SOURCE, NVCC_FLAGS, _configure)


def _cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} runs on CUDA tensors only; the plain "
                             f"version is in ops.jpegenc")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)


def jpeg_coefficients(packed: torch.Tensor, tables: torch.Tensor,
                      grid_h: int, grid_w: int, flip_h: bool = False,
                      flip_v: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: packed i32[B, h, w] RGBA -> zigzag coefficients of the
    (grid_h, grid_w) frame (multiples of 16, at least (h, w)): ``y``
    i16[B, grid_h*grid_w/64, 64], ``cb``/``cr`` i16[B, grid_h*grid_w/256,
    64].  Pixels past (h, w) replicate the edge; ``flip_h``/``flip_v``
    mirror the tile first.  ``tables`` is the f32[192] table block of
    ``ops.jpegenc.device_tables``."""
    dev = _cuda("jpeg_coefficients", packed, tables)
    if packed.dtype != torch.int32 or packed.dim() != 3:
        raise ValueError(f"packed must be i32[B, h, w], got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if tables.dtype != torch.float32 or tables.numel() != 192:
        raise ValueError("tables must be f32[192]")
    B, h, w = packed.shape
    if (grid_h % 16 or grid_w % 16 or grid_h < h or grid_w < w
            or h < 1 or w < 1):
        raise ValueError(f"bad MCU grid ({grid_h}, {grid_w}) for ({h}, {w})")
    mh, mw = grid_h // 16, grid_w // 16
    y = torch.empty((B, 4 * mh * mw, 64), dtype=torch.int16, device=dev)
    cb = torch.empty((B, mh * mw, 64), dtype=torch.int16, device=dev)
    cr = torch.empty_like(cb)
    if B == 0:
        return y, cb, cr
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.jpeg_coefficients_launch(
            packed.data_ptr(), B, h, w, mh, mw, int(flip_h), int(flip_v),
            tables.data_ptr(), y.data_ptr(), cb.data_ptr(), cr.data_ptr(),
            stream)
    _launched("jpeg_coefficients", err)
    return y, cb, cr


def sparse_pack(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                cap: int) -> torch.Tensor:
    """K4a: coefficients -> u8[B, 4 + nb + ceil(18 cap / 8)] sparse wire
    (``ops.jpegenc.sparse_pack_plain`` is the same function).  One memset
    and one kernel launch; the wire is a view of a buffer that also holds
    the scan's status words."""
    dev = _cuda("sparse_pack", y, cb, cr)
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.dtype != torch.int16 or t.dim() != 3 or t.shape[2] != 64:
            raise ValueError(f"{name} must be i16[B, n, 64], got "
                             f"{t.dtype} {tuple(t.shape)}")
    B, nby = y.shape[:2]
    nbc = cb.shape[1]
    if cb.shape != cr.shape or cb.shape[0] != B:
        raise ValueError("cb and cr must match each other and y's batch")
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    nb = nby + 2 * nbc
    if nb * 64 >= 2 ** 31:
        raise ValueError(f"{nb} blocks a tile overflow the i32 total")
    width = 4 + nb + (ENTRY_BITS * cap + 7) // 8
    if B == 0:
        return torch.empty((B, width), dtype=torch.uint8, device=dev)
    lib = library()
    words = lib.sparse_pack_status_words(B, nb)
    wire_bytes = (B * width + 7) // 8 * 8
    buf = torch.empty((wire_bytes + 8 * words,), dtype=torch.uint8,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sparse_pack_launch(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), B, nby, nbc, cap,
            buf.data_ptr(), width, words, stream)
    _launched("sparse_pack", err)
    return buf[:B * width].view(B, width)


def compact_rows(wire: torch.Tensor, n_valid: int, cap: int,
                 nb: int, cap_words: Optional[int] = None) -> torch.Tensor:
    """K4b: wire u8[B, width] -> u8[4B + B*width]: the i32 LE row
    lengths, then each row's used prefix (rows at or past ``n_valid``
    take none), then zeros.  Sparse rows (``nb`` blocks a tile) without
    ``cap_words``; Huffman rows (``ops.jpegenc.huffman_row_lengths``)
    with it.  One kernel launch, no scratch."""
    dev = _cuda("compact_rows", wire)
    if wire.dtype != torch.uint8 or wire.dim() != 2:
        raise ValueError(f"wire must be u8[B, width], got {wire.dtype} "
                         f"{tuple(wire.shape)}")
    B, width = wire.shape
    mode = SPARSE_ROWS if cap_words is None else HUFFMAN_ROWS
    if mode == SPARSE_ROWS and width < 4 + nb:
        raise ValueError(f"wire rows of {width} bytes hold no {nb} counts")
    if mode == HUFFMAN_ROWS and width != 8 + 4 * cap_words:
        raise ValueError(f"Huffman rows of {width} bytes are not "
                         f"8 + 4 x {cap_words}")
    out = torch.empty((4 * B + B * width,), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.compact_rows_launch(
            wire.data_ptr(), B, width, int(n_valid), cap, nb, mode,
            cap_words or 0, out.data_ptr(), stream)
    _launched("compact_rows", err)
    return out


def huffman_pack(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 cap_words: int, spec: torch.Tensor, h16: int,
                 w16: int) -> torch.Tensor:
    """K5: zigzag coefficients of B tiles on an (16 h16, 16 w16) frame ->
    u8[B, 8 + 4 cap_words] Huffman wire rows ``[total i32 | total bits
    i32 | words u32[cap_words]]`` coded with ``spec``, the i32[1024]
    block of ``ops.jpegenc.spec_tensor`` (fixed or tuned tables, the same
    build).  ``ops.jpegenc.huffman_pack_plain`` is the same function.
    Within the budgets (total <= cap, bits <= 32 cap_words) a row equals
    the JAX ``huffman_pack``'s; past them only its header is used (total
    and the overflow decision agree; see ``csrc/jpeg.cu``).  One memset
    and one launch on the current stream; the rows are a view of a buffer
    that also holds the chunks' status words (8 bytes a chunk of
    :data:`HUFF_CHUNK_BLOCKS` coefficient blocks)."""
    dev = _cuda("huffman_pack", y, cb, cr, spec)
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.dtype != torch.int16 or t.dim() != 3 or t.shape[2] != 64:
            raise ValueError(f"{name} must be i16[B, n, 64], got "
                             f"{t.dtype} {tuple(t.shape)}")
    B = y.shape[0]
    if (y.shape[1] != 4 * h16 * w16 or cb.shape != (B, h16 * w16, 64)
            or cr.shape != cb.shape):
        raise ValueError(f"coefficients {tuple(y.shape)} / "
                         f"{tuple(cb.shape)} / {tuple(cr.shape)} are not "
                         f"a {h16} x {w16} MCU frame")
    if spec.dtype != torch.int32 or spec.numel() != 1024:
        raise ValueError("spec must be i32[1024]")
    if cap_words < 0:
        raise ValueError(f"cap_words must be >= 0, got {cap_words}")
    width = 8 + 4 * cap_words
    if B == 0:
        return torch.empty((B, width), dtype=torch.uint8, device=dev)
    lib = library()
    words = lib.huffman_pack_status_words(B, h16 * w16)
    rows = (B * width + 7) // 8 * 8
    buf = torch.empty((rows + 8 * words,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.huffman_pack_launch(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), B, h16, w16,
            spec.data_ptr(), cap_words, buf.data_ptr(), words, stream)
    _launched("huffman_pack", err)
    return buf[:B * width].view(B, width)


def bitpack_fixed(blocks: torch.Tensor, scan_idx: torch.Tensor,
                  spec: torch.Tensor, cap_words: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: zigzag coefficients i16[B, nb, 64] ([Y|Cb|Cr] raster blocks)
    -> ``(words, total_bits)``: each tile's fixed-table Huffman stream as
    the bits of u32 words in i32[B, cap_words] (zero past the stream,
    words at or past ``cap_words`` dropped) and its whole length in bits,
    i32[B].  ``scan_idx`` i32[nb / 6, 6] is ``ops.jpegenc._mcu_scan_index``
    on the card, ``spec`` the i32[1024] block of
    ``ops.jpegenc.spec_tensor``.  ``ops.jpegenc.bitpack_fixed_plain`` is
    the same function.  One launch on the current stream and no memset:
    the look-back's status words (one a chunk of :data:`BIT_CHUNK_BLOCKS`
    blocks) live in the stream's status scratch under a new epoch, and
    the kernel stores every word below the cap itself."""
    dev = _cuda("bitpack_fixed", blocks, scan_idx, spec)
    if blocks.dtype != torch.int16 or blocks.dim() != 3 \
            or blocks.shape[2] != 64:
        raise ValueError(f"blocks must be i16[B, nb, 64], got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    B, nb = blocks.shape[:2]
    if nb < 6 or nb % 6:
        raise ValueError(f"{nb} blocks a tile are no whole MCUs")
    if scan_idx.dtype != torch.int32 or scan_idx.numel() != nb:
        raise ValueError(f"scan_idx must be i32 with {nb} entries")
    if spec.dtype != torch.int32 or spec.numel() != 1024:
        raise ValueError("spec must be i32[1024]")
    if cap_words < 0:
        raise ValueError(f"cap_words must be >= 0, got {cap_words}")
    words = torch.empty((B, cap_words), dtype=torch.int32, device=dev)
    bits = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return words, bits
    lib = library()
    chunks = lib.bitpack_fixed_status_words(B, nb)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status, epoch = status_scratch(dev, stream, chunks)
        err = lib.bitpack_fixed_launch(
            blocks.data_ptr(), B, nb, scan_idx.data_ptr(), spec.data_ptr(),
            cap_words, words.data_ptr(), bits.data_ptr(), status.data_ptr(),
            status.numel(), epoch, stream)
    _launched("bitpack_fixed", err)
    return words, bits
