"""K10, the packed staging's device decode: build, load, launch.

:func:`unpack16` replaces the JAX package's ``io/staging.py::
unpack16_device`` (``:53``): bit-packed zigzag row deltas
(``native/wirepack.cpp``'s layout) back to uint16 rows on the card.  The
kernel lives in ``csrc/staging.cu`` behind a plain ``extern "C"``
interface, built with nvcc for ``sm_90a`` by :mod:`.build` on first use; a
failed build raises.  The wrapper takes CUDA tensors only, checks them,
launches once on the current stream, raises if the launch was refused, and
counts one launch in :data:`LAUNCHES` per call.  The plain version is
``io.staging.unpack16_plain``; ``io.staging.unpack16`` sends CPU tensors
there and CUDA tensors here.

The kernel finds each tile's first word by a decoupled look-back over a
status scratch of one uint64 a tile (:func:`.scratch.status_scratch`, one
per device and stream, shared with K6): each call tags its words with a
new epoch, so the scratch needs no clearing between calls.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from . import build
from .scratch import status_scratch

SOURCE = build.CSRC / "staging.cu"
NVCC_FLAGS = build.ARCH_FLAGS

LAUNCHES: Dict[str, int] = {"unpack16": 0}
_launch_lock = threading.Lock()

# Offsets count words in 32 bits: the words array stays under this.
MAX_WORDS = 1 << 32


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _configure(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.unpack16_launch.argtypes = [p, ll, p, ll, i, i, ll, ll, p, p,
                                    ctypes.c_ulonglong, p]
    lib.unpack16_launch.restype = ctypes.c_int
    lib.unpack16_tile_rows.argtypes = []
    lib.unpack16_tile_rows.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return build.load(SOURCE, NVCC_FLAGS, _configure)


def tile_count(n_words: int, n_rows: int, tile_rows: int) -> int:
    """The CTAs (tiles of ``tile_rows`` rows) of a launch over ``n_rows``
    rows; refuses ``n_words`` of 2**32 or more (the kernel's offsets are
    32-bit; ``io.staging``'s sample gate keeps staged arrays far below)."""
    if n_words >= MAX_WORDS:
        raise ValueError(f"unpack16: {n_words} words pass the kernel's "
                         f"32-bit word offsets (at most {MAX_WORDS - 1})")
    return -(-n_rows // tile_rows)


def unpack16(words: torch.Tensor, widths: torch.Tensor,
             out: torch.Tensor) -> torch.Tensor:
    """K10: decode ``words`` (int32 or uint32 [n], the packer's u32
    words) and ``widths`` (u8 [rows * ceil(W / 32)]) into ``out``, an int16
    or uint16 tensor of the packed array's shape [..., h, W] whose last dim
    is contiguous: it may be a view of rows of a larger tensor (a band of
    a [C, H, W] stack), written in place.  Returns ``out``."""
    dev = out.device
    for name, t in (("words", words), ("widths", widths), ("out", out)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError("unpack16 runs on CUDA tensors only; the "
                             "plain version is io.staging.unpack16_plain")
        if t.device != dev:
            raise ValueError(f"unpack16: {name} on {t.device}, out on "
                             f"{dev}")
    if words.dtype not in (torch.int32, torch.uint32) or words.dim() != 1 \
            or not words.is_contiguous():
        raise ValueError(f"words must be contiguous 32-bit [n], got "
                         f"{words.dtype} {tuple(words.shape)}")
    if out.dtype not in (torch.int16, torch.uint16) or out.dim() < 2:
        raise ValueError(f"out must be 16-bit [..., h, W], got "
                         f"{out.dtype} {tuple(out.shape)}")
    h, W = out.shape[-2], out.shape[-1]
    planes = out.view(-1, h, W) if out.dim() != 3 else out
    if W and planes.stride(2) != 1:
        raise ValueError("unpack16: out rows must be contiguous")
    n_rows = planes.shape[0] * h
    bpr = (W + 31) // 32
    if widths.dtype != torch.uint8 or widths.dim() != 1 \
            or not widths.is_contiguous() or widths.numel() != n_rows * bpr:
        raise ValueError(f"widths must be contiguous u8[{n_rows * bpr}], "
                         f"got {widths.dtype} {tuple(widths.shape)}")
    if n_rows == 0 or W == 0:
        return out
    if h >= 1 << 31 or W >= 1 << 31:
        raise ValueError(f"unpack16: {h} rows of {W} exceed the kernel's "
                         f"32-bit row index")
    lib = library()
    tiles = tile_count(words.numel(), n_rows, lib.unpack16_tile_rows())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status, epoch = status_scratch(dev, stream, tiles)
        err = lib.unpack16_launch(
            words.data_ptr(), words.numel(), widths.data_ptr(), n_rows, W,
            h, planes.stride(0), planes.stride(1), planes.data_ptr(),
            status.data_ptr(), epoch, stream)
    if err != 0:
        raise RuntimeError(f"unpack16 launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES["unpack16"] += 1
    return out
