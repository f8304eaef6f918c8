"""Hand-written CUDA render kernels for Hopper: build, load, launch.

Counterparts of the two Pallas TPU kernels in the JAX package's
``experimental/pallas_render.py``:

* :func:`render_ramp` replaces ``_render_kernel_ramp`` (``pallas_call`` at
  ``pallas_render.py:226``): every render with no LUT channel.
* :func:`render_lut` replaces ``_render_kernel_lut`` (``pallas_call`` at
  ``pallas_render.py:256``): renders where a channel resolves a ``.lut``.

Both live in ``csrc/render.cu`` behind a plain ``extern "C"`` interface,
built and loaded by :mod:`.build` on first use; a build failure raises.
Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on the current CUDA stream, raises if
the launch was refused, and counts the launch in :data:`LAUNCHES`.

The plain PyTorch version of the same function is
``ops.render.render_tile_batch_packed_plain``; ``ops.render
.render_tile_batch_packed`` sends CPU tensors there and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from . import build

SOURCE = build.CSRC / "render.cu"
NVCC_FLAGS = build.ARCH_FLAGS + (
    # No contraction of a*b+c into an FMA: the composite must round each
    # multiply and add as the reference does.  Never --use_fast_math.
    "-fmad=false",
)

_DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}

# Launches of each kernel since the last reset_launches(); incremented only
# where the kernel is launched.
LAUNCHES: Dict[str, int] = {"render_ramp": 0, "render_lut": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _configure(lib: ctypes.CDLL) -> None:
    args = ([ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    for fn in (lib.render_ramp_launch, lib.render_lut_launch):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.render_max_channels.argtypes = [ctypes.c_int]
    lib.render_max_channels.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return build.load(SOURCE, NVCC_FLAGS, _configure)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, raw is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, raw, window_start, window_end, family, coefficient,
            reverse, table, table_shape, cd_start, cd_end):
    if not isinstance(raw, torch.Tensor) or raw.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors only; the plain "
                         f"version is ops.render."
                         f"render_tile_batch_packed_plain")
    if raw.dim() != 4:
        raise ValueError(f"raw must be [B, C, H, W], got {tuple(raw.shape)}")
    if raw.dtype not in _DTYPE_CODES:
        raise TypeError(f"raw dtype {raw.dtype} not supported "
                        f"(uint8, uint16, float32)")
    if not raw.is_contiguous():
        raise ValueError("raw must be contiguous")
    B, C, H, W = raw.shape
    dev = raw.device
    for arg, value, dtype in (
            ("window_start", window_start, torch.float32),
            ("window_end", window_end, torch.float32),
            ("family", family, torch.int32),
            ("coefficient", coefficient, torch.float32),
            ("reverse", reverse, torch.int32)):
        _check(arg, value, dtype, (B, C), dev)
    _check("tables", table, torch.float32, (B, C) + table_shape, dev)
    out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = library()
    is_lut = name == "render_lut"
    # The ramp kernel keeps the whole batch's B * C settings in shared
    # memory, the LUT kernel one tile's C settings beside at least one
    # channel's table (it stages the tables in chunks of channels).
    held = C if is_lut else B * C
    if C < 1 or held > lib.render_max_channels(int(is_lut)):
        raise ValueError(f"{name}: {held} channel settings do not fit the "
                         f"kernel's shared memory (max "
                         f"{lib.render_max_channels(int(is_lut))})")
    fn = lib.render_lut_launch if is_lut else lib.render_ramp_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(raw.data_ptr(), _DTYPE_CODES[raw.dtype],
                 window_start.data_ptr(), window_end.data_ptr(),
                 coefficient.data_ptr(), family.data_ptr(),
                 reverse.data_ptr(), table.data_ptr(), out.data_ptr(),
                 B, C, H * W, int(cd_start), int(cd_end), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)
    return out


def render_ramp(raw, window_start, window_end, family, coefficient,
                reverse, weights, cd_start, cd_end) -> torch.Tensor:
    """K1: raw [B, C, H, W] (u8/u16/f32, CUDA) + per-tile [B, C] settings
    and f32[B, C, 3] ramp weights -> i32[B, H, W] packed RGBA."""
    return _launch("render_ramp", raw, window_start, window_end, family,
                   coefficient, reverse, weights, (3,), cd_start, cd_end)


def render_lut(raw, window_start, window_end, family, coefficient,
               reverse, tables, cd_start, cd_end) -> torch.Tensor:
    """K2: as :func:`render_ramp` with f32[B, C, 256, 3] tables."""
    return _launch("render_lut", raw, window_start, window_end, family,
                   coefficient, reverse, tables, (256, 3), cd_start, cd_end)
