"""Hand-written CUDA mesh kernels for Hopper: build, load, launch.

Counterparts of the per-shard body of the JAX package's mesh steps
(``parallel/mesh.py``; XLA programs under ``shard_map``, no Pallas kernel)
on a mesh with ``chan > 1``; at ``chan = 1`` the port's step renders with
K1 or K2 instead (``ops.render.render_tile_batch_packed``), with no
partial:

* :func:`composite_partial` (K12a) replaces ``_local_render`` (``:100``)
  and ``_local_render_batched`` (``:227``): one chan shard's partial RGB
  composite f32[3, B, H, W] of the channels ``[c0, c1)``.
* :func:`composite_pack` (K12b) replaces the ``psum`` over ``chan`` and the
  pack of ``_composite_step`` (``:150``) and ``_composite_step_batched``
  (``:271``): the all-gathered partials f32[S, 3, B, H, W] summed in shard
  order, rounded, clipped and packed into i32[B, H, W].

Both live in ``csrc/mesh.cu`` (with K1's quantize from ``csrc/quantize.cuh``)
behind a plain ``extern "C"`` interface, built and loaded by :mod:`.build`
on first use with ``-fmad=false`` as K1; a build failure raises.  Each
wrapper checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty``, launches on the current CUDA stream, raises if the
launch was refused, and counts the launch in :data:`LAUNCHES`.

The plain PyTorch versions are ``ops.render.composite_partial_plain`` and
``composite_pack_plain``; ``ops.render.composite_partial`` and
``composite_pack`` send CPU tensors there and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from . import build
from .render import _DTYPE_CODES, _check

SOURCE = build.CSRC / "mesh.cu"
NVCC_FLAGS = build.ARCH_FLAGS + (
    # Each multiply and add rounded on its own, as K1 and the reference:
    # no contraction into an FMA.  Never --use_fast_math.
    "-fmad=false",
)

# Launches of each kernel since the last reset_launches(); incremented only
# where the kernel is launched.
LAUNCHES: Dict[str, int] = {"composite_partial": 0, "composite_pack": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _configure(lib: ctypes.CDLL) -> None:
    lib.composite_partial_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.composite_partial_launch.restype = ctypes.c_int
    lib.composite_pack_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.composite_pack_launch.restype = ctypes.c_int
    lib.mesh_max_settings.argtypes = [ctypes.c_int]
    lib.mesh_max_settings.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return build.load(SOURCE, NVCC_FLAGS, _configure)


def _on_cuda(name: str, t, plain: str) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors only; the plain "
                         f"version is ops.render.{plain}")


def composite_partial(raw, window_start, window_end, family, coefficient,
                      reverse, cd_start, cd_end, tables, c0: int = 0,
                      c1: Optional[int] = None) -> torch.Tensor:
    """K12a: raw [B, C, H, W] (u8/u16/f32, CUDA), per-tile [B, C] settings
    and f32[B, C, 3] ramp weights or f32[B, C, 256, 3] tables -> the
    partial composite f32[3, B, H, W] of channels ``[c0, c1)`` (default
    all)."""
    _on_cuda("composite_partial", raw, "composite_partial_plain")
    if raw.dim() != 4:
        raise ValueError(f"raw must be [B, C, H, W], got {tuple(raw.shape)}")
    if raw.dtype not in _DTYPE_CODES:
        raise TypeError(f"raw dtype {raw.dtype} not supported "
                        f"(uint8, uint16, float32)")
    if not raw.is_contiguous():
        raise ValueError("raw must be contiguous")
    B, C, H, W = raw.shape
    c1 = C if c1 is None else c1
    if not 0 <= c0 < c1 <= C:
        raise ValueError(f"channel slice [{c0}, {c1}) is not inside "
                         f"[0, {C})")
    dev = raw.device
    for arg, value, dtype in (
            ("window_start", window_start, torch.float32),
            ("window_end", window_end, torch.float32),
            ("family", family, torch.int32),
            ("coefficient", coefficient, torch.float32),
            ("reverse", reverse, torch.int32)):
        _check(arg, value, dtype, (B, C), dev)
    lut = tables.dim() == 4
    _check("tables", tables, torch.float32,
           (B, C) + ((256, 3) if lut else (3,)), dev)
    out = torch.empty((3, B, H, W), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = library()
    # Ramp weights: every tile's settings in one block; tables: one tile's.
    settings = (c1 - c0) if lut else B * (c1 - c0)
    if settings > lib.mesh_max_settings(int(lut)):
        raise ValueError(f"composite_partial: {settings} channel settings "
                         f"do not fit the kernel's shared memory (max "
                         f"{lib.mesh_max_settings(int(lut))})")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.composite_partial_launch(
            raw.data_ptr(), _DTYPE_CODES[raw.dtype],
            window_start.data_ptr(), window_end.data_ptr(),
            coefficient.data_ptr(), family.data_ptr(), reverse.data_ptr(),
            tables.data_ptr(), int(lut), out.data_ptr(), B, C, c0, c1,
            H * W, int(cd_start), int(cd_end), stream)
    if err != 0:
        raise RuntimeError(f"composite_partial launch failed: CUDA error "
                           f"{err}")
    _count("composite_partial")
    return out


def composite_pack(partials) -> torch.Tensor:
    """K12b: the all-gathered partials f32[S, 3, B, H, W] (CUDA) -> i32[B,
    H, W] packed RGBA, the S shards summed in order."""
    _on_cuda("composite_pack", partials, "composite_pack_plain")
    if partials.dim() != 5 or partials.shape[1] != 3:
        raise ValueError(f"partials must be [S, 3, B, H, W], got "
                         f"{tuple(partials.shape)}")
    if partials.dtype != torch.float32:
        raise TypeError(f"partials must be float32, got {partials.dtype}")
    if not partials.is_contiguous():
        raise ValueError("partials must be contiguous")
    S, _, B, H, W = partials.shape
    if S == 0:
        raise ValueError("partials hold no shard")
    dev = partials.device
    out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.composite_pack_launch(partials.data_ptr(), out.data_ptr(),
                                        S, B * H * W, stream)
    if err != 0:
        raise RuntimeError(f"composite_pack launch failed: CUDA error {err}")
    _count("composite_pack")
    return out
