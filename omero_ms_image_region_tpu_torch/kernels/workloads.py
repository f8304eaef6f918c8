"""Hand-written CUDA kernels of the projection, mask and pyramid
workloads: build, load, launch.

Counterparts of the JAX package's device programs off the render path:

* :func:`project_fold` (K7) replaces the projection folds of
  ``ops/projection.py`` (``_fold_max`` / ``_fold_sum`` ``:76-84``,
  ``_finalize`` ``:87-93``, ``_fold_chunk`` ``:177-185`` and ``_stitch``
  ``:188-190``): it folds a chunk of planes straight into rows of the f32
  output plane, so no stitch copy is needed;
* :func:`mask_rasterize` (K8a) replaces ``ops/maskops.py::
  _rasterize_batch_jit`` (``:143``);
* :func:`mask_overlay` (K8b) replaces ``_overlay_batch_jit`` (``:197``);
* :func:`mean2_int` (K9) replaces ``ops/pyramid.py::_mean2_int_jit``
  (``:26``): the pyramid job's 2x2 integer downsample, read and written in
  the storage dtype.

All four live in ``csrc/workloads.cu`` behind a plain ``extern "C"``
interface, built and loaded by :mod:`.build` on first use; a build failure
raises.  Each wrapper takes CUDA tensors only, checks device, dtype, shape
and contiguity, launches on the current stream, raises if a launch was
refused, and counts one launch in :data:`LAUNCHES` per call.  The plain
PyTorch versions are in ``ops/projection.py``, ``ops/maskops.py`` and
``ops/pyramid.py``, whose dispatchers send CPU tensors there and CUDA
tensors here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from . import build

SOURCE = build.CSRC / "workloads.cu"
# No contraction into FMAs and no fast math: K7 rounds each add and divide.
NVCC_FLAGS = build.ARCH_FLAGS + ("-fmad=false",)

# The pixel types K7 reads, in the codes of csrc/workloads.cu.
FOLD_DTYPES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2,
               torch.uint16: 3, torch.int32: 4, torch.uint32: 5,
               torch.float32: 6, torch.float64: 7}

# The pixel types K9 reads and writes (a subset of the codes above).
MEAN2_DTYPES = {t: FOLD_DTYPES[t] for t in (torch.int8, torch.uint8,
                                            torch.int16, torch.uint16)}

LAUNCHES: Dict[str, int] = {"project_fold": 0, "mask_rasterize": 0,
                            "mask_overlay": 0, "mean2_int": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _configure(lib: ctypes.CDLL) -> None:
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.project_fold_launch.argtypes = [p, i, i, ll, p, i, i, i, f, f, p]
    lib.mask_rasterize_launch.argtypes = [p, i, ll, i, i, i, i, p, p]
    lib.mask_overlay_launch.argtypes = [p, p, p, i, ll, p, p]
    lib.mean2_int_launch.argtypes = [p, i, ll, ll, ll, p, p]
    for fn in (lib.project_fold_launch, lib.mask_rasterize_launch,
               lib.mask_overlay_launch, lib.mean2_int_launch):
        fn.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return build.load(SOURCE, NVCC_FLAGS, _configure)


def _cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} runs on CUDA tensors only; the plain "
                             f"version is in ops.projection / ops.maskops "
                             f"/ ops.pyramid")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def project_fold(chunk: torch.Tensor, out: torch.Tensor, y0: int,
                 algorithm: int, first: bool, finalize: bool, count: int,
                 type_max: float) -> None:
    """K7: fold ``chunk`` [zc, h, W] (any pixel type of
    :data:`FOLD_DTYPES`) into rows ``y0:y0+h`` of the f32 plane ``out``
    [H, W], in place.

    Each pixel folds its planes in z order, one max or one add at a time
    (``algorithm``: 0 max, 1 mean, 2 sum, ``models.rendering.Projection``),
    from plane 0 when ``first``, else from the rows' current values.  With
    ``finalize``: max gets its 0 floor, mean divides by ``max(count, 1)``,
    mean and sum are clamped to ``type_max`` (as f32).  NaN propagates as
    in ``np.maximum`` / ``np.minimum``."""
    dev = _cuda("project_fold", chunk, out)
    if chunk.dtype not in FOLD_DTYPES or chunk.dim() != 3:
        raise ValueError(f"chunk must be [zc, h, W] of a pixel type, got "
                         f"{chunk.dtype} {tuple(chunk.shape)}")
    if out.dtype != torch.float32 or out.dim() != 2:
        raise ValueError(f"out must be f32[H, W], got {out.dtype} "
                         f"{tuple(out.shape)}")
    zc, h, W = chunk.shape
    if W != out.shape[1] or not 0 <= y0 <= out.shape[0] - h:
        raise ValueError(f"chunk rows {y0}:{y0 + h} of width {W} do not "
                         f"fit out {tuple(out.shape)}")
    if algorithm not in (0, 1, 2):
        raise ValueError(f"unknown projection algorithm {algorithm}")
    if first and zc < 1:
        raise ValueError("a first chunk needs at least one plane")
    rows = out[y0:y0 + h]
    lib = library()
    with torch.cuda.device(dev):
        err = lib.project_fold_launch(
            chunk.data_ptr(), FOLD_DTYPES[chunk.dtype], zc, h * W,
            rows.data_ptr(), int(algorithm), int(first), int(finalize),
            float(max(count, 1)), float(type_max), _stream(dev))
    _launched("project_fold", err)


def mask_rasterize(packed: torch.Tensor, width: int, height: int,
                   flip_h: bool = False, flip_v: bool = False
                   ) -> torch.Tensor:
    """K8a: packed u8[B, nbytes] mask bits (MSB first, continuous across
    rows, ``nbytes >= ceil(width*height/8)``) -> u8[B, height, width] 0/1
    grids; output ``(y, x)`` reads the bit of the flipped source position.
    A mask holds fewer than 2**32 pixels (the kernel indexes it in 32
    bits)."""
    dev = _cuda("mask_rasterize", packed)
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be u8[B, nbytes], got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    B, nbytes = packed.shape
    if width < 0 or height < 0 or nbytes * 8 < width * height:
        raise ValueError(f"{nbytes} bytes hold no {width}x{height} mask")
    if B > 65535:
        raise ValueError(f"{B} masks exceed one launch's grid")
    if width * height >= 1 << 32:
        raise ValueError(f"a {width}x{height} mask exceeds 2**32 pixels")
    out = torch.empty((B, height, width), dtype=torch.uint8, device=dev)
    if B == 0 or width * height == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        err = lib.mask_rasterize_launch(
            packed.data_ptr(), B, nbytes, width, height, int(flip_h),
            int(flip_v), out.data_ptr(), _stream(dev))
    _launched("mask_rasterize", err)
    return out


def mask_overlay(base: torch.Tensor, grids: torch.Tensor,
                 fills: torch.Tensor) -> torch.Tensor:
    """K8b: ``base`` u8[B, H, W, 4], ``grids`` u8[B, H, W] (nonzero =
    masked), ``fills`` u8[B, 4] -> u8[B, H, W, 4]: RGB
    ``(base*(255-a) + fill*a + 127) // 255`` in u32 with
    ``a = (grid != 0) * fill_alpha``; alpha copied from the base."""
    dev = _cuda("mask_overlay", base, grids, fills)
    for name, t, dim in (("base", base, 4), ("grids", grids, 3),
                         ("fills", fills, 2)):
        if t.dtype != torch.uint8 or t.dim() != dim:
            raise ValueError(f"{name} must be u8 with {dim} dims, got "
                             f"{t.dtype} {tuple(t.shape)}")
    B, H, W, four = base.shape
    if four != 4 or tuple(grids.shape) != (B, H, W) \
            or tuple(fills.shape) != (B, 4):
        raise ValueError(f"shapes base {tuple(base.shape)}, grids "
                         f"{tuple(grids.shape)}, fills {tuple(fills.shape)} "
                         f"do not agree")
    if B > 65535:
        raise ValueError(f"{B} tiles exceed one launch's grid")
    out = torch.empty_like(base)
    if B == 0 or H * W == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        err = lib.mask_overlay_launch(
            base.data_ptr(), grids.data_ptr(), fills.data_ptr(), B, H * W,
            out.data_ptr(), _stream(dev))
    _launched("mask_overlay", err)
    return out


def mean2_int(planes: torch.Tensor) -> torch.Tensor:
    """K9: ``planes`` [N, H, W] of int8, uint8, int16 or uint16 (H, W >= 2)
    -> [N, H // 2, W // 2] of the same type, each sample the rounded mean
    of its 2x2 block: ``rint((a + b + c + d) * 0.25)`` with the sum in
    int32 and the scale in f32, half to even.  An odd last row or column
    is not read."""
    dev = _cuda("mean2_int", planes)
    if planes.dtype not in MEAN2_DTYPES or planes.dim() != 3:
        raise ValueError(f"planes must be [N, H, W] of an integer type of "
                         f"at most 16 bits, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    N, H, W = planes.shape
    if H < 2 or W < 2:
        raise ValueError(f"a {H}x{W} plane does not halve")
    out = torch.empty((N, H // 2, W // 2), dtype=planes.dtype, device=dev)
    if N == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        err = lib.mean2_int_launch(planes.data_ptr(),
                                   MEAN2_DTYPES[planes.dtype], N, H, W,
                                   out.data_ptr(), _stream(dev))
    _launched("mean2_int", err)
    return out
