"""Batched device downsampling for the pyramid job (the JAX package's
``ops/pyramid.py``).

The serving stack's host reduction is ``io.store._downsample2``: mean-pool
by 2 in float64, ``np.round`` for integer dtypes, cast back.  K9
(``kernels.workloads.mean2_int``) reproduces it bit for bit for the
storage dtypes the job sends to the card (integer, itemsize <= 2): a 2x2
sum of uint16 values is <= 4 * 65535 = 262140 < 2^24, so the int32 sum is
exact, the scale by 0.25 is an exact power-of-two f32 product, and the
rounding is half to even like ``np.round``.  Wider or floating dtypes use
the host formula, as the JAX package's rule has it.

That exactness is the job's crash-safety contract: a killed and resumed
build re-derives byte-identical levels because every reduction is
deterministic integer math.

K9 reads and writes the storage dtype on the card (the JAX package casts
to int32 on the host first, which doubles the bytes sent).  Its plain
version, :func:`mean2_int_plain`, is the same operations in eager torch;
:func:`mean2_int` sends a CPU tensor there and a CUDA tensor to K9.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .render import resolve_device


def _widen(planes: torch.Tensor) -> torch.Tensor:
    """int32 values of integer samples (uint16 through its int16 bits:
    torch's unsigned types have few ops)."""
    if planes.dtype == torch.uint16:
        return planes.view(torch.int16).to(torch.int32) & 0xFFFF
    return planes.to(torch.int32)


def mean2_int_plain(planes: torch.Tensor) -> torch.Tensor:
    """The plain version of K9: [N, H, W] integer samples -> [N, H // 2,
    W // 2] of the same type, ``round((a + b + c + d) * 0.25)`` with the
    sum in int32 and the scale in f32, half to even."""
    h, w = planes.shape[-2] // 2, planes.shape[-1] // 2
    v = _widen(planes)[:, :2 * h, :2 * w]
    s = v[:, 0::2, 0::2] + v[:, 0::2, 1::2] + v[:, 1::2, 0::2] \
        + v[:, 1::2, 1::2]
    m = torch.round(s.to(torch.float32) * 0.25).to(torch.int32)
    if planes.dtype == torch.uint16:
        return m.to(torch.int16).view(torch.uint16)   # bits of 0..65535
    return m.to(planes.dtype)


def mean2_int(planes: torch.Tensor) -> torch.Tensor:
    """K9 on a CUDA tensor, its plain version on a CPU tensor."""
    if planes.is_cuda:
        from ..kernels import workloads
        return workloads.mean2_int(planes)
    return mean2_int_plain(planes)


def _device_exact(dtype: np.dtype) -> bool:
    return np.issubdtype(dtype, np.integer) and dtype.itemsize <= 2


def downsample2_batch(planes: np.ndarray,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> np.ndarray:
    """Mean-pool a stack of planes by 2: [..., H, W] -> [..., H//2, W//2].

    Matches ``io.store._downsample2`` bit for bit per plane, its tiny-plane
    guard included (a dimension that cannot halve collapses the plane to
    [..., 1, 1], on the host).  Integer dtypes up to 16 bits take one K9
    launch on ``device`` (default: the card; ``"cpu"`` runs the plain
    version); everything else computes the host formula over the batch.
    Returns numpy: the level writer writes from the host."""
    *lead, H, W = planes.shape
    h, w = H // 2, W // 2
    if h < 1 or w < 1:
        return np.ascontiguousarray(planes[..., :1, :1])
    dtype = np.dtype(planes.dtype)
    if _device_exact(dtype):
        dev = resolve_device("cuda" if device is None else device)
        host = np.ascontiguousarray(planes.reshape(-1, H, W))
        # uint16 crosses as int16 bits (numpy interop of torch.uint16 is
        # recent) and is viewed back on either side.
        u16 = dtype == np.uint16
        x = torch.from_numpy(host.view(np.int16) if u16 else host).to(dev)
        y = mean2_int(x.view(torch.uint16) if u16 else x)
        out = (y.view(torch.int16) if u16 else y).cpu().numpy().view(dtype)
        del x, y                 # the level's device tensors go now
    else:
        v = planes.reshape(-1, H, W)[:, : h * 2, : w * 2]
        m = v.astype(np.float64).reshape(-1, h, 2, w, 2).mean(axis=(2, 4))
        if np.issubdtype(dtype, np.integer):
            m = np.round(m)
        out = m.astype(dtype)
    return out.reshape(*lead, h, w)


def n_pyramid_levels(height: int, width: int,
                     min_level_size: int = 256) -> int:
    """How many levels a full build yields: the ``io.ngff.write_ngff``
    halving rule (halve while ``min(h//2, w//2) >= min_level_size``), so
    job plans and the writer never disagree on the level count."""
    n, h, w = 1, height, width
    while min(h // 2, w // 2) >= min_level_size:
        h, w = h // 2, w // 2
        n += 1
    return n
