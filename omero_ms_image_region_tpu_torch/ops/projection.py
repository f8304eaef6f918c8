"""Z-stack intensity projection.

Counterpart of the JAX package's ``ops/projection.py``, the replacement of
``ProjectionService.java`` (per-pixel loops at ``:176-199`` (max) and
``:259-291`` (mean/sum)).  Reference semantics, quirks included:

* max: z runs ``start..end`` INCLUSIVE (``:184``), and the accumulator
  starts at 0 (``:183``): an all-negative column projects to 0;
* mean/sum: z runs ``start..end`` EXCLUSIVE of end (``:271``), the result
  is clamped above by the pixel type's max (``:280-282``), never below;
* mean divides by the number of planes actually used (``:277-279``).

Two placements of the fold, as in the JAX package:

* ``host``: numpy, the JAX package's host fold verbatim; the finished f32
  plane crosses to the device through a pinned buffer.  The handler uses
  this one (the JAX handler's ``placement="host"``).
* ``device``: K7 (``kernels.workloads.project_fold``, its plain version
  :func:`fold_chunk_plain` on the CPU).  Chunks of ``[zc, h, W]`` planes in
  the store's pixel type cross through a pinned buffer, and K7 folds each
  straight into rows ``y0:y0+h`` of the f32 output plane (no stitch copy),
  applying the floor, divide and clamp on the last chunk.  It replaces the
  JAX ``_fold_max``, ``_fold_sum``, ``_fold_chunk``, ``_stitch`` and
  ``_finalize``.

K7 folds each pixel in z order, one max or one add at a time, from the
window's first plane: the result equals the host fold of
:func:`project_planes` for every pixel type, NaN included.  The banded host
fold sums each chunk first and adds the chunk sum to its accumulator (the
JAX package's numpy code); for integer types every partial sum is exact
below 2^24 (u16 with Z <= 256), so the two placements agree there too, as
they do with the JAX device fold, which sums inside a chunk in XLA's
order.  Device results are synchronized before they are returned: a
caller may read them on any stream.

Bounds validation mirrors ``projectStack`` (``ProjectionService.java
:52-64``).
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

from ..io.staging import pinned_copy
from ..models.rendering import Projection


def check_projection_bounds(start: int, end: int, stepping: int,
                            channel: int, timepoint: int,
                            size_z: int, size_c: int, size_t: int) -> None:
    """Host-side validation (= zIntervalBoundsCheck / outOfBounds* checks)."""
    if start < 0 or end < 0:
        raise ValueError("Z interval value cannot be negative.")
    if start >= size_z or end >= size_z:
        raise ValueError(f"Z interval value cannot be >= {size_z}")
    if stepping is not None and stepping <= 0:
        raise ValueError(f"stepping: {stepping} <= 0")
    if channel is not None:
        if channel < 0:
            raise ValueError(f"channel: {channel} < 0")
        if channel >= size_c:
            raise ValueError(f"channel index must be <{size_c}")
    if timepoint is not None:
        if timepoint < 0:
            raise ValueError(f"timepoint: {timepoint} < 0")
        if timepoint >= size_t:
            raise ValueError(f"timepoint must be <{size_t}")


def _finalize_host(acc: np.ndarray, count: int, type_max: float,
                   algorithm) -> np.ndarray:
    """The reference's finish on the host: 0-floor max accumulator, mean
    divide, type-max clamp."""
    if algorithm == Projection.MAXIMUM_INTENSITY:
        return np.maximum(acc, 0.0)
    if algorithm == Projection.MEAN_INTENSITY:
        acc = acc / max(float(count), 1.0)
    return np.minimum(acc, np.float32(type_max))


def _resolve_placement(placement: str, sample) -> str:
    """``auto`` folds where the data lives: host (numpy) sources fold on
    the host and send one projected plane to the device; sources already
    on the device fold there."""
    if placement == "auto":
        return "host" if isinstance(sample, np.ndarray) else "device"
    if placement not in ("host", "device"):
        raise ValueError(f"unknown placement {placement!r}")
    return placement


def _validate_and_window(algorithm, size_z: int, start: int, end: int,
                         stepping: int):
    """Shared validation and Z-window derivation of the streaming
    projections (max is end-INclusive, mean/sum end-EXclusive,
    ``ProjectionService.java:184,:271``).  Returns (algorithm, zs,
    inclusive)."""
    algorithm = Projection(algorithm)
    if algorithm not in (
        Projection.MAXIMUM_INTENSITY,
        Projection.MEAN_INTENSITY,
        Projection.SUM_INTENSITY,
    ):
        raise ValueError(f"Unknown algorithm: {algorithm}")
    if start < 0 or end < 0:
        raise ValueError("Z interval value cannot be negative.")
    if start >= size_z or end >= size_z:
        raise ValueError(f"Z interval value cannot be >= {size_z}")
    if stepping <= 0:
        raise ValueError(f"stepping: {stepping} <= 0")
    inclusive = algorithm == Projection.MAXIMUM_INTENSITY
    stop = end + 1 if inclusive else end
    zs = [z for z in range(start, stop) if (z - start) % stepping == 0]
    return algorithm, zs, inclusive


# --------------------------------------------------------------- staging

# Pinned carriers of the pixel types: torch's uint16 and uint32 cross in
# their signed views.
_CARRIERS = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
             np.dtype(np.int16): torch.int16,
             np.dtype(np.uint16): torch.int16,
             np.dtype(np.int32): torch.int32,
             np.dtype(np.uint32): torch.int32,
             np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}
_VIEWS = {np.dtype(np.uint16): torch.uint16,
          np.dtype(np.uint32): torch.uint32}


def stage_planes(arr: np.ndarray, device: Union[str, torch.device]
                 ) -> torch.Tensor:
    """Host planes of any pixel type -> a tensor of the same type on
    ``device``: one host copy into a pinned buffer, one ``non_blocking``
    DMA on the current stream (on the CPU, the buffer itself)."""
    arr = np.asarray(arr)
    carrier = _CARRIERS.get(arr.dtype)
    if carrier is None:
        raise ValueError(f"no projection of pixel type {arr.dtype}")
    device = torch.device(device)
    buf = torch.empty(arr.shape, dtype=carrier,
                      pin_memory=device.type == "cuda")
    np.copyto(buf.numpy().view(arr.dtype), arr)
    if device.type == "cuda":
        out = torch.empty(arr.shape, dtype=carrier, device=device)
        out.copy_(buf, non_blocking=True)
    else:
        out = buf
    view = _VIEWS.get(arr.dtype)
    return out.view(view) if view is not None else out


def _synchronized(t: torch.Tensor) -> torch.Tensor:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


def _to_device(plane: np.ndarray, device) -> torch.Tensor:
    """A host-folded f32 plane on ``device`` (pinned staging)."""
    return _synchronized(pinned_copy(np.ascontiguousarray(plane, np.float32),
                               torch.device(device)))


# ------------------------------------------------------------- the fold

def _widen(chunk: torch.Tensor) -> torch.Tensor:
    """f32 values of the planes, rounded to nearest as numpy's
    ``astype(float32)``; uint16 and uint32 go through their exact int32
    and int64 values (torch's unsigned types have few ops)."""
    if chunk.dtype == torch.uint16:
        chunk = chunk.view(torch.int16).to(torch.int32) & 0xFFFF
    elif chunk.dtype == torch.uint32:
        chunk = chunk.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return chunk.to(torch.float32)


def fold_chunk_plain(chunk: torch.Tensor, out: torch.Tensor, y0: int,
                     algorithm: int, first: bool, finalize: bool,
                     count: int, type_max: float) -> None:
    """Plain PyTorch version of K7, in place: a z loop of
    ``torch.maximum`` / ``+`` over ``chunk`` [zc, h, W] into rows
    ``y0:y0+h`` of the f32 plane ``out``, then the same finalize."""
    h = chunk.shape[1]
    rows = out[y0:y0 + h]
    x = _widen(chunk)
    z0 = 1 if first else 0
    acc = x[0].clone() if first else rows.clone()
    for z in range(z0, chunk.shape[0]):
        acc = (torch.maximum(acc, x[z]) if algorithm == 0
               else acc + x[z])
    if finalize:
        if algorithm == 0:
            acc = torch.maximum(acc, torch.zeros((), dtype=torch.float32,
                                                 device=acc.device))
        else:
            if algorithm == 1:
                # A tensor divisor on the tensor's device: PyTorch's CUDA
                # division by a host scalar multiplies by its reciprocal,
                # which is not correctly rounded.
                acc = acc / torch.tensor(float(max(count, 1)),
                                         dtype=torch.float32,
                                         device=acc.device)
            acc = torch.minimum(acc, torch.tensor(
                float(np.float32(type_max)), dtype=torch.float32,
                device=acc.device))
    rows.copy_(acc)


def fold_chunk(chunk: torch.Tensor, out: torch.Tensor, y0: int,
               algorithm: int, first: bool, finalize: bool, count: int,
               type_max: float) -> None:
    """K7 on CUDA tensors (it raises if it cannot launch), its plain
    version on CPU tensors."""
    if out.is_cuda:
        from ..kernels import workloads
        workloads.project_fold(chunk, out, y0, algorithm, first, finalize,
                               count, type_max)
    else:
        fold_chunk_plain(chunk, out, y0, algorithm, first, finalize, count,
                         type_max)


def _on_device(chunk, device: torch.device) -> torch.Tensor:
    if isinstance(chunk, torch.Tensor):
        return chunk.to(device).contiguous()
    return stage_planes(np.ascontiguousarray(chunk), device)


def _fold_device(read_chunk: Callable, zs: Sequence[int], algorithm,
                 plane_shape, band_h: int, z_chunk: int, type_max: float,
                 device: torch.device) -> torch.Tensor:
    """The device placement: each band's chunks folded by K7 straight into
    the output plane's rows, finalized on the band's last chunk."""
    H, W = plane_shape
    out = torch.zeros((H, W), dtype=torch.float32, device=device)
    if not zs:
        return out      # empty mean/sum window: the zero plane
    alg = int(algorithm)
    n_chunks = -(-len(zs) // z_chunk)
    for bi in range(-(-H // band_h)):
        y0 = min(bi * band_h, H - band_h)
        for ci in range(n_chunks):
            chunk_zs = zs[ci * z_chunk:(ci + 1) * z_chunk]
            chunk = _on_device(read_chunk(chunk_zs, y0, band_h), device)
            fold_chunk(chunk, out, y0, alg, ci == 0, ci == n_chunks - 1,
                       len(zs), type_max)
    return _synchronized(out)


def project_planes(get_plane, algorithm, size_z: int, start: int,
                   end: int, stepping: int = 1,
                   type_max: float = 255.0, shape=None,
                   placement: str = "auto", z_chunk: int = 8,
                   device: Union[str, torch.device] = "cuda"
                   ) -> torch.Tensor:
    """Stream a Z-projection plane by plane: only the planes inside the Z
    window are read, through ``get_plane(z) -> [H, W]`` (numpy, or a
    tensor), so peak memory is independent of Z (the reference's
    ``PixelBuffer.getStack``, ``ProjectionService.java:72``, holds the
    whole stack).

    ``placement``: see the module docstring (``auto`` folds where the data
    lives).  The device fold takes ``z_chunk`` planes a K7 launch.

    Returns f32[H, W] on ``device``.
    """
    device = torch.device(device)
    algorithm, zs, inclusive = _validate_and_window(
        algorithm, size_z, start, end, stepping)
    first = get_plane(zs[0]) if zs else None
    if zs:
        placement = _resolve_placement(placement, first)
    if placement == "host" and zs:
        acc = np.asarray(first, np.float32)
        for z in zs[1:]:
            plane = np.asarray(get_plane(z), np.float32)
            acc = np.maximum(acc, plane) if inclusive else acc + plane
        return _to_device(_finalize_host(acc, len(zs), type_max,
                                         algorithm), device)
    if shape is None:
        # An empty window with no geometry given: probe one plane.
        shape = tuple((first if first is not None
                       else get_plane(start)).shape)

    def read_chunk(chunk_zs, y0, h):
        planes = [first if z == zs[0] else get_plane(z) for z in chunk_zs]
        if all(isinstance(p, torch.Tensor) for p in planes):
            return torch.stack([p.to(device) for p in planes])
        return np.stack([np.asarray(p) if not isinstance(p, torch.Tensor)
                         else p.cpu().numpy() for p in planes])
    return _fold_device(read_chunk, zs, algorithm, shape, shape[0],
                        z_chunk, type_max, device)


def project_region_banded(get_band, algorithm, size_z: int, start: int,
                          end: int, stepping: int = 1,
                          type_max: float = 255.0, plane_shape=None,
                          band_rows: int = 256, z_chunk: int = 8,
                          get_chunk=None, placement: str = "auto",
                          device: Union[str, torch.device] = "cuda"
                          ) -> torch.Tensor:
    """Spatially-banded streamed Z-projection: peak HOST memory is one
    ``[z_chunk, band_rows, W]`` chunk, not a plane.

    ``get_band(z, y0, h) -> [h, W]`` reads one band of one plane;
    ``get_chunk(zs, y0, h) -> [len(zs), h, W]``, when given, reads a chunk
    at once.  The last band is aligned to ``H - band_rows``; its overlap
    rows are computed again from their planes, so the result does not
    depend on the band order.  Peak DEVICE memory is the f32 output plane
    and one chunk (the projected plane feeds the render whole, as the
    reference's byte[] planes do, ``ProjectionService.java:72``).

    Returns f32[H, W] on ``device``.
    """
    device = torch.device(device)
    algorithm, zs, inclusive = _validate_and_window(
        algorithm, size_z, start, end, stepping)
    if plane_shape is None:
        raise ValueError("plane_shape is required")
    H, W = plane_shape
    band_h = min(band_rows, H)

    # Auto-placement probes are reused as the first loop read, so auto
    # costs no extra I/O: the band probe is (band 0, z0); the chunk probe
    # reads the first [z_chunk, band, W] block.
    probe = probe_chunk = None
    first_chunk_zs = tuple(zs[:z_chunk])
    if zs and placement == "auto":
        if get_chunk is not None:
            sample = probe_chunk = get_chunk(list(first_chunk_zs), 0,
                                             band_h)
        else:
            sample = probe = get_band(zs[0], 0, band_h)
        placement = _resolve_placement(placement, sample)

    def read_band(z, y0, h):
        nonlocal probe
        if probe is not None and z == zs[0] and y0 == 0:
            band, probe = probe, None
            return band
        return get_band(z, y0, h)

    def read_chunk(chunk_zs, y0, h):
        nonlocal probe_chunk
        if get_chunk is None:
            bands = [read_band(z, y0, h) for z in chunk_zs]
            if all(isinstance(b, torch.Tensor) for b in bands):
                return torch.stack([b.to(device) for b in bands])
            return np.stack([np.asarray(b) if not isinstance(
                b, torch.Tensor) else b.cpu().numpy() for b in bands])
        if (probe_chunk is not None and y0 == 0
                and tuple(chunk_zs) == first_chunk_zs):
            chunk, probe_chunk = probe_chunk, None
            return chunk
        return get_chunk(chunk_zs, y0, h)

    if placement == "host" and zs:
        out = np.zeros((H, W), np.float32)
        for bi in range(-(-H // band_h)):
            y0 = min(bi * band_h, H - band_h)
            acc = (np.full((band_h, W), -np.inf, np.float32)
                   if inclusive else np.zeros((band_h, W), np.float32))
            for ci in range(0, len(zs), z_chunk):
                chunk_zs = zs[ci:ci + z_chunk]
                chunk = np.asarray(read_chunk(chunk_zs, y0, band_h),
                                   np.float32)
                if inclusive:
                    acc = np.maximum(acc, chunk.max(axis=0))
                else:
                    acc += chunk.sum(axis=0)
            out[y0:y0 + band_h] = acc
        return _to_device(_finalize_host(out, len(zs), type_max,
                                         algorithm), device)
    return _fold_device(read_chunk, zs, algorithm, (H, W), band_h, z_chunk,
                        type_max, device)


def project_stack(stack, algorithm, start: int, end: int,
                  stepping: int = 1, type_max: float = 255.0,
                  device: Union[str, torch.device] = "cuda"
                  ) -> torch.Tensor:
    """Project a resident Z-stack (one channel and timepoint,
    ``PixelBuffer.getStack``, ``ProjectionService.java:72``): numpy or a
    tensor [Z, H, W] of a pixel type.  The window's planes go to
    ``device`` and one K7 launch folds and finalizes them.

    Returns f32[H, W] on ``device``.
    """
    algorithm = Projection(algorithm)
    if algorithm not in (
        Projection.MAXIMUM_INTENSITY,
        Projection.MEAN_INTENSITY,
        Projection.SUM_INTENSITY,
    ):
        raise ValueError(f"Unknown algorithm: {algorithm}")
    # Z-interval validation (= zIntervalBoundsCheck at the projectStack
    # entry, ProjectionService.java:52-54); channel and timepoint bounds
    # are the caller's (check_projection_bounds).
    if start < 0 or end < 0:
        raise ValueError("Z interval value cannot be negative.")
    if start >= stack.shape[0] or end >= stack.shape[0]:
        raise ValueError(f"Z interval value cannot be >= {stack.shape[0]}")
    if stepping <= 0:
        raise ValueError(f"stepping: {stepping} <= 0")
    algorithm, zs, _ = _validate_and_window(
        algorithm, stack.shape[0], start, end, stepping)
    H, W = stack.shape[1:]

    def read_chunk(chunk_zs, y0, h):
        return stack[list(chunk_zs)]
    return _fold_device(read_chunk, zs, algorithm, (H, W), H,
                        max(len(zs), 1), type_max, torch.device(device))
