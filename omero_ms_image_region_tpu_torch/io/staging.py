"""Host-to-device staging of raw planes: packed uint16 uploads and plain
pinned copies.

Counterpart of the JAX package's ``io/staging.py`` (``pin_scope`` ``:126``,
``stage`` ``:141``, ``stage_deduped`` ``:173``, ``stage_ratio`` ``:203``).

Raw planes are filled into a page-locked (pinned) host buffer and copied to
the card with a ``non_blocking`` copy on the current CUDA stream: the DMA
engine reads pinned memory directly, where a copy from pageable memory goes
through a staging bounce buffer first.  Pinned buffers come from PyTorch's
caching host allocator: ``torch.empty(..., pin_memory=True)`` hands out
again a freed block of the same size class, so no request pays
``cudaHostAlloc`` once the pool is warm, and a block that a
``non_blocking`` copy read goes back to the pool only after that copy's
event (the copy records it).

**Packed staging** (:func:`stage`): a uint16 array that the JAX ``stage``
would pack is packed on the host by ``native/wirepack.cpp`` (block
bit-packed zigzag row deltas; :func:`pack16_host`), its words and widths
cross in one pinned copy, and K10 (``kernels.staging.unpack16``, on a CUDA
tensor; :func:`unpack16_plain` on a CPU one) decodes them on the card.
The decisions are JAX's, so both packages pack the same planes: uint16
only, at least :data:`_MIN_STAGE_BYTES`, at most
:data:`_MAX_STAGE_SAMPLES`, a shape on the tile lattice
(:func:`_regular_shape`), and the packed bytes, judged at the words'
ladder-padded length (:func:`_pad_words`), under ``1 / min_ratio`` of the
raw ones.  The port ships the words unpadded (the pad is a compile-cache
device of the JAX program; K10 compiles once), but judges as JAX does.
Anything else takes the plain pinned copy.  A packer that does not build
raises: nothing falls back.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

# Storage dtypes the kernels read; uint16 crosses as an int16 view (torch's
# uint16 has few CPU and CUDA ops).
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.uint16): torch.int16,
                 np.dtype(np.float32): torch.float32}


def storage_dtype(dtype) -> np.dtype:
    """The dtype raw planes are staged in: uint8, uint16 and float32 keep
    theirs (the kernels widen in registers); any other pixel type becomes
    float32, the value the JAX package's on-device cast gives."""
    dtype = np.dtype(dtype)
    return dtype if dtype in _TORCH_DTYPES else np.dtype(np.float32)


@contextlib.contextmanager
def pin_scope(device):
    """Run the enclosed CUDA work with ``device`` as the current device;
    ``None`` or a CPU device yields straight through."""
    if device is None or torch.device(device).type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        yield


class HostPlanes:
    """Raw planes in a host buffer the card copies from directly: pinned
    when ``device`` is CUDA, plain memory on the CPU.  Fill :attr:`array`
    (numpy, the storage dtype), then :meth:`upload`."""

    def __init__(self, shape: Sequence[int], dtype,
                 device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.dtype = storage_dtype(dtype)
        self.buffer = torch.empty(
            tuple(shape), dtype=_TORCH_DTYPES[self.dtype],
            pin_memory=self.device.type == "cuda")
        self.array = self.buffer.numpy().view(self.dtype)

    def upload(self) -> torch.Tensor:
        """The planes as a tensor on the device (uint16 as
        ``torch.uint16``).  On CUDA: a ``non_blocking`` copy on the current
        stream, so later work on that stream sees the planes and work on
        another stream must wait for it.  On the CPU: the buffer itself."""
        if self.device.type == "cpu":
            out = self.buffer
        else:
            out = torch.empty(self.buffer.shape, dtype=self.buffer.dtype,
                              device=self.device)
            out.copy_(self.buffer, non_blocking=True)
        return out.view(torch.uint16) if self.dtype == np.uint16 else out


def read_pinned(src, z: int, t: int, region, level: int,
                channels: Sequence[int],
                device: Union[str, torch.device]) -> HostPlanes:
    """Read the ``channels``' planes of one region of ``src`` (a
    ``PixelSource``) straight into a pinned buffer, [C, h, w] in the
    storage dtype: each reader fills its row of the buffer (``out=``), so
    a cold read is copied once before the DMA."""
    planes = HostPlanes((len(channels), region.height, region.width),
                        src.dtype, device)
    for i, c in enumerate(channels):
        src.get_region(z, c, t, region, level, out=planes.array[i])
    return planes


# The JAX words arrays pad up to one of these lengths (its unpack program
# compiles per padded length); ratio 2**(1/4): at most ~19 % of padding.
_LADDER_RATIO = 2.0 ** 0.25
_LADDER_FLOOR = 4096          # words


def _pad_words(n: int) -> int:
    """The ladder length the JAX package ships ``n`` words at."""
    if n <= _LADDER_FLOOR:
        return _LADDER_FLOOR
    steps = math.ceil(math.log(n / _LADDER_FLOOR, _LADDER_RATIO))
    return int(math.ceil(_LADDER_FLOOR * _LADDER_RATIO ** steps))


# Below this size the decode's launch costs more than the bytes saved.
_MIN_STAGE_BYTES = 1 << 20
# The JAX decode computes bit offsets in int32; past this many samples
# the packed bit count could pass 2**31, so bigger arrays cross plain (in
# both packages, so the decisions stay equal; K10 counts words in 32 bits,
# which the gate keeps under 2**31).
_MAX_STAGE_SAMPLES = (1 << 31) // 18


def _regular_shape(shape) -> bool:
    """The JAX package's tile lattice: rows % 64 == 0, width % 256 == 0,
    at most 64 leading planes (bucketed tiles and tile-snapped bands; an
    arbitrary client region crosses plain)."""
    h, w = shape[-2], shape[-1]
    lead = 1
    for s in shape[:-2]:
        lead *= s
    return h % 64 == 0 and w % 256 == 0 and lead <= 64


def pack16_host(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(words u32[n], widths u8[rows * ceil(W / 32)])`` of a uint16
    array, by the native packer (built on first use; a build failure
    raises)."""
    from ..native import wirepack_pack16
    return wirepack_pack16(arr)


def pack_for_stage(arr: np.ndarray, min_ratio: float = 1.1
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The packed words and widths of ``arr`` when the JAX ``stage`` would
    ship it packed, else None (the plain copy)."""
    if (not isinstance(arr, np.ndarray) or arr.dtype != np.uint16
            or arr.nbytes < _MIN_STAGE_BYTES or arr.ndim < 2
            or arr.size > _MAX_STAGE_SAMPLES
            or not _regular_shape(arr.shape)):
        return None
    words, widths = pack16_host(arr)
    # The bytes that cross in the JAX package: the words at their ladder
    # length.
    packed_bytes = _pad_words(len(words)) * 4 + widths.nbytes
    if packed_bytes * min_ratio > arr.nbytes:
        return None
    return words, widths


def unpack16_plain(words: torch.Tensor, widths: torch.Tensor,
                   shape: Sequence[int]) -> torch.Tensor:
    """The plain version of K10 (the JAX ``unpack16_device``'s arithmetic,
    offsets in 64 bits): ``words`` 32-bit [n], ``widths`` u8 [rows *
    ceil(W / 32)] -> uint16 ``shape`` (an int16 tensor viewed as
    ``torch.uint16``), on the inputs' device."""
    W = int(shape[-1])
    n_rows = 1
    for s in shape[:-1]:
        n_rows *= int(s)
    bpr = (W + 31) // 32
    dev = words.device
    w = widths.to(torch.int64)
    bits = w * 32
    off = torch.cumsum(bits, 0) - bits
    col = torch.arange(W, device=dev)
    b = torch.arange(n_rows, device=dev)[:, None] * bpr + col // 32
    wb = w[b]
    pos = off[b] + (col % 32) * wb
    wi = pos >> 5
    sh = pos & 31
    n = words.numel()
    words64 = words.to(torch.int64) & 0xFFFFFFFF
    if n == 0:
        words64 = torch.zeros(1, dtype=torch.int64, device=dev)
    lo = torch.where(wi < n, words64[wi.clamp(max=max(n - 1, 0))] >> sh, 0)
    nxt = words64[(wi + 1).clamp(max=max(n - 1, 0))]
    hi = torch.where((sh > 0) & (wi + 1 < n),
                     (nxt << (32 - sh)) & 0xFFFFFFFF, 0)
    mask = torch.where(wb >= 32, 0xFFFFFFFF,
                       (1 << wb.clamp(max=31)) - 1)
    z = (lo | hi) & mask
    d = (z >> 1) ^ -(z & 1)
    x = torch.cumsum(d, 1) & 0xFFFF
    return x.to(torch.int32).to(torch.int16).reshape(
        tuple(int(s) for s in shape)).view(torch.uint16)


def unpack16(words: torch.Tensor, widths: torch.Tensor,
             out: torch.Tensor) -> torch.Tensor:
    """Decode into ``out`` (int16 or uint16 [..., h, W], rows contiguous,
    possibly a view of rows of a larger tensor): K10 on a CUDA tensor, the
    plain version on a CPU one."""
    if out.device.type == "cuda":
        from ..kernels import staging as kernels
        return kernels.unpack16(words, widths, out)
    out.copy_(unpack16_plain(words, widths, out.shape).view(out.dtype))
    return out


def pinned_copy(arr: np.ndarray, device: Union[str, torch.device],
                out: Optional[torch.Tensor] = None,
                planes: Optional[HostPlanes] = None) -> torch.Tensor:
    """Host array -> tensor on ``device`` through a pinned buffer (one host
    copy into it, none when ``planes`` already holds ``arr``, and one DMA
    out of it), in the storage dtype (uint16 as ``torch.uint16``), queued
    on the current stream: where JAX hands an array to the device as it
    is.  ``out`` (the storage dtype, uint16 as int16, of ``arr``'s shape)
    takes the result in place of a new tensor."""
    if planes is None:
        planes = HostPlanes(arr.shape, arr.dtype, device)
        np.copyto(planes.array, arr)
    if out is None:
        return planes.upload()
    out.copy_(planes.buffer, non_blocking=True)
    return _storage_view(out)


def stage(arr: np.ndarray, device: Union[str, torch.device],
          min_ratio: float = 1.1, out: Optional[torch.Tensor] = None,
          planes: Optional[HostPlanes] = None) -> torch.Tensor:
    """The JAX ``stage``: host array -> tensor on ``device`` in the storage
    dtype (uint16 as ``torch.uint16``), queued on the current stream.

    Packed (:func:`pack_for_stage`): the words and widths cross in one
    pinned copy and K10 decodes them.  Else :func:`pinned_copy`.  ``out``
    (int16 for uint16 planes, of ``arr``'s shape; rows contiguous, e.g. a
    band's rows of a larger stack) takes the result in place of a new
    tensor."""
    device = torch.device(device)
    packed = pack_for_stage(arr, min_ratio)
    if packed is None:
        return pinned_copy(arr, device, out=out, planes=planes)
    words, widths = packed
    cuda = device.type == "cuda"
    buf = torch.empty(words.nbytes + widths.nbytes, dtype=torch.uint8,
                      pin_memory=cuda)
    host = buf.numpy()
    host[:words.nbytes] = words.view(np.uint8)
    host[words.nbytes:] = widths
    on_dev = buf.to(device, non_blocking=True) if cuda else buf
    if out is None:
        out = torch.empty(arr.shape, dtype=torch.int16, device=device)
    unpack16(on_dev[:words.nbytes].view(torch.int32),
             on_dev[words.nbytes:], out)
    return _storage_view(out)


def _storage_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint16) if t.dtype == torch.int16 else t


def stage_deduped(arr: np.ndarray, cache, digest: Optional[str] = None):
    """Digest-first staging into ``cache`` (an ``io.devicecache
    .DeviceRawCache`` with its digest index on): ``(tensor, digest,
    was_resident)``.  Content already on the card under any key crosses
    no byte (``was_resident``); else it stages through :func:`stage`
    (packed when JAX would pack it) under its content key
    (``plane_key``), so the next push of the same content skips the copy.
    The sidecar's ``plane_put`` (``server.sidecar``) stages through
    here."""
    from ..utils import telemetry
    from .devicecache import plane_digest, plane_key

    digest = digest or plane_digest(arr)
    resident = cache.get_by_digest(digest)
    if resident is not None:
        cache.count_plane(hit=True)
        telemetry.add_cost("staged_bytes_skipped", arr.nbytes)
        return resident, digest, True
    staged = cache.get_or_load(plane_key(digest), lambda: arr,
                               digest=digest)
    return staged, digest, False


def stage_ratio(arr: np.ndarray) -> float:
    """Packed over raw bytes of ``arr`` (1.0: raw), unpadded."""
    words, widths = pack16_host(arr)
    return (words.nbytes + widths.nbytes) / arr.nbytes


def use_on_current_stream(t: torch.Tensor) -> torch.Tensor:
    """Mark a CUDA tensor that was made on another stream (a raw-cache
    entry) as used by this thread's current stream: the caching allocator
    then hands its memory out again only after the work queued here, even
    if its owner drops it first."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t
