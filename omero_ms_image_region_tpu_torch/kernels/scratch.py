"""The status scratch of the kernels' decoupled look-backs: K10
(``staging.unpack16``) and K6 (``jpeg.bitpack_fixed``).

Each CTA of such a launch publishes a uint64 status word (its aggregate,
then its inclusive prefix) that later CTAs read.  A status word is ``epoch
<< 34 | flag << 32 | value``: :func:`status_scratch` keeps one scratch per
device and stream, since calls on one stream run one after another and
calls on two streams (the batcher's lanes, the raw cache's stream) may run
at once, and hands each call on it a new epoch, so a word of an earlier
call never reads as ready and the scratch needs no clearing between calls.
The two kernels share a stream's scratch: their calls on it are ordered
too, and each takes its own epoch.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

# A status word holds the epoch in its top 30 bits; epoch 0 marks a
# zeroed word and is never given to a call.
EPOCH_LIMIT = 1 << 30
_MIN_ENTRIES = 256

# (device index, stream handle) -> [status scratch, last epoch given]
_scratch: Dict[Tuple[int, int], list] = {}
_scratch_lock = threading.Lock()


def scratch_entries(entries: int) -> int:
    """The status words a scratch for ``entries`` CTAs is made with: the
    next power of two, at least :data:`_MIN_ENTRIES`, so a stream's
    scratch is remade a few times at most."""
    return max(_MIN_ENTRIES, 1 << max(entries - 1, 0).bit_length())


def status_scratch(device: torch.device, stream_key: int,
                   entries: int) -> Tuple[torch.Tensor, int]:
    """The status scratch of (``device``, ``stream_key``) with room for
    ``entries`` words and the epoch of the next call on it.  A new scratch
    is zeroed on the current stream (the caller's launch stream, so the
    caching allocator hands its memory on only behind that stream's work);
    when the epochs run out it is zeroed again and they start over at 1."""
    key = (-1 if device.index is None else device.index, stream_key)
    with _scratch_lock:
        entry = _scratch.get(key)
        if entry is None or entry[0].numel() < entries:
            entry = [torch.zeros(scratch_entries(entries), dtype=torch.int64,
                                 device=device), 0]
            _scratch[key] = entry
        entry[1] += 1
        if entry[1] >= EPOCH_LIMIT:
            entry[0].zero_()
            entry[1] = 1
        return entry[0], entry[1]
