"""Device-to-host link probe: pick the JPEG wire engine for this link.

The port's copy of the JAX package's ``utils/linkprobe.py``.  The two
batched wire engines trade device work against wire bytes
(``ops/jpegenc.py``): "sparse" ships ~0.29 MB a 1024² tile and packs in
one kernel; "huffman" codes the entropy stream on the card (K5, ~3x fewer
bytes).  The sparse wire wins when the link carries its extra bytes faster
than the Huffman engine renders; the crossover is the JAX package's,
``AUTO_SPARSE_MIN_MB_S``.  ``renderer.jpeg-engine: auto`` measures the link
at startup (and ``utils.adaptive`` keeps measuring it).

Measured here with pinned copies: a distinct random buffer on the card
each repeat, copied into a pinned host buffer and synchronized (the best
of ``repeats``), in place of the JAX package's ``jax.device_get``.  On a
CPU device the copy is a host memcpy.  On a pod (``parallel.cluster``:
joined, more than one rank) every rank probes its own GPU's link and the
pod-wide minimum decides, as in JAX: the rates are all-gathered over gloo
(host tensors), so every rank picks the same engine.
"""

from __future__ import annotations

import logging
import time
from typing import Union

import torch

logger = logging.getLogger(__name__)

# Crossover (MB/s) above which the sparse wire out-runs the Huffman
# engine (the JAX package's constant).
AUTO_SPARSE_MIN_MB_S = 12.0


def measure_fetch_mb_s(nbytes: int = 4 << 20, repeats: int = 3,
                       device: Union[str, torch.device] = "cuda") -> float:
    """Best-of-``repeats`` device-to-host copy rate in MB/s."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    pinned = device.type == "cuda"
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
    best = float("inf")
    for _ in range(repeats):
        x = torch.randint(0, 255, (nbytes,), dtype=torch.uint8,
                          device=device, generator=gen)
        if pinned:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        host.copy_(x, non_blocking=pinned)
        if pinned:
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return nbytes / 1e6 / max(best, 1e-9)


def resolve_auto_engine(device: Union[str, torch.device] = "cuda") -> str:
    """Measure the link and return "sparse" or "huffman" (a failed probe
    reads as an unknown, fast link: sparse).

    Collective on a pod: every rank must call it, since each joins the
    all-gather of the rates, and the slowest link decides."""
    try:
        rate = measure_fetch_mb_s(device=device)
    except Exception:
        # No early return: on a pod every rank must still join the
        # all-gather below.  inf does not drag the pod minimum down.
        logger.warning("link probe failed; treating link rate as "
                       "unknown", exc_info=True)
        rate = float("inf")
    from ..parallel.mesh import joined, world_size
    if joined() and world_size() > 1:
        import torch.distributed as dist

        rates = [torch.zeros(1, dtype=torch.float64)
                 for _ in range(world_size())]
        dist.all_gather(rates, torch.tensor([rate], dtype=torch.float64))
        pod_rate = float(torch.cat(rates).min())
        logger.info("link probe (pod): local %.1f MB/s, pod min %.1f MB/s "
                    "across %d ranks", rate, pod_rate, len(rates))
        rate = pod_rate
    engine = "sparse" if rate >= AUTO_SPARSE_MIN_MB_S else "huffman"
    logger.info("link probe: %.1f MB/s device->host -> jpeg engine %r "
                "(crossover %.0f MB/s)", rate, engine, AUTO_SPARSE_MIN_MB_S)
    return engine
