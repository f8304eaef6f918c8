"""Startup prewarm: the builds and the first launch of every serving
kernel before ``/readyz`` says ready.

Counterpart of the JAX package's ``server/prewarm.py``.  There, every
``jit`` program compiles at its first use, and the prewarm compiles the
listed shapes' programs at startup.  In the port the first use pays two
other costs: the ``nvcc`` builds of ``kernels/csrc/*.cu`` and the ``g++``
builds of the native codecs (``kernels.build``, ``native``; tens of
seconds when nothing is built yet), and each kernel's first launch.  So
the prewarm does both:

1. builds every CUDA source (one ``nvcc`` each, all at once, on a card:
   ``render.cu``, ``jpeg.cu``, ``workloads.cu`` and ``staging.cu``) and
   the native codecs and the packer (one ``g++`` each), and loads them;
2. for each spec of ``renderer.prewarm``, gives K10 (the packed staging's
   decode) its first launch at the shapes a cold miss of the spec's tile
   stages (its bands, or the whole tile under two bands), once for each
   ladder length JAX ``prewarm.py:89-117`` compiles (the words of 0.35,
   0.55 and 0.8 of the raw bytes; K10 builds once, so these are first
   launches, not compiles), where the JAX ``stage`` would pack that shape;
3. launches the serving kernels
   once at every batch size the batcher launches (1 to ``max_batch``: it
   launches a group of n tiles at B = n), in the spec's bucket and storage
   dtype, with the renderer's wire engine(s): K1, then K3, then K4a and
   K4b for the sparse engine, K5 and K4b for the Huffman one (both under
   ``jpeg-engine: auto``).  The spec grammar has no LUT, so K2 is not
   launched; it lives in the library K1 does, built by step 1.

The app runs it on a background thread (``server.app.build_services``)
with ``telemetry.READINESS.prewarm_pending`` set, so the listener binds at
once and ``/readyz`` answers 503 ``pending`` until it is done.  Unlike the
JAX prewarm, which logs a failed compile and carries on (serving then
compiles lazily), a failed build or launch here is not swallowed: it is
logged with its traceback, ``READINESS.prewarm_failed`` keeps the reason,
and ``/readyz`` stays 503 with it: a kernel that cannot build or launch
cannot serve.  Specs at or below ``renderer.cpu-fallback-max-px`` are
skipped, as in JAX (the handler codes those regions with PIL after a
render).

Each spec is ``<channels>x<tile-edge>[@quality][:dtype]``, JAX's grammar
and errors (``parse_spec``)::

    renderer:
        prewarm: ["4x1024", "3x512@90", "2x1024:uint8"]
"""

from __future__ import annotations

import logging
import re
import time
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..codecs import DEFAULT_JPEG_QUALITY
from ..io.tiff import STORAGE_DTYPE_NAMES as _SPEC_DTYPES

logger = logging.getLogger(__name__)

_SPEC_RE = re.compile(r"^(\d+)x(\d+)(?:@(\d+))?(?::([a-z0-9]+))?$")


def parse_spec(spec: str) -> Tuple[int, int, int, np.dtype]:
    """``"4x1024[@90][:uint8]"`` -> (channels, edge, quality, dtype); the
    dtype names the images' storage dtype, uint16 by default."""
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"renderer.prewarm spec {spec!r} is not "
            f"'<channels>x<tile-edge>[@quality][:dtype]'")
    channels, edge, q = (int(m.group(1)), int(m.group(2)),
                         int(m.group(3)) if m.group(3)
                         else round(DEFAULT_JPEG_QUALITY * 100))
    if not (1 <= channels <= 64):
        raise ValueError(f"prewarm channels out of range: {spec!r}")
    if not (16 <= edge <= 8192) or edge % 16:
        raise ValueError(
            f"prewarm tile edge must be a multiple of 16 in "
            f"[16, 8192]: {spec!r}")
    if not (1 <= q <= 100):
        raise ValueError(f"prewarm quality out of range: {spec!r}")
    dt = m.group(4) or "uint16"
    if dt not in _SPEC_DTYPES:
        raise ValueError(
            f"prewarm dtype {dt!r} not one of {_SPEC_DTYPES}: {spec!r}")
    return channels, edge, q, np.dtype(dt)


def build_kernels(device: torch.device) -> None:
    """Build and load the native codecs and, on a card, the CUDA kernels
    (``nvcc`` and ``g++``, one process a source, all at once)."""
    import concurrent.futures as cf

    from .. import native

    with cf.ThreadPoolExecutor(2) as pool:
        host = pool.submit(native.build_all)
        if device.type == "cuda":
            from ..kernels import build, jpeg, render, staging, workloads

            modules = (render, jpeg, workloads, staging)
            build.build_all([(m.SOURCE, m.NVCC_FLAGS) for m in modules])
            for m in modules:
                m.library()
        host.result()
    native.library()
    native.wirepack_library()


def _warm_staging(C: int, edge: int, raw_dtype,
                  device: torch.device) -> None:
    """K10's first launches at the spec's cold-miss staging shapes."""
    from ..io import staging
    from .handler import _STAGE_BAND_ROWS, ImageRegionHandler
    from .region import RegionDef

    # Sources tiled at the band height: even bands.
    bounds = ImageRegionHandler._band_bounds(RegionDef(0, 0, edge, edge),
                                             _STAGE_BAND_ROWS)
    heights = sorted({y1 - y0 for y0, y1 in zip(bounds, bounds[1:])}
                     or {edge})
    for h in heights:
        shape = (C, h, edge)
        nbytes = C * h * edge * np.dtype(raw_dtype).itemsize
        if (np.dtype(raw_dtype) != np.uint16
                or nbytes < staging._MIN_STAGE_BYTES
                or C * h * edge > staging._MAX_STAGE_SAMPLES
                or not staging._regular_shape(shape)):
            continue
        widths = torch.zeros(C * h * ((edge + 31) // 32), dtype=torch.uint8,
                             device=device)
        out = torch.empty(shape, dtype=torch.int16, device=device)
        for f in (0.35, 0.55, 0.8):
            n_words = staging._pad_words(int(nbytes // 4 * f))
            staging.unpack16(torch.zeros(n_words, dtype=torch.int32,
                                         device=device), widths, out)


def _warm_one(C: int, edge: int, quality: int, batch_sizes: Sequence[int],
              engines: Sequence[str], buckets, raw_dtype,
              device: torch.device) -> None:
    from ..flagship import flagship_rdef
    from ..io.staging import storage_dtype
    from ..ops import render as R
    from ..ops.jpegenc import render_batch_to_jpeg
    from .batcher import pick_bucket

    bh, bw = pick_bucket(edge, edge, buckets)
    settings = R.settings_to_tensors(R.pack_settings(flagship_rdef(C)),
                                     device)
    for B in batch_sizes:
        raw = R.raw_to_tensor(np.zeros((B, C, bh, bw),
                                       storage_dtype(raw_dtype)), device)
        args = R.batched_settings(settings, B)
        for engine in engines:
            # tune=False: an all-zero tile must never become the
            # workload's tuned Huffman tables.
            render_batch_to_jpeg(raw, *args, quality=quality,
                                 dims=[(edge, edge)] * B, engine=engine,
                                 tune=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prewarm_renderer(specs: List[str], engines: Sequence[str],
                     max_batch: int, buckets,
                     device: Union[str, torch.device],
                     cpu_fallback_max_px: int = 0) -> None:
    """Build the kernels, then launch the serving kernels of each spec at
    batch sizes 1 to ``max_batch`` (:mod:`server.prewarm`).  Clears
    ``READINESS.prewarm_pending`` when done; on a failure logs it and sets
    ``READINESS.prewarm_failed`` (``/readyz`` stays 503).  A malformed spec
    raises before anything starts."""
    from ..utils.telemetry import READINESS

    parsed = [(spec,) + tuple(parse_spec(spec)) for spec in specs]
    device = torch.device(device)
    READINESS.prewarm_pending = bool(specs)
    try:
        t0 = time.perf_counter()
        build_kernels(device)
        logger.info("prewarm: kernels built and loaded in %.1f s",
                    time.perf_counter() - t0)
        for spec, C, edge, quality, raw_dtype in parsed:
            if edge * edge <= cpu_fallback_max_px:
                logger.info(
                    "prewarm %s skipped: %dx%d px is at or below "
                    "renderer.cpu-fallback-max-px (%d)", spec, edge, edge,
                    cpu_fallback_max_px)
                continue
            t0 = time.perf_counter()
            _warm_staging(C, edge, raw_dtype, device)
            _warm_one(C, edge, quality, range(1, max_batch + 1), engines,
                      buckets, raw_dtype, device)
            logger.info("prewarmed %s (engines %s, batches 1-%d, %s) in "
                        "%.1f s", spec, "/".join(engines), max_batch,
                        np.dtype(raw_dtype).name, time.perf_counter() - t0)
    except Exception as e:
        first = (str(e).strip().splitlines() or [""])[0]
        READINESS.prewarm_failed = f"{type(e).__name__}: {first}"[:200]
        logger.error("prewarm failed; /readyz stays 503", exc_info=True)
    finally:
        READINESS.prewarm_pending = False
