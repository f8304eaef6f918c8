#!/usr/bin/env python3
"""Where the time of the port's K4a kernel (``sparse_pack_kernel`` in
``omero_ms_image_region_tpu_torch/kernels/csrc/jpeg.cu``) goes, per block.

    python3 scripts/k4a_phases.py        # on a CUDA card, from the repo root

It builds a copy of jpeg.cu in which thread 0 of each block stores
``%globaltimer`` at the ends of the kernel's phases (load and count, scan,
last entry and expansion, lookback, write), runs it on the flagship tiles'
q 85 coefficients at B=1 and B=8 with the L2 flushed first, checks the
wire against ``sparse_pack_plain``, and prints each phase's median, p90
and max over the blocks, the kernel's span, and how the blocks' start
times spread (the waves).  Times are of the timer-carrying copy, not of
the kernel itself; ``chip_smoke.py`` times that.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("load_count", "scan_last", "expand", "lookback", "write")
# Thread 0 stores the time where each of these lines starts, and at the end.
ANCHORS = (
    "  // The partition's scan (warps 0 .. kPartBlocks / 32 - 1), in place.",
    "  // Each nonzero to its entry, at its block's offset plus its rank.",
    "  // The entries of the tile's earlier partitions and the field of the",
    "  const long long o_start = excl, o_end = o_start + agg;",
)
HEAD = "  const int b = blockIdx.x / parts, i = blockIdx.x - b * parts;\n"


def timed_source(src: str) -> str:
    """jpeg.cu with phase marks in sparse_pack_kernel and set_marks()."""
    src = src.replace("namespace {", """__device__ unsigned long long* g_marks;
__device__ __forceinline__ void mark(int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  if (threadIdx.x == 0 && g_marks) g_marks[8 * blockIdx.x + k] = t;
}
namespace {""", 1)
    start = src.index("sparse_pack_kernel(const int16_t* __restrict__ y,")
    end = src.index("\n}\n", start)
    body = src[start:end]
    assert HEAD in body, "kernel head moved"
    body = body.replace(HEAD, HEAD + "  mark(0);\n", 1)
    for k, anchor in enumerate(ANCHORS, 1):
        assert anchor in body, f"anchor moved: {anchor!r}"
        body = body.replace(anchor, f"  mark({k});\n" + anchor, 1)
    body += "\n  mark(5);"
    return src[:start] + body + src[end:] + """
extern "C" int set_marks(void* p) {
  return cudaMemcpyToSymbol(g_marks, &p, sizeof(p));
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4a_phases: needs a CUDA card", file=sys.stderr)
        return 2
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.kernels import build
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R

    path = build.BUILD_DIR / "jpeg_phases.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(timed_source(KJ.SOURCE.read_text()))
    lib_path, _ = build.build(path, KJ.NVCC_FLAGS)
    lib = ctypes.CDLL(str(lib_path))
    KJ._configure(lib)
    lib.set_marks.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda")
    raw = R.raw_to_tensor(
        synthetic_wsi_tiles(np.random.default_rng(0), 8, 4, 1024, 1024), dev)
    s = R.settings_to_tensors(R.pack_settings(flagship_rdef(4)), dev)
    packed8 = R.render_tile_batch_packed(raw, *R.batched_settings(s, 8))
    q = 85
    cap = J.default_sparse_cap(1024, 1024, q)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for B in (1, 8):
        y, cb, cr = J.packed_to_jpeg_coefficients(
            packed8[:B].contiguous(), q)
        nby, nbc = y.shape[1], cb.shape[1]
        nb = nby + 2 * nbc
        width = 4 + nb + (J.ENTRY_BITS * cap + 7) // 8
        words = lib.sparse_pack_status_words(B, nb)
        buf = torch.empty(((B * width + 7) // 8 * 8 + 8 * words,),
                          dtype=torch.uint8, device=dev)
        marks = torch.zeros((words, 8), dtype=torch.int64, device=dev)
        lib.set_marks(marks.data_ptr())
        for _ in range(4):      # warm-up, then the flushed, measured run
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            err = lib.sparse_pack_launch(
                y.data_ptr(), cb.data_ptr(), cr.data_ptr(), B, nby, nbc, cap,
                buf.data_ptr(), width, words,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        lib.set_marks(None)
        if not torch.equal(buf[:B * width].view(B, width),
                           J.sparse_pack_plain(y, cb, cr, cap)):
            raise RuntimeError(f"B={B}: the wire differs from the plain one")
        t = marks.cpu().numpy()[:, :6].astype(np.float64) / 1e3   # us
        t -= t[:, 0].min()
        dur = np.diff(t, axis=1)
        row = {"blocks": len(t), "span_us": float(t[:, 5].max()),
               "start_us_median": float(np.median(t[:, 0])),
               "start_us_max": float(t[:, 0].max())}
        for k, name in enumerate(PHASES):
            row[name] = {"median_us": float(np.median(dur[:, k])),
                         "p90_us": float(np.percentile(dur[:, k], 90)),
                         "max_us": float(dur[:, k].max())}
        out[f"B={B}"] = row
        print(f"k4a phases B={B}: " + json.dumps(row), flush=True)
    print(json.dumps({"k4a_phases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
