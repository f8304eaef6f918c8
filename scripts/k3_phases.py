#!/usr/bin/env python3
"""Where the time of the port's K3 kernel (``jpeg_coefficients_kernel`` in
``omero_ms_image_region_tpu_torch/kernels/csrc/jpeg.cu``) goes.

    python3 scripts/k3_phases.py [--ablate] [path/to/jpeg.cu ...]   # card

For each source (default: the port's jpeg.cu) it times the kernel on the
flagship tiles' packed RGBA at q 85, B=8 and B=1 (``chip_smoke.time_ms``:
median of 25 launches, CUDA events, the L2 flushed before each), and
checks the coefficients against ``packed_to_jpeg_coefficients_plain``.
It also builds a copy of the kernel's MCU-pair loop (its three barriers)
in which every thread reads ``clock64()`` after each barrier and at the
top of the loop, and thread 0 of each block (a DCT thread) keeps the
cycles of
each phase: wait (up to the first barrier: warp 3's wait for this pair's
pixels and its stores of the last pair's coefficients), colour (YCbCr and
the 2x2 chroma sums into shared memory), pass1 (while warp 3 fetches the
next pair), pass2 (with quantize and zigzag; thread 0's own, up to the
loop's top), tail (the last pair's stores) and prologue (the table
staging).  A phase that ends at a barrier lasts as long as its slowest
warp.
It prints each phase's share of the blocks' cycles, its median cycles per
MCU pair, and the SM clock nvidia-smi reads after the run.  The phases are
of the clock-carrying copy (one more barrier a pair), not of the kernel.
It also times the source's K4b (``compact_rows``) on the wire of those
coefficients at the default cap, and checks it against
``compact_rows_plain``.  Give another jpeg.cu of the same design as a
second path to time both versions in one run; a source without the lines
the copies are built from stops the script.
``--ablate`` also times two broken copies of each source, unchecked: one
that skips the 16-byte pixel copies (``no_load``), and one that drops the
coefficient stores (``no_store``); what each saves is what that traffic
costs.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("wait", "colour", "pass1", "pass2", "tail", "prologue")
KERNEL = "jpeg_coefficients_kernel(const int32_t* __restrict__ packed,"
HEAD = "  const long long hw = static_cast<long long>(h) * w;\n"
LOOP = re.compile(r"  for \(; p < pairs; p \+= [^)]*\) \{\n")
SYNC = "    __syncthreads();\n"
LOAD = ("          cp_async16(&strip[buf][i], "
        "row + (flip_h ? w - 4 - fx0 : fx0));\n")
STORE = "      reinterpret_cast<uint4*>(dst)[lane & 7] =\n"


def ablated(src: str):
    """{name: source} of the ablation copies."""
    if LOAD not in src or STORE not in src:
        raise RuntimeError("no K3 pixel copy or coefficient store line to "
                           "ablate: the source is of another design")
    return {"no_load": src.replace(LOAD, "          (void)row;\n"),
            "no_store": src.replace(STORE, "      if (flip_h == 12345) "
                                    + STORE)}


def timed_source(src: str):
    """jpeg.cu with phase clocks in K3's loop and set_marks()."""
    start = src.index(KERNEL)
    end = src.index("\n}\n", start)
    body = src[start:end]
    loop = LOOP.search(body)
    if HEAD not in body or not loop or body.count(SYNC) != 3:
        raise RuntimeError("no K3 MCU-pair loop with three barriers to "
                           "time: the source is of another design")
    loop = loop.group(0)
    body = body.replace(HEAD, HEAD + """  long long ph_last = clock64(), ph_acc[6] = {0, 0, 0, 0, 0, 0};
  long long iters = 0;
  auto phase = [&](int k) {
    const long long now = clock64();
    ph_acc[k] += now - ph_last;
    ph_last = now;
  };
""", 1)
    body = body.replace(loop, "  phase(5);\n" + loop
                        + "    phase(3);\n    ++iters;\n", 1)
    parts = body.split(SYNC)
    body = "".join(part + SYNC + f"    phase({n});\n"
                   for n, part in enumerate(parts[:-1])) + parts[-1]
    body += """
  phase(4);
  if (threadIdx.x == 0 && g_marks) {
    for (int i = 0; i < 6; ++i) g_marks[8 * blockIdx.x + i] = ph_acc[i];
    g_marks[8 * blockIdx.x + 6] = iters;
  }"""
    src = src[:start] + body + src[end:]
    src = src.replace("namespace {", """__device__ long long* g_marks;
namespace {""", 1)
    return src + """
extern "C" int set_marks(void* p) {
  return cudaMemcpyToSymbol(g_marks, &p, sizeof(p));
}
"""


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(argv) -> int:
    import torch

    ablate = "--ablate" in argv
    argv = [a for a in argv if a != "--ablate"]

    if not torch.cuda.is_available():
        print("k3_phases: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import L2_FLUSH_BYTES, SLEEP_CYCLES, time_ms
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.kernels import build
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R

    dev = torch.device("cuda")
    raw = R.raw_to_tensor(
        synthetic_wsi_tiles(np.random.default_rng(0), 8, 4, 1024, 1024), dev)
    s = R.settings_to_tensors(R.pack_settings(flagship_rdef(4)), dev)
    packed8 = R.render_tile_batch_packed(raw, *R.batched_settings(s, 8))
    q = 85
    tables = J.device_tables(q, dev)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    sources = [Path(a).resolve() for a in argv] or [KJ.SOURCE]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for i, src in enumerate(sources):
        name = str(src.relative_to(ROOT) if src.is_relative_to(ROOT)
                   else src)
        text = src.read_text()
        copies = {"plain": text, "timed": timed_source(text)}
        if ablate:
            copies.update(ablated(text))
        libs = {}
        for kind, code in copies.items():
            path = build.BUILD_DIR / f"k3_{kind}{i}_jpeg.cu"
            path.write_text(code)
            lib_path, log = build.build(path, KJ.NVCC_FLAGS)
            lines = log.splitlines()
            for n, line in enumerate(lines):
                if "Compiling entry" in line and "jpeg_coefficients" in line:
                    print(f"ptxas {name} {kind}: " + " | ".join(
                        ln.strip() for ln in lines[n + 1:n + 4]), flush=True)
            lib = ctypes.CDLL(str(lib_path))
            KJ._configure(lib)
            if kind == "timed":
                lib.set_marks.argtypes = [ctypes.c_void_p]
            libs[kind] = lib
        row = {}
        for B in (8, 1):
            packed = packed8[:B].contiguous()
            mh = mw = 1024 // 16
            y = torch.empty((B, 4 * mh * mw, 64), dtype=torch.int16,
                            device=dev)
            cb = torch.empty((B, mh * mw, 64), dtype=torch.int16, device=dev)
            cr = torch.empty_like(cb)

            def launch(lib):
                err = lib.jpeg_coefficients_launch(
                    packed.data_ptr(), B, 1024, 1024, mh, mw, 0, 0,
                    tables.data_ptr(), y.data_ptr(), cb.data_ptr(),
                    cr.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            want = J.packed_to_jpeg_coefficients_plain(packed, q)
            times = time_ms(torch, lambda: launch(libs["plain"]), 25)
            exact = all(torch.equal(g, w) for g, w in zip((y, cb, cr), want))
            r = {"ms": times, "exact": exact}
            for kind in ("no_load", "no_store"):
                if kind in libs:
                    r[kind + "_ms"] = time_ms(
                        torch, lambda: launch(libs[kind]), 25)
            blocks = 132 * 16
            marks = torch.zeros((blocks, 8), dtype=torch.int64,
                                device=dev)
            libs["timed"].set_marks(marks.data_ptr())
            for _ in range(4):
                flush.zero_()
                torch.cuda._sleep(SLEEP_CYCLES)
                launch(libs["timed"])
            torch.cuda.synchronize()
            libs["timed"].set_marks(None)
            r["exact_timed"] = all(torch.equal(g, w) for g, w in
                                   zip((y, cb, cr), want))
            m = marks.cpu().numpy()
            m = m[m[:, 6] > 0].astype(np.float64)
            total = m[:, :6].sum()
            r["blocks"] = len(m)
            r["pairs_per_block"] = float(np.median(m[:, 6]))
            r["cycles_per_block"] = float(np.median(m[:, :6].sum(1)))
            for k, ph in enumerate(PHASES):
                r[ph] = {"share": float(m[:, k].sum() / total),
                         "cycles_per_pair": float(np.median(
                             m[:, k] / m[:, 6]))}
            # K4b of the same source on these coefficients' wire.
            cap = J.default_sparse_cap(1024, 1024, q)
            nb = J.blocks_per_tile(1024, 1024)
            wire = J.sparse_pack(y, cb, cr, cap)
            comp = torch.empty((4 * B + wire.numel(),), dtype=torch.uint8,
                               device=dev)
            lib = libs["plain"]

            def launch_k4b():
                err = lib.compact_rows_launch(
                    wire.data_ptr(), B, wire.shape[1], B, cap, nb,
                    KJ.SPARSE_ROWS, 0, comp.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            r["k4b_ms"] = time_ms(torch, launch_k4b, 25)
            r["k4b_exact"] = torch.equal(comp, J.compact_rows_plain(
                wire, J.sparse_row_lengths(wire, B, cap, nb)))
            row[f"B={B}"] = r
            print(f"k3 {name} B={B}: " + json.dumps(r), flush=True)
            if not (r["exact"] and r["k4b_exact"] and r["exact_timed"]):
                raise RuntimeError(f"{name} B={B}: the coefficients differ "
                                   f"from the plain version")
        out[name] = row
    print("smi: " + sm_clock(), flush=True)
    print(json.dumps({"k3_phases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
