#!/usr/bin/env python3
"""K10 (``unpack16``) of a parent commit beside this tree's, checked and
timed in one process on the card.

    python3 scripts/k10_redesign.py [--parent REV] [--sweep]

Where git is (any machine): the parent's ``kernels/csrc/staging.cu`` at
``REV`` (default ``HEAD``, the parent while the change is uncommitted) is
written into the git-ignored ``kernels/_build/`` directory, which travels
with a copy of the tree to a machine without git.  Without a card it stops
there (exit code 2).  On the card it builds both sources (one nvcc each,
at once), prints their ptxas lines and, on each of ``chip_smoke.py``'s K10
cases (``chip_smoke.k10_cases``), checks both against the source array
byte for byte and times them in turns, parent, change, change, parent:
``chip_smoke.time_ms``, the median of 25 launches, each after an L2
flush.  The parent's design is three launches (row bits, a one-CTA offset
scan, a CTA a row) on an int64 scratch of one word a row; the change's is
the wrapper's one launch over its status scratch.  Beside them: the bound
(words and widths read, 2 bytes a sample written, over HBM) and the
change's device time with the L2 warm (``chip_smoke.device_split``).

Two yardsticks of the same harness: ``floor_ms``, ``time_ms`` of one
trivial launch (a 4-byte ``zero_()``), the least any one-launch kernel
shows there; and per case ``copy_ms``, a ``dst.copy_(src)`` of half the
counted bytes (it reads and writes them all).

``--sweep`` also times variants of this tree's source, each built beside
it: 4 or 16 rows a CTA instead of 8 (``rows4``, ``rows16``); ``shfl``,
the decode the design started from (a lane a sample, a block's words
loaded by its first w lanes and read with two shuffles, a warp scan a
block) in place of the shared-memory decode; and ``no_lookback``, a
diagnostic that skips the look-back (its output is wrong past the first
tile; its time shows what the look-back costs).  It prints one JSON line
a case, the nvidia-smi line (the card's name and power limit) and a JSON
line of all.  A mismatch of the parent or the change raises; a variant's
is printed.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from redesign import means, parent_source, turns  # noqa: E402

SHFL_DECODE = r"""    // decode: a lane a sample, a block's words in registers
    const unsigned off_l = incl - w;
    for (int k = 0; k < nb; ++k) {
      const unsigned bw = __shfl_sync(kFull, w, k);
      const unsigned off = __shfl_sync(kFull, off_l, k);
      const unsigned long long i =
          static_cast<unsigned long long>(base) + off + lane;
      const unsigned word = lane < bw && i < n_words ? __ldg(words + i) : 0u;
      const unsigned bit = lane * bw, wi = bit >> 5, sh = bit & 31u;
      const unsigned lo = __shfl_sync(kFull, word, wi & 31u);
      const unsigned hi = __shfl_sync(kFull, word, (wi + 1u) & 31u);
      unsigned z = 0u;
      if (bw != 0u) {
        unsigned v = lo >> sh;
        if (sh != 0u && sh + bw > 32u) v |= hi << (32u - sh);
        z = v & ((1u << bw) - 1u);
      }
      const unsigned x = carry + warp_incl(unzigzag(z), lane);
      const int col = col0 + k * 32 + lane;
      if (col < width) orow[col] = static_cast<uint16_t>(x);
      carry = __shfl_sync(kFull, x, 31);
    }
"""


def _sub(old: str, new: str):
    def apply(text: str) -> str:
        if old not in text:
            raise RuntimeError(f"the source has no {old!r}")
        return text.replace(old, new)
    return apply


def _shfl(text: str) -> str:
    begin, end = "    // decode: begin", "    // decode: end\n"
    if begin not in text or end not in text:
        raise RuntimeError("the source has no decode markers")
    return (text[:text.index(begin)] + SHFL_DECODE
            + text[text.index(end) + len(end):])


VARIANTS = {
    "rows4": _sub("constexpr int kTileRows = 8;",
                  "constexpr int kTileRows = 4;"),
    "rows16": _sub("constexpr int kTileRows = 8;",
                   "constexpr int kTileRows = 16;"),
    "shfl": _shfl,
    "no_lookback": _sub("for (long long i = tile - 1;; i -= 32) {",
                        "for (long long i = tile - 1; false; i -= 32) {"),
}


def configure_parent(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.unpack16_launch.argtypes = [p, ll, p, ll, i, i, ll, ll, p, p, p]
    lib.unpack16_launch.restype = ctypes.c_int


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="HEAD")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    from omero_ms_image_region_tpu_torch.kernels import build
    parent = parent_source(build.BUILD_DIR, "k10", args.parent, "staging.cu")
    import torch
    if not torch.cuda.is_available():
        print(f"k10_redesign: the parent's source is in {parent}; timing "
              f"needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (bytes_bound, device_split, k10_cases, k10_inputs,
                            smi_line, time_ms)
    from omero_ms_image_region_tpu_torch.kernels import staging as KS

    text = KS.SOURCE.read_text()
    sources = {"parent": parent.read_text(), "change": text}
    for tag, make in (VARIANTS.items() if args.sweep else ()):
        sources[tag] = make(text)
    paths = {}
    for name, code in sources.items():
        digest = hashlib.sha256(code.encode()).hexdigest()[:10]
        paths[name] = build.BUILD_DIR / f"k10_{name}_{digest}_staging.cu"
        paths[name].write_text(code)
    build.build_all([(p, KS.NVCC_FLAGS) for p in paths.values()])
    libs = {}
    for name, path in paths.items():
        lib_path, _ = build.build(path, KS.NVCC_FLAGS)
        for line in build.build_log(path.name).splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(lib_path))
        (configure_parent if name == "parent" else KS._configure)(lib)
        libs[name] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(name, w_t, wd_t, view):
        lib = libs[name]
        planes = view if view.dim() == 3 else view.view(
            -1, view.shape[-2], view.shape[-1])
        n_rows = planes.shape[0] * planes.shape[1]
        W = planes.shape[2]
        if name == "parent":
            row_off = torch.empty(n_rows, dtype=torch.int64, device=dev)
        else:
            tiles = KS.tile_count(w_t.numel(), n_rows,
                                  lib.unpack16_tile_rows())

        def launch():
            if name == "parent":
                extra = (row_off.data_ptr(),)
            else:
                status, epoch = KS.status_scratch(dev, stream, tiles)
                extra = (status.data_ptr(), epoch)
            err = lib.unpack16_launch(
                w_t.data_ptr(), w_t.numel(), wd_t.data_ptr(), n_rows, W,
                planes.shape[1], planes.stride(0), planes.stride(1),
                planes.data_ptr(), *extra, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed: CUDA error {err}")
        return launch

    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = {"floor_ms": time_ms(torch, tiny.zero_, 25),
             "floor_warm_us": sum(device_split(torch, tiny.zero_).values())}
    print("k10 " + json.dumps(floor), flush=True)
    rows_out = []
    for label, arr, rows, layout in k10_cases(np):
        w_t, wd_t = k10_inputs(torch, np, arr, layout)
        source = torch.from_numpy(arr.view(np.int16)).to(dev)
        big = (torch.zeros((4,) + arr.shape[1:-2] + (1024, 1024),
                           dtype=torch.int16, device=dev)
               if rows is not None else None)
        view = big[rows] if big is not None else torch.empty(
            arr.shape, dtype=torch.int16, device=dev)
        launches = {name: launcher(name, w_t, wd_t, view) for name in libs}
        row = {"case": label, "shape": list(arr.shape)}
        for name, launch in launches.items():
            view.zero_()
            launch()
            torch.cuda.synchronize()
            diff = int((view != source).sum())
            row[f"{name}_differing"] = diff
            if diff and name in ("parent", "change"):
                raise RuntimeError(f"{name} differs from the source on "
                                   f"{label}: {diff} samples")
        got = turns(lambda fn: time_ms(torch, fn, 25), launches)
        row.update(means(got))
        row["turns_ms"] = got
        for name in sources:
            if name not in ("parent", "change"):
                row[f"{name}_ms"] = time_ms(torch, launches[name], 25)
        n_bytes = w_t.numel() * 4 + wd_t.numel() + arr.size * 2
        row["bound_ms"] = bytes_bound(n_bytes)[0]
        src = torch.empty(n_bytes // 32 * 16, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        row["copy_ms"] = time_ms(torch, lambda: dst.copy_(src), 25)
        del src, dst
        row["change_warm_us"] = device_split(torch, launches["change"])
        row["parent_warm_us"] = device_split(torch, launches["parent"])
        print("k10 " + json.dumps(row), flush=True)
        rows_out.append(row)
        del w_t, wd_t, source, big, view, launches
        torch.cuda.empty_cache()
    smi = smi_line()
    print(smi, flush=True)
    print(json.dumps({"k10_redesign": rows_out, **floor, "card": smi,
                      "parent": args.parent}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
