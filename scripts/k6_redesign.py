#!/usr/bin/env python3
"""K6 (``bitpack_fixed``) of a parent commit beside this tree's, checked
and timed in one process on the card.

    python3 scripts/k6_redesign.py --parent REV [--sweep]

Where git is (any machine): the parent's ``kernels/csrc/jpeg.cu`` at
``REV`` (the commit to compare against, e.g. ``HEAD`` while the change is
uncommitted or ``HEAD~1`` once it is) is written into the git-ignored
``kernels/_build/`` directory, which travels with a copy of the tree to a
machine without git.  Without a card it stops there (exit code 2).  On
the card it builds both sources (one nvcc each, at once), prints the
ptxas lines of their K6 kernels and checks both against the plain version
(``ops.jpegenc.bitpack_fixed_plain``), words and total bits exactly, into
words first filled with 0x5A5A5A5A (a word left unstored shows), on the
K3 coefficients of the flagship tiles (``chip_smoke.flagship_packed``) at
B=8 and B=1, q 85 and 95, an overflow at 64 words, blocks of 63
category-10 coefficients (the exact path without a spill) and
``chip_smoke.bitpack_crafted``'s inputs (clamps in one chunk and at chunk
starts, streams ending on a word, B=3).  Then it times them in turns,
parent, change, change, parent, at q 85 on the flagship tiles at B=8 and
B=1 and on an all-zero B=1 tile: ``chip_smoke.time_ms``, the median of 25
calls, each after an L2 flush.  Beside them: the bound (coefficients, scan
map and spec read, used words written, over HBM), ``floor_ms``
(``time_ms`` of one trivial launch, a 4-byte ``zero_()``: the least any
one-launch kernel shows there), and each version's device time with the
L2 warm and its kernels and memsets a call (``chip_smoke.device_events``).

``--sweep`` also checks and times this tree's source built with chunks of
64 blocks (and threads) instead of 128 (``chunk64``, ``-DK6_BIT_THREADS=64``).
It prints one JSON line a case, the nvidia-smi line (the card's name and
power limit) and a JSON line of all.  A mismatch of the parent or the
change raises; the variant's is printed.
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

VARIANT_FLAGS = {"chunk64": ["-DK6_BIT_THREADS=64"]}


def configure_parent(lib: ctypes.CDLL) -> None:
    """The parent's interface: a memset of the words and status words,
    then one launch."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bitpack_fixed_launch.argtypes = [p, i, ll, p, p, ll, p, ll, p, p]
    lib.bitpack_fixed_launch.restype = ctypes.c_int
    lib.bitpack_fixed_status_words.argtypes = [i, ll]
    lib.bitpack_fixed_status_words.restype = ll


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the commit whose jpeg.cu is timed beside this "
                         "tree's")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    from omero_ms_image_region_tpu_torch.kernels import build
    parent = parent_source(build.BUILD_DIR, "k6", args.parent, "jpeg.cu")
    import torch
    if not torch.cuda.is_available():
        print(f"k6_redesign: the parent's source is in {parent}; timing "
              f"needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (bitpack_crafted, bytes_bound, device_events,
                            flagship_packed, smi_line, time_ms)
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.kernels import scratch
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J

    text = KJ.SOURCE.read_text()
    sources = {"parent": (parent.read_text(), [])}
    sources["change"] = (text, [])
    for tag, flags in (VARIANT_FLAGS.items() if args.sweep else ()):
        sources[tag] = (text, flags)
    paths = {}
    for name, (code, flags) in sources.items():
        digest = hashlib.sha256(code.encode()).hexdigest()[:10]
        path = build.BUILD_DIR / f"k6_{name}_{digest}_jpeg.cu"
        path.write_text(code)
        paths[name] = (path, [*KJ.NVCC_FLAGS, *flags])
    build.build_all(list(paths.values()))
    libs = {}
    for name, (path, flags) in paths.items():
        lib_path, _ = build.build(path, flags)
        lines = build.build_log(path.name).splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry" in line and "bitpack" in line:
                for follow in lines[k:k + 4]:
                    print(f"ptxas {name}: {follow.strip()}", flush=True)
        lib = ctypes.CDLL(str(lib_path))
        (configure_parent if name == "parent" else KJ._configure)(lib)
        libs[name] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    spec_arrays = J.huffman_spec_arrays()
    spec = J.spec_tensor(spec_arrays, dev)

    def launcher(name, blocks, scan, cw):
        lib = libs[name]
        B, nb = blocks.shape[:2]
        chunks = lib.bitpack_fixed_status_words(B, nb)
        bits = torch.empty(B, dtype=torch.int32, device=dev)
        if name == "parent":
            wbytes = (B * cw * 4 + 7) // 8 * 8
            buf = torch.empty(wbytes + 8 * chunks, dtype=torch.uint8,
                              device=dev)
            words = buf[:B * cw * 4].view(torch.int32).view(B, cw)
        else:
            words = torch.empty((B, cw), dtype=torch.int32, device=dev)

        def launch():
            if name == "parent":
                err = lib.bitpack_fixed_launch(
                    blocks.data_ptr(), B, nb, scan.data_ptr(),
                    spec.data_ptr(), cw, buf.data_ptr(), chunks,
                    bits.data_ptr(), stream)
            else:
                status, epoch = scratch.status_scratch(dev, stream, chunks)
                err = lib.bitpack_fixed_launch(
                    blocks.data_ptr(), B, nb, scan.data_ptr(),
                    spec.data_ptr(), cw, words.data_ptr(), bits.data_ptr(),
                    status.data_ptr(), status.numel(), epoch, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed: CUDA error {err}")
        return launch, words, bits

    packed8, _, _ = flagship_packed(torch, np, 8)
    _, H, W = packed8.shape
    scan = J.scan_index_tensor(H // 16, W // 16, dev)

    def join(c):
        B = c[0].shape[0]
        return torch.cat([t.reshape(B, -1, 64) for t in c], dim=1)

    cw85 = J.BitpackJpegEncoder(H, W, 85).cap_words
    cw95 = J.BitpackJpegEncoder(H, W, 95).cap_words
    b85 = join(J.packed_to_jpeg_coefficients(packed8, 85))
    b95 = join(J.packed_to_jpeg_coefficients(packed8, 95))
    cases = [("q85 B=8", b85, cw85), ("q85 B=1", b85[:1].contiguous(), cw85),
             ("q95 B=8", b95, cw95), ("q95 B=1", b95[:1].contiguous(), cw95),
             ("overflow 64 words", b95, 64)]
    dense = b85[:2].clone()
    dense[:, :, 1:] = 600
    cases.append(("maximal blocks", dense, 1 << 16))
    cases += [(label, blocks, cw85) for label, blocks in bitpack_crafted(
        torch, J, b85[:2].contiguous(), scan, cw85, KJ.BIT_CHUNK_BLOCKS)]
    checks = {}
    for label, blocks, cw in cases:
        want_w, want_b = J.bitpack_fixed_plain(blocks, scan, *spec_arrays,
                                               cw)
        row = {}
        for name in libs:
            launch, words, bits = launcher(name, blocks, scan, cw)
            words.fill_(0x5A5A5A5A)
            launch()
            torch.cuda.synchronize()
            diff = int((words != want_w).sum()) + int((bits != want_b).sum())
            row[name] = diff
            if diff and name in ("parent", "change"):
                raise RuntimeError(f"{name} differs from the plain version "
                                   f"on {label}: {diff} words and bits")
        checks[label] = row
        print(f"k6 check {label}: differing {json.dumps(row)}", flush=True)

    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = {"floor_ms": time_ms(torch, tiny.zero_, 25),
             "floor_warm_us": sum(device_events(torch, tiny.zero_)[0]
                                  .values())}
    print("k6 " + json.dumps(floor), flush=True)
    rows_out = []
    timed_cases = cases[:2] + [("all-zero B=1", torch.zeros_like(
        cases[1][1]), cw85)]
    for label, blocks, cw in timed_cases:
        launches = {name: launcher(name, blocks, scan, cw)[0]
                    for name in libs}
        row = {"case": label, "shape": [blocks.shape[0], H, W],
               "cap_words": cw}
        got = turns(lambda fn: time_ms(torch, fn, 25), launches)
        row.update(means(got))
        row["turns_ms"] = got
        for name in libs:
            if name not in ("parent", "change"):
                row[f"{name}_ms"] = time_ms(torch, launches[name], 25)
        bits = J.bitpack_fixed_plain(blocks, scan, *spec_arrays, cw)[1]
        used = int(((bits.to(torch.int64) + 31) // 32 * 4).sum())
        n_bytes = blocks.numel() * 2 + scan.numel() * 4 + 4096 + used
        row["bound_ms"] = bytes_bound(n_bytes)[0]
        row["used_bytes"] = used
        for name in libs:
            split, counts = device_events(torch, launches[name])
            row[f"{name}_warm_us"] = split
            row[f"{name}_launches_per_call"] = counts
        print("k6 " + json.dumps(row), flush=True)
        rows_out.append(row)
    smi = smi_line()
    print(smi, flush=True)
    print(json.dumps({"k6_redesign": rows_out, "checks": checks, **floor,
                      "card": smi, "parent": args.parent}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
