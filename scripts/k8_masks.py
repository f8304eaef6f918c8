#!/usr/bin/env python3
"""K8a (``mask_rasterize``) and K8b (``mask_overlay``) of one or more
``workloads.cu`` sources, checked and timed in one run on the card.

    python3 scripts/k8_masks.py [--sweep] [path/to/workloads.cu ...]  # card

For each source (default: the port's ``kernels/csrc/workloads.cu``; a
source may be named more than once, e.g. parent, change, change, parent)
it builds a copy with the port's flags (once per distinct content), prints
the ptxas lines of the mask kernels and, from ``cuobjdump -sass``, their
global loads and stores by full opcode (``LDG.E.128`` is one 16-byte load
a thread), their integer multiplies (``IMAD.HI`` a multiply-high), calls
and special-function ops, and their instruction count.  Then, at each shape below, it checks the kernel against its plain
version byte for byte and times it three ways:

* ``ms``: ``chip_smoke.time_ms``, median of 25 launches, each after an L2
  flush and behind a GPU sleep (the kernel line's ``ms``);
* ``warm_us``: ``chip_smoke.device_split``, the kernel's device time with
  the L2 warm (torch.profiler), without the launch and the flush's dirty
  lines;
* ``copy_ms``: ``dst.copy_(src)`` between two device buffers of half the
  kernel's counted bytes, timed by the same ``time_ms``: it moves the same
  bytes, as a yardstick of what that harness gives a byte pass
  (``copy_warm_us``: the copy's device time with the L2 warm).

K8a: B=8 1024^2; B=1 1023^2 with flip_h.  K8b: B=1 1024^2 (fill alpha
128); B=1 1023x1021; B=1 1024^2 on a base 4 bytes past a 16-byte
boundary.  ``--sweep`` also runs each one-line variant of each source in
``VARIANTS`` whose lines the source has (K8b at 16 or 4 pixels a
thread, in CTAs of 256 threads, with evict-first or plain loads; plain
stores for both; K8a at 16 output bytes a thread); a variant's mismatches
are printed, a source's raise.  It prints one JSON line per source and variant, the nvidia-smi
line, and a JSON line of all.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# --sweep: one-line variants of a source, each built and run beside it
# where the source has the line.
VARIANTS = {
    "px16": [("constexpr int kOverlayPx = 8;",
              "constexpr int kOverlayPx = 16;")],
    "px4": [("constexpr int kOverlayPx = 8;",
             "constexpr int kOverlayPx = 4;")],
    "t256": [("  const int threads = 128;", "  const int threads = 256;")],
    "ld_cs": [("{ return __ldg(p); }", "{ return __ldcs(p); }")],
    "ld_plain": [("{ return __ldg(p); }", "{ return *p; }")],
    "st_plain": [("{ __stcs(p, v); }", "{ *p = v; }")],
    "g16": [("constexpr int kMaskGroup = 32;",
             "constexpr int kMaskGroup = 16;")],
}
FULL_OPCODE = re.compile(
    r"^\s*(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)")


def sass_of(cuobjdump: str, lib: Path) -> dict:
    """Per mask kernel: the counts of its global loads and stores, integer
    multiplies (``IMAD.HI`` is a multiply-high), calls and special-function
    ops (a divide subroutine would show as CALL or MUFU.RCP) by full
    opcode, and of all its instructions (static, over its code)."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "mask_" in m.group(1) else None
            if name:
                counts[name] = Counter()
            continue
        if name is None or not re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            continue
        m = FULL_OPCODE.match(line.split("*/", 1)[1])
        if not m or m.group(1) == "NOP":
            continue
        op = m.group(1)
        counts[name]["instructions"] += 1
        if op.startswith(("LDG", "STG", "IMAD", "CALL", "MUFU")):
            counts[name][op] += 1
    return {k: dict(v) for k, v in counts.items()}


def main(argv) -> int:
    import torch

    sweep = "--sweep" in argv
    argv = [a for a in argv if a != "--sweep"]
    if not torch.cuda.is_available():
        print("k8_masks: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import bytes_bound, device_split, smi_line, time_ms
    from omero_ms_image_region_tpu_torch.kernels import build
    from omero_ms_image_region_tpu_torch.kernels import workloads as KW
    from omero_ms_image_region_tpu_torch.ops import maskops as M

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stream = torch.cuda.current_stream().cuda_stream

    def upload(a):
        return torch.from_numpy(a).to(dev)

    # K8a cases: (label, B, w, h, flip_h)
    rast = []
    for label, B, w, h, fh in (("B=8 1024^2", 8, 1024, 1024, 0),
                               ("B=1 1023^2 flip_h", 1, 1023, 1023, 1)):
        packed = upload(rng.integers(0, 256, size=(B, M.packed_nbytes(w, h)),
                                     dtype=np.uint8))
        out = torch.empty((B, h, w), dtype=torch.uint8, device=dev)
        rast.append((label, packed, w, h, fh, out,
                     M.mask_rasterize_plain(packed, w, h, bool(fh), False),
                     packed.numel() + out.numel()))
    # K8b cases: (label, base, grids, fills)
    over = []
    for label, w, h, off in (("B=1 1024^2", 1024, 1024, 0),
                             ("B=1 1023x1021", 1023, 1021, 0),
                             ("B=1 1024^2 base +4 bytes", 1024, 1024, 4)):
        n = h * w * 4
        flat = upload(rng.integers(0, 256, size=n + 16, dtype=np.uint8))
        base = flat[off:off + n].view(1, h, w, 4)
        grids = upload(rng.integers(0, 4, size=(1, h, w), dtype=np.uint8))
        fills = torch.tensor([[255, 40, 7, 128]], dtype=torch.uint8,
                             device=dev)
        out = torch.empty((1, h, w, 4), dtype=torch.uint8, device=dev)
        over.append((label, base, grids, fills, out,
                     M.mask_overlay_plain(base, grids, fills),
                     2 * n + grids.numel() + fills.numel()))

    def copy_times(n_bytes):
        # Half the bytes, rounded down to 16: PyTorch's copy of a size that
        # is no multiple of 4 takes a slower, unvectorized kernel.
        src = torch.empty(n_bytes // 32 * 16, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        return {"copy_ms": time_ms(torch, lambda: dst.copy_(src), 25),
                "copy_warm_us": sum(device_split(
                    torch, lambda: dst.copy_(src)).values())}

    copies = {label: copy_times(nb) for label, *_, nb in rast + over}
    # Every (source, variant), and its copy to build: one nvcc per distinct
    # content, all at once.
    todo, paths = [], {}
    for src in [Path(a).resolve() for a in argv] or [KW.SOURCE]:
        text = src.read_text()
        variants = {"": text}
        for tag, subs in (VARIANTS.items() if sweep else ()):
            if all(old in text for old, _ in subs):
                code = text
                for old, new in subs:
                    code = code.replace(old, new)
                variants[tag] = code
        for tag, code in variants.items():
            digest = hashlib.sha256(code.encode()).hexdigest()[:10]
            todo.append(((str(src.relative_to(ROOT))
                          if src.is_relative_to(ROOT) else str(src))
                         + (f" ({tag})" if tag else ""), digest, tag))
            if digest not in paths:
                paths[digest] = build.BUILD_DIR / f"k8_{digest}_workloads.cu"
                paths[digest].write_text(code)
    build.build_all([(path, KW.NVCC_FLAGS) for path in paths.values()])
    runs, libs = [], {}
    for name, digest, tag in todo:
        if digest not in libs:
            lib_path, _ = build.build(paths[digest], KW.NVCC_FLAGS)
            lines = build.build_log(paths[digest].name).splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry" in line and "mask_" in line:
                    print(f"ptxas {name}: " + " | ".join(
                        ln.strip() for ln in lines[i:i + 5]
                        if "Compiling" in ln or "registers" in ln
                        or "spill" in ln), flush=True)
            for fn, c in sass_of(cuobjdump, lib_path).items():
                print(f"sass {name} {fn}: {json.dumps(c)}", flush=True)
            lib = ctypes.CDLL(str(lib_path))
            KW._configure(lib)
            libs[digest] = lib
        lib = libs[digest]
        row = {"source": name}
        for label, packed, w, h, fh, out, want, nb in rast:
            def launch(packed=packed, w=w, h=h, fh=fh, out=out, lib=lib):
                err = lib.mask_rasterize_launch(
                    packed.data_ptr(), packed.shape[0], packed.shape[1],
                    w, h, fh, 0, out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            diff = int((out != want).sum())
            warm = device_split(torch, launch)
            row["mask_rasterize " + label] = {
                "differing": diff, "ms": time_ms(torch, launch, 25),
                "warm_us": sum(v for k, v in warm.items()
                               if "mask_rasterize" in k),
                **copies[label], "bound_ms": bytes_bound(nb)[0]}
        for label, base, grids, fills, out, want, nb in over:
            def launch(base=base, grids=grids, fills=fills, out=out,
                       lib=lib):
                err = lib.mask_overlay_launch(
                    base.data_ptr(), grids.data_ptr(), fills.data_ptr(),
                    1, grids.numel(), out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            diff = int((out != want).sum())
            warm = device_split(torch, launch)
            row["mask_overlay " + label] = {
                "differing": diff, "ms": time_ms(torch, launch, 25),
                "warm_us": sum(v for k, v in warm.items()
                               if "mask_overlay" in k),
                **copies[label], "bound_ms": bytes_bound(nb)[0]}
        print("k8 " + json.dumps(row), flush=True)
        runs.append(row)
        bad = [k for k, v in row.items()
               if isinstance(v, dict) and v["differing"]]
        if bad and not tag:
            raise RuntimeError(f"{name}: {bad} differ from the plain "
                               f"version")
    smi = smi_line()
    print(smi, flush=True)
    print(json.dumps({"k8_masks": runs, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
