#!/usr/bin/env python3
"""Memory instructions of the JPEG kernels, read from their machine code.

    python3 scripts/jpeg_sass.py [path/to/jpeg.cu ...]   # needs nvcc

Builds each source (default: the port's ``kernels/csrc/jpeg.cu``) with the
port's flags, disassembles it with ``cuobjdump -sass`` and prints, per
kernel, the static count of each shared-memory (LDS, STS), constant (LDC)
and global (LDG, STG) instruction by its full opcode (``LDS.128`` is one
16-byte load a thread), the count of all its instructions and of each
opcode, and the ptxas register and shared-memory report.
Static counts are per thread over the kernel's code: a loop body that is
run once per MCU (or pair of MCUs) counts once.  Give the parent commit's
jpeg.cu as a second path to compare two versions.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OPS = re.compile(r"\b((?:LDS|STS|LDC|LDG|STG|LDSM)(?:\.[A-Z0-9_]+)*)\b")
OPCODE = re.compile(r"^\s*(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")


def sass_counts(out: str) -> dict:
    counts, kinds, name = {}, {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name], kinds[name] = Counter(), Counter()
            continue
        if name is None or not re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            continue
        ins = line.split("*/", 1)[1].split(";")[0]
        m = OPS.search(ins)
        if m:
            counts[name][m.group(1)] += 1
        m = OPCODE.match(ins)
        if m and m.group(1) != "NOP":
            kinds[name][m.group(1)] += 1
    return {k: {"memory": dict(sorted(v.items())),
                "instructions": sum(kinds[k].values()),
                "opcodes": dict(kinds[k].most_common())}
            for k, v in counts.items()}


def main(argv) -> int:
    from omero_ms_image_region_tpu_torch.kernels import build
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ

    sources = [Path(a).resolve() for a in argv] or [KJ.SOURCE]
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    result = {}
    for i, src in enumerate(sources):
        # A copy under its own name, so that the build is fresh and its
        # log printed.
        copy = build.BUILD_DIR / f"sass{i}_jpeg.cu"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        copy.write_text(src.read_text())
        for old in build.BUILD_DIR.glob(f"lib{copy.stem}_*.so"):
            old.unlink()
        lib, log = build.build(copy, KJ.NVCC_FLAGS)
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln
                 or "spill" in ln]
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        result[str(src.relative_to(ROOT) if src.is_relative_to(ROOT)
                   else src)] = {"ptxas": ptxas, "sass": sass_counts(sass)}
    for src, r in result.items():
        for line in r["ptxas"]:
            print(f"ptxas {src}: {line}", flush=True)
        for fn, c in r["sass"].items():
            print(f"sass {src} {fn}: {c['instructions']} instructions; "
                  f"memory {json.dumps(c['memory'])}; opcodes "
                  f"{json.dumps(c['opcodes'])}", flush=True)
    print(json.dumps({"jpeg_sass": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
