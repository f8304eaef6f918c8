#!/usr/bin/env python3
"""K12a (``composite_partial``) and K12b (``composite_pack``) of a parent
commit beside this tree's, checked and timed in one process on the card,
with the chan-1 mesh group: the parent's K12a + K12b against K1 and K2.

    python3 scripts/k12_redesign.py --parent REV

Where git is (any machine): the parent's ``kernels/csrc/mesh.cu`` and
``quantize.cuh`` at ``REV`` (``HEAD`` while the change is uncommitted,
``HEAD~1`` once it is) are written into ``kernels/_build/k12_parent_REV/``,
git-ignored, which travels with a copy of the tree to a machine without
git.  Without a card it stops there (exit code 2).  On the card it builds
the parent's ``mesh.cu``, this tree's and this tree's ``render.cu`` (one
nvcc each, at once), prints their ptxas lines, and checks both K12
versions against the plain versions (``ops.render.composite_partial_plain``
and ``composite_pack_plain``), exactly: the flagship tiles (C=4, 1024^2
uint16) at B=8 and B=1 split as chan 1, 2 and 4, with ramp weights and
with a LUT channel, a reversed channel, raw in uint8 and float32, a ragged
1000x1020 tile, 64 LUT channels (the tables staged in chunks), and K12b
over S = 1, 2, 3, 4 and 8 random partials (also a ragged 37x45 tile); the
curved families through the chain (K12a, K12b) within one step of the
plain chain's bytes.  Then it times them in turns, parent, change, change,
parent (``chip_smoke.time_ms``: the median of 25 launches, each after an
L2 flush), at B=8 and B=1: K12a on a chan-2 and a chan-4 shard (ramp) and
on a chan-2 shard (LUT), K12b over 2 and 4 shards, and the chan-1 group
(the parent's K12a over all channels then K12b over its one partial,
against K1 for the ramp and K2 for the LUT on the same tiles).  Beside
each time: the bound (``chip_smoke.mesh_bound`` / ``bound``), ``copy_ms``
(``time_ms`` of a ``Tensor.copy_`` moving the bound's bytes: half read,
half written) and ``floor_ms`` (``time_ms`` of one trivial launch, a
4-byte ``zero_()``), both from ``scripts/redesign.py``.  It prints one
JSON line a timed case, the nvidia-smi line (the card's name and power
limit) and a JSON line of all.  A mismatch of either version raises.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from redesign import (CopyTimer, floor_ms, means, parent_source,  # noqa: E402
                      ptxas_lines, turns)


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the commit whose mesh.cu is timed beside this "
                         "tree's")
    args = ap.parse_args(argv)

    from omero_ms_image_region_tpu_torch.kernels import build
    parent = parent_source(build.BUILD_DIR, "k12", args.parent, "mesh.cu",
                           ("quantize.cuh",))
    import torch
    if not torch.cuda.is_available():
        print(f"k12_redesign: the parent's source is in {parent}; timing "
              f"needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (HBM_BYTES_PER_S, bound, byte_diff, mesh_bound,
                            smi_line, smoke_lut, time_ms)
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.kernels import mesh as KM
    from omero_ms_image_region_tpu_torch.kernels import render as K
    from omero_ms_image_region_tpu_torch.models.rendering import Family
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.ops.lut import LutProvider

    sources = {"parent": (parent, KM.NVCC_FLAGS),
               "change": (KM.SOURCE, KM.NVCC_FLAGS),
               "render": (K.SOURCE, K.NVCC_FLAGS)}
    build.build_all(list(sources.values()))
    for tag, (source, _) in sources.items():
        ptxas_lines(tag, build.build_log(source.name))
    # The parent's launches have this tree's prototypes.
    libs = {"parent": ctypes.CDLL(str(build.build(*sources["parent"])[0])),
            "change": KM.library()}
    KM._configure(libs["parent"])
    K.library()

    dev = torch.device("cuda")

    def partial(name, raw, a, c0=0, c1=None):
        """K12a of ``name`` over the channels [c0, c1) of raw."""
        B, C, H, W = raw.shape
        c1 = C if c1 is None else c1
        ws, we, fam, coef, rev, cd_start, cd_end, tables = a
        out = torch.empty((3, B, H, W), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = libs[name].composite_partial_launch(
            raw.data_ptr(), K._DTYPE_CODES[raw.dtype],
            ws.data_ptr(), we.data_ptr(), coef.data_ptr(), fam.data_ptr(),
            rev.data_ptr(), tables.data_ptr(), int(tables.dim() == 4),
            out.data_ptr(), B, C, c0, c1, H * W, int(cd_start), int(cd_end),
            stream)
        if err:
            raise RuntimeError(f"{name}: composite_partial launch failed: "
                               f"CUDA error {err}")
        return out

    def pack(name, partials):
        S, _, B, H, W = partials.shape
        out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = libs[name].composite_pack_launch(
            partials.data_ptr(), out.data_ptr(), S, B * H * W, stream)
        if err:
            raise RuntimeError(f"{name}: composite_pack launch failed: "
                               f"CUDA error {err}")
        return out

    rng = np.random.default_rng(12)
    raw8 = R.raw_to_tensor(synthetic_wsi_tiles(rng, 8, 4, 1024, 1024), dev)
    luts = LutProvider()
    luts.add("smoke.lut", smoke_lut(np))
    lut = flagship_rdef(4)
    lut.channel_bindings[1].lut = "smoke.lut"
    families = flagship_rdef(4)
    for cb, fam, k in zip(families.channel_bindings,
                          (Family.LINEAR, Family.POLYNOMIAL,
                           Family.LOGARITHMIC, Family.EXPONENTIAL),
                          (1.0, 0.7, 1.0, 0.35)):
        cb.family, cb.coefficient = fam, k
    families.channel_bindings[1].reverse_intensity = True
    reverse = flagship_rdef(4)
    reverse.channel_bindings[2].reverse_intensity = True
    wide = flagship_rdef(64)
    for cb in wide.channel_bindings[1::2]:
        cb.lut = "smoke.lut"

    def args_for(rdef, B, provider=None):
        s = R.settings_to_tensors(R.pack_settings(rdef, provider), dev)
        return R.batched_settings(s, B)

    checks = {}

    def compare(label, raw, a, chan, tol=0):
        """Each version's K12a on the ``chan`` shards and K12b over them,
        against the plain versions: partials exact (unless ``tol``), the
        pack exact on the same partials, the bytes within ``tol`` of the
        plain chain's."""
        C = raw.shape[1]
        per = C // chan
        plain = torch.stack([R.composite_partial_plain(
            raw, *a, c0=s * per, c1=(s + 1) * per) for s in range(chan)])
        chain = R.composite_pack_plain(plain)
        row = {}
        for name in libs:
            parts = torch.stack([partial(name, raw, a, s * per,
                                         (s + 1) * per)
                                 for s in range(chan)])
            packed = pack(name, parts)
            want = R.composite_pack_plain(parts)
            torch.cuda.synchronize()
            part_err = float((parts - plain).abs().max())
            pack_err = byte_diff(packed, want)[0]
            chain_err = byte_diff(packed, chain)[0]
            row[name] = [part_err, pack_err, chain_err]
            if not (
                    (part_err == 0 or tol > 0) and pack_err == 0
                    and chain_err <= tol):
                raise RuntimeError(f"{name} differs from the plain versions "
                                   f"on {label} chan={chan}: partial "
                                   f"{part_err}, pack {pack_err}, chain "
                                   f"{chain_err}")
        key = f"{label} chan={chan} {list(raw.shape)}"
        checks[key] = row
        print(f"k12 check {key}: [partial, pack, chain] max_abs_diff "
              f"{json.dumps(row)} (tolerance {tol})", flush=True)

    for B in (8, 1):
        raw = raw8[:B].contiguous()
        for label, rdef, provider, tol in (
                ("ramp", flagship_rdef(4), None, 0),
                ("lut", lut, luts, 0), ("reverse", reverse, None, 0),
                ("families_reversed", families, None, 1)):
            for chan in (1, 2, 4):
                compare(f"{label} B={B}", raw, args_for(rdef, B, provider),
                        chan, tol)
    a2 = args_for(flagship_rdef(4), 2)
    a2_lut = args_for(lut, 2, luts)
    for label, raw in (
            ("raw f32", (raw8[:2].view(torch.int16).to(torch.int32)
                         & 0xFFFF).to(torch.float32)),
            ("raw u8", (raw8[:2].view(torch.int16).to(torch.int32)
                        & 0xFF).to(torch.uint8).contiguous()),
            ("ragged", R.raw_to_tensor(synthetic_wsi_tiles(
                rng, 2, 4, 1000, 1020), dev))):
        for chan in (2, 4):
            compare(label, raw, a2, chan)
            compare(label + " lut", raw, a2_lut, chan)
    raw64 = R.raw_to_tensor(synthetic_wsi_tiles(rng, 2, 64, 256, 256), dev)
    for chan in (1, 2):
        compare("64 channels lut", raw64, args_for(wide, 2, luts), chan)
    for S, shape in ((1, (2, 64, 96)), (2, (8, 1024, 1024)),
                     (3, (2, 64, 96)), (4, (8, 1024, 1024)),
                     (8, (2, 256, 256)), (2, (1, 37, 45)), (8, (1, 37, 45))):
        parts = torch.from_numpy(np.random.default_rng(S).uniform(
            -20, 280, (S, 3) + shape).astype(np.float32)).to(dev)
        want = R.composite_pack_plain(parts)
        row = {name: byte_diff(pack(name, parts), want)[0] for name in libs}
        if any(row.values()):
            raise RuntimeError(f"K12b differs from its plain version at "
                               f"S={S} {shape}: {row}")
        checks[f"pack S={S} {list(shape)}"] = row
        print(f"k12 check pack S={S} {list(shape)}: max_abs_diff "
              f"{json.dumps(row)}", flush=True)

    def tm(fn):
        return time_ms(torch, fn, 25)

    floor = floor_ms(torch, tm)
    copy_ms = CopyTimer(torch, tm)

    rows = []

    def report(row):
        row["copy_ms"] = copy_ms(row["bound_ms"] * 1e-3 * HBM_BYTES_PER_S)
        row["floor_ms"] = floor
        print("k12 " + json.dumps(row), flush=True)
        rows.append(row)

    for B in (8, 1):
        raw = raw8[:B].contiguous()
        ramp = args_for(flagship_rdef(4), B)
        luta = args_for(lut, B, luts)
        for kind, a, chans in (("ramp", ramp, (2, 4)), ("lut", luta, (2,))):
            for chan in chans:
                per = 4 // chan
                (pb, pby), (kb, kby) = mesh_bound(raw, chan, a[-1])
                t = turns(tm, {name: (lambda name=name: partial(
                    name, raw, a, 0, per)) for name in libs})
                report({"kernel": "composite_partial", "case":
                        f"{kind} chan-{chan} shard B={B}", **means(t),
                        "turns_ms": t, "bound_ms": pb, "bound_by": pby})
                if kind == "ramp":
                    parts = torch.stack([partial("change", raw, a, s * per,
                                                 (s + 1) * per)
                                         for s in range(chan)])
                    t = turns(tm, {name: (lambda name=name: pack(
                        name, parts)) for name in libs})
                    report({"kernel": "composite_pack",
                            "case": f"S={chan} B={B}", **means(t),
                            "turns_ms": t, "bound_ms": kb,
                            "bound_by": kby})
        # The chan-1 group: the parent's K12a + K12b against K1 / K2 on the
        # same tiles (and this tree's K12a + K12b, which no step runs at
        # chan 1 any more).
        for kind, a in (("ramp", ramp), ("lut", luta)):
            fns = {
                "parent": lambda a=a: pack("parent", partial(
                    "parent", raw, a)[None]),
                "k12_change": lambda a=a: pack("change", partial(
                    "change", raw, a)[None]),
                "k1_k2": lambda a=a: R.render_tile_batch_packed(raw, *a)}
            want = R.render_tile_batch_packed_plain(raw, *a)
            for name, fn in fns.items():
                got = fn()
                if byte_diff(got, want)[0]:
                    raise RuntimeError(f"chan-1 group {name} {kind} B={B} "
                                       f"differs from K1's plain render")
            got = turns(tm, fns, ("parent", "k1_k2", "k12_change", "k1_k2",
                                  "k12_change", "parent"))
            bnd, by = bound(raw, a[-1])
            report({"kernel": "chan-1 group", "case": f"{kind} B={B}",
                    **means(got), "turns_ms": got, "bound_ms": bnd, "bound_by": by,
                    "parent_bound_ms": sum(
                        t for t, _ in mesh_bound(raw, 1, a[-1]))})
    smi = smi_line()
    print(smi, flush=True)
    print(json.dumps({"k12_redesign": rows, "checks": checks,
                      "floor_ms": floor, "card": smi,
                      "parent": args.parent}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
