#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. probe   the card (nvidia-smi name and power limit), torch/CUDA versions,
           whether aiohttp and PIL import;
2. build   the render kernels from ``kernels/csrc/render.cu`` with nvcc;
3. kernels each kernel against its plain PyTorch version at the flagship
           shape B=8, C=4, 1024x1024 uint16 (and at the served shape B=1):
           K1 with linear settings (exact) and with all four families and a
           reversed channel (<= 1 per byte), K2 with a LUT table (<= 1);
           median time over 25 launches (CUDA events, L2 flushed between
           launches), the plain version's time, and the bound from the
           bytes moved and the operations done;
4. serve   an 8192^2 4-channel uint16 pyramid through the port's aiohttp app
           on 127.0.0.1: 8 GETs of 1024^2 tiles (resolution 0 and 1,
           greyscale, a reversed channel, a LUT channel, a flip, png and
           jpeg, one render_image region), each checked against the plain
           render of the same raw read (png pixels exactly; jpeg bytes
           against the same encoder over the plain pixels); both kernels'
           launch counters must rise.  Then end-to-end timing (sequential
           p50, tiles/s at 8 in flight) and one tile's layer breakdown.

It prints the kernel table as one JSON line, then the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
TILE = 1024
PLANE = 8 * TILE
DEVICE = "cuda"
L2_FLUSH_BYTES = 128 << 20   # > the 50 MB L2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def importable(name: str) -> bool:
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


# ------------------------------------------------------------------ timing

def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` single launches, each timed with CUDA events
    and preceded by an L2 flush outside the timed span."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(raw, table):
    """Least time for the render on this card: bytes (each input read
    once, each output written once) over HBM bandwidth, against f32
    operations (about 17 per pixel-channel for window, curve, quantize and
    accumulate, 12 per pixel to round, clip and pack) over the f32 rate."""
    B, C, H, W = raw.shape
    n_bytes = (raw.numel() * raw.element_size() + B * H * W * 4
               + B * C * 4 * 5 + table.numel() * 4)
    ops = B * H * W * (17 * C + 12)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def byte_diff(got, want):
    import numpy as np
    g = got.cpu().numpy().view(np.uint8).astype(np.int16)
    w = want.cpu().numpy().view(np.uint8).astype(np.int16)
    d = np.abs(g - w)
    return int(d.max()), int((d.reshape(-1, 4).max(axis=1) > 0).sum())


# ------------------------------------------------------------ kernel phase

def kernel_phase(torch, np):
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.models.rendering import Family
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.ops.lut import LutProvider

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    raw_np = synthetic_wsi_tiles(rng, 8, 4, TILE, TILE)
    raw8 = R.raw_to_tensor(raw_np, dev)

    linear = flagship_rdef(4)
    families = flagship_rdef(4)
    for cb, fam, k in zip(families.channel_bindings,
                          (Family.LINEAR, Family.POLYNOMIAL,
                           Family.LOGARITHMIC, Family.EXPONENTIAL),
                          (1.0, 0.7, 1.0, 0.35)):
        cb.family, cb.coefficient = fam, k
    families.channel_bindings[1].reverse_intensity = True
    luts = LutProvider()
    luts.add("smoke.lut", smoke_lut(np))
    lut = flagship_rdef(4)
    lut.channel_bindings[1].lut = "smoke.lut"

    def args_for(rdef, B, provider=None):
        s = R.settings_to_tensors(R.pack_settings(rdef, provider), dev)
        return R.batched_settings(s, B)

    # (kernel, check name, settings, tolerance)
    checks = [("render_ramp", "linear", linear, None, 0),
              ("render_ramp", "families_reversed", families, None, 1),
              ("render_lut", "lut", lut, luts, 1)]
    entries = {}
    for kernel, label, rdef, provider, tol in checks:
        for B in (8, 1):
            raw = raw8[:B].contiguous()
            args = args_for(rdef, B, provider)
            expect_lut = kernel == "render_lut"
            check((args[-1].dim() == 4) == expect_lut,
                  f"{label}: settings did not select {kernel}")
            got = R.render_tile_batch_packed(raw, *args)
            want = R.render_tile_batch_packed_plain(raw, *args)
            torch.cuda.synchronize()
            err, mism = byte_diff(got, want)
            print(f"check {kernel} {label} B={B}: max_abs_diff {err} "
                  f"mismatched_px {mism} (tolerance {tol})", flush=True)
            check(err <= tol, f"{kernel} {label} B={B} disagrees with "
                              f"its plain version: max |diff| {err}")
            e = entries.setdefault(kernel, {
                "name": kernel, "route": "cuda",
                "source": "omero_ms_image_region_tpu_torch/kernels/csrc/"
                          "render.cu",
                "replaces": ("omero_ms_image_region_tpu/experimental/"
                             "pallas_render.py:"
                             + ("256" if expect_lut else "226")),
                "max_abs_err": 0, "max_abs_diff": 0, "mismatched_px": 0,
                "tolerance": tol,
            })
            e["max_abs_err"] = e["max_abs_diff"] = max(e["max_abs_err"],
                                                       err)
            e["mismatched_px"] += mism
            e["tolerance"] = max(e["tolerance"], tol)
            if label in ("linear", "lut"):    # the served settings: timed
                key = "" if B == 8 else "b1_"
                e[key + "ms"] = time_ms(
                    torch, lambda: R.render_tile_batch_packed(raw, *args),
                    25)
                e[key + "plain_ms"] = time_ms(
                    torch,
                    lambda: R.render_tile_batch_packed_plain(raw, *args), 5)
                e[key + "bound_ms"], e[key + "bound_by"] = bound(
                    raw, args[-1])
                e[key + "bound_us"] = e[key + "bound_ms"] * 1e3
                e[key + "shape"] = list(raw.shape)
    for e in entries.values():
        e["library_ms"] = None    # no single PyTorch call computes this
        print(f"kernel {e['name']}: {e['ms']:.4f} ms at B=8 (bound "
              f"{e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms); "
              f"{e['b1_ms']:.4f} ms at B=1 (bound {e['b1_bound_ms']:.4f})",
              flush=True)
    return entries


def smoke_lut(np):
    """A fixed 256x3 LUT (a fire-like ramp), as uint8."""
    ramp = np.arange(256)
    return np.stack([np.minimum(255, ramp * 3),
                     np.clip(ramp * 3 - 255, 0, 255),
                     np.clip(ramp * 3 - 510, 0, 255)], axis=-1).astype(
        np.uint8)


# ------------------------------------------------------------- serve phase

def build_data(np, data_dir: str, lut_root: str) -> float:
    from omero_ms_image_region_tpu_torch.flagship import synthetic_wsi_tiles
    from omero_ms_image_region_tpu_torch.io.store import build_pyramid

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    n = PLANE // TILE
    planes = np.empty((4, 1, PLANE, PLANE), np.uint16)
    for ty in range(n):
        row = synthetic_wsi_tiles(rng, n, 4, TILE, TILE)   # [n, C, T, T]
        for tx in range(n):
            planes[:, 0, ty * TILE:(ty + 1) * TILE,
                   tx * TILE:(tx + 1) * TILE] = row[tx]
    build_pyramid(planes, os.path.join(data_dir, "1"), chunk=(256, 256))
    with open(os.path.join(lut_root, "smoke.lut"), "wb") as f:
        f.write(smoke_lut(np).T.tobytes())     # 768-byte planar R, G, B
    return time.perf_counter() - t0


CH = "1|100:40000$FF0000,2|100:40000$00FF00,3|100:40000$0000FF," \
     "4|100:40000$FFFF00"


def requests_for(tile: int):
    """The 8 checked requests: tiles of ``tile`` pixels on a plane of
    8 tiles a side."""
    def t(res, x, y):
        return f"{res},{x},{y},{tile},{tile}"
    return [
        ("render_image_region", {"tile": t(0, 2, 3), "c": CH, "m": "c",
                                 "format": "png"}),
        ("render_image_region", {"tile": t(1, 1, 1), "c": CH, "m": "c",
                                 "format": "png"}),
        ("render_image_region", {"tile": t(0, 4, 4), "c": CH, "m": "g",
                                 "format": "png"}),
        ("render_image_region", {
            "tile": t(0, 5, 1), "c": CH, "m": "c", "format": "png",
            "maps": '[{"reverse":{"enabled":true}},{},{},{}]'}),
        ("render_image_region", {
            "tile": t(0, 3, 6), "m": "c", "format": "png",
            "c": CH.replace("$00FF00", "$smoke.lut")}),
        ("render_image_region", {"tile": t(0, 6, 2), "c": CH, "m": "c",
                                 "flip": "hv", "format": "png"}),
        ("render_image_region", {"tile": t(0, 1, 7), "c": CH, "m": "c",
                                 "format": "jpeg", "q": "0.9"}),
        ("render_image", {
            "region": f"{3 * tile - tile // 14},{2 * tile + tile // 2},"
                      f"{tile},{tile}",
            "c": CH, "m": "c", "format": "png"}),
    ]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def serve_phase(torch, np, data_dir, lut_root, have_aiohttp,
                      have_pil):
    from omero_ms_image_region_tpu_torch import codecs
    from omero_ms_image_region_tpu_torch.kernels import render as K
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.ops.flip import flip_image
    from omero_ms_image_region_tpu_torch.server.app import (build_handler,
                                                            create_app)
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx

    handler = build_handler(data_dir, lut_root, device=DEVICE)
    requests = requests_for(TILE)

    def params_of(route, query):
        return dict(query, imageId="1", theZ="0", theT="0")

    runner = session = None
    if have_aiohttp:
        import aiohttp
        from aiohttp import web
        port = free_port()
        runner = web.AppRunner(create_app(data_dir, handler=handler))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=120))
    else:
        print("serve: aiohttp is not installed; calling "
              "ImageRegionHandler.render_image_region directly", flush=True)

    async def get(route, query):
        t0 = time.perf_counter()
        if session is not None:
            url = f"http://127.0.0.1:{port}/webgateway/{route}/1/0/0"
            async with session.get(url, params=query) as r:
                body = await r.read()
                status = r.status
        else:
            body = await handler.render_image_region(
                ImageRegionCtx.from_params(params_of(route, query)))
            status = 200
        return status, body, (time.perf_counter() - t0) * 1e3

    try:
        # Warm-up (first CUDA context use, kernel load), outside the
        # counted run.
        await get(*requests[0])
        K.reset_launches()
        results = [await get(route, q) for route, q in requests]
        launches = dict(K.LAUNCHES)
        print(f"serve: launches in the 8-request run: {launches}",
              flush=True)

        for (route, query), (status, body, ms) in zip(requests, results):
            ctx = ImageRegionCtx.from_params(params_of(route, query))
            raw, settings = await handler.read(ctx)
            t = R.settings_to_tensors(settings, DEVICE)
            plain = R.render_tile_batch_packed_plain(
                R.raw_to_tensor(raw, DEVICE)[None], *R.batched_settings(t))
            plain = flip_image(plain[0], ctx.flip_horizontal,
                               ctx.flip_vertical)
            want_rgba = R.unpack_rgba(plain.cpu().numpy())
            check(status == 200, f"{route} {query}: HTTP {status}")
            if ctx.format == "png" and have_pil:
                got_rgba = codecs.decode_to_rgba(body)
                same = np.array_equal(got_rgba[..., :3], want_rgba[..., :3])
            else:
                same = body == codecs.encode_rgba(
                    want_rgba, ctx.format, ctx.compression_quality)
            kernel = ("render_lut" if settings["tables"].ndim == 3
                      else "render_ramp")
            print(f"serve {route} {json.dumps(query)}: status {status} "
                  f"bytes {len(body)} wall_ms {ms:.2f} shape "
                  f"{list(raw.shape)} kernel {kernel} "
                  f"matches_plain {same}", flush=True)
            check(same, f"{route} {query}: served pixels differ from the "
                        f"plain render")
        check(launches["render_ramp"] >= 1,
              "render_ramp was not launched by the served requests")
        check(launches["render_lut"] >= 1,
              "render_lut was not launched by the served requests")

        # End to end: 4-channel jpeg tiles at resolution 0.
        tiles = [("render_image_region",
                  {"tile": f"0,{i % 8},{i // 8},{TILE},{TILE}", "c": CH,
                   "m": "c", "format": "jpeg"}) for i in range(64)]
        seq = [(await get(*r))[2] for r in tiles[:16]]
        sem = asyncio.Semaphore(8)

        async def limited(r):
            async with sem:
                return await get(*r)
        t0 = time.perf_counter()
        conc = await asyncio.gather(*(limited(r) for r in tiles[16:64]))
        wall = time.perf_counter() - t0
        check(all(s == 200 for s, _, _ in conc), "timed run: non-200")
        e2e = {"tile": f"{TILE}x{TILE}x4 uint16 -> jpeg",
               "sequential_n": len(seq),
               "sequential_p50_ms": statistics.median(seq),
               "concurrent_n": len(conc), "in_flight": 8,
               "concurrent_tiles_per_s": len(conc) / wall,
               "concurrent_p50_ms": statistics.median(
                   ms for _, _, ms in conc),
               "via": "http" if session is not None else "handler"}
        print("e2e: " + json.dumps(e2e), flush=True)

        # One tile's layers, medians of 5.
        ctx = ImageRegionCtx.from_params(params_of(*tiles[9]))
        layers = {k: [] for k in ("read_ms", "h2d_ms", "render_kernel_ms",
                                  "d2h_ms", "encode_jpeg_ms")}
        for _ in range(5):
            t0 = time.perf_counter()
            raw, settings = await handler.read(ctx)
            t1 = time.perf_counter()
            raw_t = R.raw_to_tensor(raw, DEVICE)[None]
            st = R.batched_settings(R.settings_to_tensors(settings, DEVICE))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = R.render_tile_batch_packed(raw_t, *st)
            ev[1].record()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            packed = out[0].cpu().numpy()
            t4 = time.perf_counter()
            codecs.encode_rgba(R.unpack_rgba(packed), "jpeg", None)
            t5 = time.perf_counter()
            for k, v in zip(layers, ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                     ev[0].elapsed_time(ev[1]),
                                     (t4 - t3) * 1e3, (t5 - t4) * 1e3)):
                layers[k].append(v)
        print("breakdown: " + json.dumps(
            {k: statistics.median(v) for k, v in layers.items()}),
            flush=True)
        return launches
    finally:
        if session is not None:
            await session.close()
        if runner is not None:
            await runner.cleanup()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from omero_ms_image_region_tpu_torch.kernels import render as K

    # 1. probe
    smi = smi_line()
    have_aiohttp, have_pil = importable("aiohttp"), importable("PIL")
    print("probe: " + json.dumps({
        "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0),
        "aiohttp": have_aiohttp, "PIL": have_pil}), flush=True)

    # 2. build
    t0 = time.perf_counter()
    K.library()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in K.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("build: " + line.strip(), flush=True)

    # 3. kernels against their plain versions
    entries = kernel_phase(torch, np)

    # 4. serve
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        lut_root = os.path.join(tmp, "luts")
        os.makedirs(data_dir)
        os.makedirs(lut_root)
        secs = build_data(np, data_dir, lut_root)
        print(f"serve: built a {PLANE}x{PLANE} 4-channel uint16 pyramid in "
              f"{secs:.1f} s", flush=True)
        launches = asyncio.run(serve_phase(torch, np, data_dir, lut_root,
                                           have_aiohttp, have_pil))

    for name, e in entries.items():
        e["launches"] = launches[name]
        e["card"], e["power_limit"] = [s.strip() for s in smi.split(",")]
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
