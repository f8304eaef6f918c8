"""Shared fixtures of the port's workload tests: a data tree both packages
read, and one exchange of requests through the JAX default app and the
port's, each built once from one config dict.

The tree holds image 7, a 2-channel uint16 256x256 stack of 4 planes, and
masks written by the JAX package's ``write_mask``: 1 and 2 (256x256, 2 with
its own fill), 3 (37x45), 4 (13x7, a payload that is not a multiple of 8
bits, with trailing bytes), 5 (256x256, readable only by the session
``someone``).
"""

import asyncio
import json
import os

import numpy as np

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.models.mask import Mask as JaxMask
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.services.metadata import (
    write_mask as jax_write_mask)
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.server.app import (
    build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.utils import telemetry

IMG = 7
SIZE = 256
Z = 4
CH = "c=1|0:60000$FF0000,2|0:60000$00FF00&m=c"
MASKS = {1: (SIZE, SIZE, None), 2: (SIZE, SIZE, (10, 20, 30, 200)),
         3: (37, 45, None), 4: (13, 7, (0, 0, 255, 128)),
         5: (SIZE, SIZE, None)}
CACHE_HEADERS = ("ETag", "Cache-Control", "Vary", "Last-Modified",
                 "Content-Type")


def write_tree(root: str) -> str:
    """Image 7 and masks 1-5 under ``root`` (seeded)."""
    rng = np.random.default_rng(11)
    planes = rng.integers(0, 60000, size=(2, Z, SIZE, SIZE)).astype(
        np.uint16)
    build_pyramid(planes, os.path.join(root, str(IMG)), chunk=(128, 128),
                  n_levels=1)
    for sid, (w, h, fill) in MASKS.items():
        nbytes = (w * h + 7) // 8 + (3 if sid == 4 else 0)
        jax_write_mask(root, JaxMask(
            sid, w, h, rng.integers(0, 256, nbytes, dtype=np.uint8)
            .tobytes(), fill))
    with open(os.path.join(root, "masks", "5.acl.json"), "w") as f:
        json.dump({"sessions": ["someone"]}, f)
    return root


def exchange(raw: dict, requests, port_handler=None):
    """Each ``(method, url, headers)`` through the JAX default app and the
    port's (on the CPU), both built from ``raw``.  Returns both lists of
    ``(status, headers, body)``."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run_through(app):
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, url, headers in requests:
                r = await client.request(method, url, headers=headers)
                out.append((r.status, r.headers, await r.read()))
        return out

    jax_telemetry.reset()
    telemetry.reset()
    jax = asyncio.run(run_through(jax_app(JaxConfig.from_dict(dict(raw)))))
    handler = port_handler or ImageRegionHandler(build_services(
        AppConfig.from_dict(dict(raw)), "cpu"))
    port = asyncio.run(run_through(create_app(
        AppConfig.from_dict(dict(raw)), "cpu", handler=handler)))
    return jax, port


def cache_headers(headers) -> dict:
    return {k: headers.get(k) for k in CACHE_HEADERS}


def frames_of(body: bytes):
    """The frame bodies of an animation stream (``FRME`` + u32be length +
    body, in order)."""
    out, i = [], 0
    while i < len(body):
        assert body[i:i + 4] == b"FRME"
        n = int.from_bytes(body[i + 4:i + 8], "big")
        out.append(body[i + 8:i + 8 + n])
        i += 8 + n
    return out
