"""First-tile-out settlement against the JAX app's, on the CPU.

Both default apps are built from one config dict with ``wire.streaming``
on or off.  Two JPEG GETs of distinct regions share one batcher group (a
long linger; a stand-in in-flight group keeps each batcher busy, since a
lone request on an idle batcher dispatches at once), and the group's
second tile is held in the coder: each
package's ``render_batch_to_jpeg`` is wrapped so that its ``on_tile`` for
tile 1 waits on an event (nothing in the JAX package changes).  With
streaming on, the request coded first answers while its sibling is held;
with streaming off, neither answers before the group's barrier.  The bytes
are the same in both apps and both modes.
"""

import asyncio
import threading

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.ops import jpegenc as jax_jpegenc
from omero_ms_image_region_tpu.server.app import SERVICES_KEY
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu_torch.server import batcher
from omero_ms_image_region_tpu_torch.server.app import _front_key, create_app
from omero_ms_image_region_tpu_torch.server.config import AppConfig

IMG = 6
BASE = f"/webgateway/render_image_region/{IMG}/0/0"
QUERIES = [{"c": "1|100:50000$FF0000,2|0:60000$00FF00", "m": "c",
            "format": "jpeg", "region": region}
           for region in ("0,0,64,64", "64,0,64,64")]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("settlement")
    planes = np.random.default_rng(16).integers(
        0, 60000, size=(2, 1, 64, 128)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


def _raw(data_dir, streaming: bool) -> dict:
    return {"data-dir": data_dir, "wire": {"streaming": streaming},
            "renderer": {"cpu-fallback-max-px": 0},
            "batcher": {"linger-ms": 300.0},
            "raw-cache": {"prefetch": False},
            "watchdog": {"enabled": False}, "sentinel": {"enabled": False}}


def _holding(real, held: threading.Event, release: threading.Event):
    """``real`` with tile 1's ``on_tile`` held until ``release``."""
    def wrapped(*args, on_tile=None, **kwargs):
        def hold(i, data):
            if i == 1:
                held.set()
                release.wait(timeout=30)
            if on_tile is not None:
                on_tile(i, data)
        return real(*args, on_tile=hold, **kwargs)
    return wrapped


async def _scenario(app, renderer, held: threading.Event,
                    release: threading.Event, streaming: bool):
    """The two GETs at once; how many answered while tile 1 was held, and
    each answer's status and body."""
    loop = asyncio.get_running_loop()
    if hasattr(renderer, "_bind"):
        renderer._bind(loop)       # the port's: binding clears _inflight
    busy = loop.create_future()
    renderer._inflight.add(busy)
    async with TestClient(TestServer(app)) as client:
        async def fetch(q):
            r = await client.get(BASE, params=q)
            return r.status, await r.read()

        gets = [asyncio.ensure_future(fetch(q)) for q in QUERIES]
        try:
            for _ in range(3000):
                if held.is_set():
                    break
                await asyncio.sleep(0.01)
            assert held.is_set(), "the two GETs never shared a group"
            # Streaming: wait for the first answer; barrier: give one the
            # time it would need.
            t0 = loop.time()
            while (not any(g.done() for g in gets)
                   and loop.time() - t0 < (20.0 if streaming else 1.0)):
                await asyncio.sleep(0.01)
            answered = sum(g.done() for g in gets)
        finally:
            release.set()
            busy.set_result(None)
            renderer._inflight.discard(busy)
        return answered, [await g for g in gets]


@pytest.mark.parametrize("streaming", [True, False])
def test_settlement_follows_wire_streaming_as_jax(data_dir, monkeypatch,
                                                  streaming):
    results = {}
    for name, module, attr, make in (
            ("jax", jax_jpegenc, "render_batch_to_jpeg",
             lambda: jax_app(JaxConfig.from_dict(_raw(data_dir, streaming)))),
            ("port", batcher, "render_batch_to_jpeg",
             lambda: create_app(AppConfig.from_dict(
                 _raw(data_dir, streaming)), "cpu"))):
        held, release = threading.Event(), threading.Event()
        monkeypatch.setattr(module, attr, _holding(getattr(module, attr),
                                                   held, release))
        app = make()
        renderer = (app[_front_key()].services if name == "port"
                    else app[SERVICES_KEY]).renderer
        assert renderer.first_tile_out == streaming
        results[name] = asyncio.run(_scenario(app, renderer, held, release,
                                              streaming))
        monkeypatch.undo()
    for name, (answered, answers) in results.items():
        assert answered == (1 if streaming else 0), name
        assert [status for status, _ in answers] == [200, 200], name
    jax_bodies = [body for _, body in results["jax"][1]]
    port_bodies = [body for _, body in results["port"][1]]
    assert port_bodies == jax_bodies
    assert all(b[:2] == b"\xff\xd8" for b in port_bodies)
    assert port_bodies[0] != port_bodies[1]
