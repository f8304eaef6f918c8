"""Port handler and app against the JAX handler, over one pyramid written
by the JAX package's ``io.store.build_pyramid``.

Both handlers serve in their default posture: the batching renderer, the
device raw cache and single-flight (the JAX side with
``cpu_fallback_max_px=0``, so its every region goes to the device, and with
its cache's content-digest dedup, which the port leaves off; neither
changes a byte).  The device JPEG cases run through the port's reference
handler too, ``build_handler(batcher=False)``: the direct renderer.  png /
tif: identical bytes.  jpeg above ``jpeg_host_max_px``: the device route's
bytes equal the JAX handler's device-route bytes.  jpeg at or below it
(the default 256^2, which every tile here is): the port encodes the device
RGBA with PIL, the JAX tiny path's bytes, so they equal
``codecs.encode_rgba(jax_rgba, "jpeg", q)`` of the JAX render's pixels.
The JAX handler is built for each request: its batcher serves the one
event loop it started on.
"""

import asyncio
import json

import numpy as np
import pytest

from omero_ms_image_region_tpu import codecs as jax_codecs
from omero_ms_image_region_tpu.flagship import synthetic_wsi_tiles
from omero_ms_image_region_tpu.io.service import PixelsService as JaxPixels
from omero_ms_image_region_tpu.io.store import (
    ChunkedPyramidStore as JaxStore, build_pyramid as jax_build_pyramid,
)
from omero_ms_image_region_tpu.ops import jpegenc as jax_jpegenc
from omero_ms_image_region_tpu.ops.lut import LutProvider as JaxLuts
from omero_ms_image_region_tpu.server.ctx import (
    ImageRegionCtx as JaxCtx,
)
from omero_ms_image_region_tpu.io.devicecache import (
    DeviceRawCache as JaxRawCache,
)
from omero_ms_image_region_tpu.server.batcher import (
    BatchingRenderer as JaxBatcher,
)
from omero_ms_image_region_tpu.server.handler import (
    ImageRegionHandler as JaxHandler, ImageRegionServices as JaxServices,
)
from omero_ms_image_region_tpu.server.singleflight import (
    SingleFlight as JaxSingleFlight,
)
from omero_ms_image_region_tpu.services.cache import CacheConfig, Caches
from omero_ms_image_region_tpu.services.metadata import (
    CanReadMemo, LocalMetadataService as JaxMetadata,
)
from omero_ms_image_region_tpu_torch import codecs
from omero_ms_image_region_tpu_torch.ops import jpegenc
from omero_ms_image_region_tpu_torch.io.store import (
    ChunkedPyramidStore, build_pyramid,
)
from omero_ms_image_region_tpu_torch.server.app import (
    build_handler, create_app,
)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.server.errors import (
    BadRequestError, NotFoundError,
)
from omero_ms_image_region_tpu_torch.server.region import RegionDef
from omero_ms_image_region_tpu_torch.server.settings import (
    render_identity_key,
)
from omero_ms_image_region_tpu_torch.utils import transient

IMG = 7
PRIVATE = 8
SMOOTH = 9          # blob content: JPEG tiles that fit the sparse wire
H, W = 48, 64
LUT = np.random.default_rng(9).integers(0, 256, (256, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    planes = np.random.default_rng(3).integers(
        0, 60000, size=(2, 2, H, W)).astype(np.uint16)
    jax_build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32),
                      n_levels=2)
    jax_build_pyramid(planes[:, :1], str(root / str(PRIVATE)),
                      chunk=(32, 32), n_levels=1)
    smooth = synthetic_wsi_tiles(np.random.default_rng(4), 2, 2, H, W)
    jax_build_pyramid(smooth.transpose(1, 0, 2, 3).copy(),
                      str(root / str(SMOOTH)), chunk=(32, 32), n_levels=2)
    (root / str(PRIVATE) / "acl.json").write_text(
        json.dumps({"sessions": ["someone"]}))
    luts = tmp_path_factory.mktemp("luts")
    (luts / "fire.lut").write_bytes(LUT.T.tobytes())      # 768-byte form
    return str(root), str(luts)


class JaxDefault:
    """Runs one request through a JAX handler in its default posture."""

    def __init__(self, data_dir, lut_root):
        self.data_dir, self.lut_root = data_dir, lut_root

    def __call__(self, params) -> bytes:
        handler = JaxHandler(JaxServices(
            pixels_service=JaxPixels(self.data_dir),
            metadata=JaxMetadata(self.data_dir),
            caches=Caches.from_config(CacheConfig()),
            can_read_memo=CanReadMemo(),
            renderer=JaxBatcher(),
            lut_provider=JaxLuts(self.lut_root),
            raw_cache=JaxRawCache(),
            single_flight=JaxSingleFlight(),
            cpu_fallback_max_px=0,
        ))

        async def go():
            try:
                return await handler.render_image_region(
                    JaxCtx.from_params(params))
            finally:
                await handler.s.renderer.close()
        return run(go())


@pytest.fixture(scope="module")
def handlers(dirs):
    data_dir, lut_root = dirs
    return JaxDefault(data_dir, lut_root), build_handler(data_dir, lut_root,
                                                        device="cpu")


@pytest.fixture(scope="module", params=["batcher", "direct"])
def device_jpeg_handler(request, dirs):
    """The port handler with every JPEG region on the device route: the
    default posture, and the direct reference (``batcher=False``)."""
    return build_handler(*dirs, device="cpu", jpeg_host_max_px=0,
                         batcher=request.param == "batcher")


def _ctx(params):
    return ImageRegionCtx.from_params(params)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _params(**extra):
    p = {"imageId": str(IMG), "theZ": "1", "theT": "0", "m": "c",
         "c": "1|100:50000$FF0000,2|0:60000$00FF00", "format": "png"}
    p.update(extra)
    return p


CASES = {
    "tile": {"tile": "0,1,0,32,32"},
    "tile_res1": {"tile": "1,0,0,16,16"},
    "edge_tile": {"tile": "0,1,1,48,32"},
    "region": {"region": "5,7,40,30"},
    "flip_h": {"tile": "0,1,0,32,32", "flip": "h"},
    "flip_v": {"region": "5,7,40,30", "flip": "v"},
    "flip_hv": {"tile": "0,0,1,32,16", "flip": "hv"},
    "greyscale": {"tile": "0,0,0,32,32", "m": "g"},
    "reverse": {"tile": "0,0,0,32,32",
                "maps": '[{"reverse": {"enabled": true}}, {}]'},
    "lut": {"tile": "0,0,0,32,32", "c": "1|100:50000$fire.lut,2|0:60000$00FF00"},
    "one_channel": {"region": "0,0,64,48", "c": "-1|0:1$FF0000,2|0:60000$0000FF"},
    "whole_plane": {},
    "tif": {"tile": "0,1,0,32,32", "format": "tif"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_handler_bytes_match_jax(handlers, case):
    jax, port = handlers
    params = _params(**CASES[case])
    want = jax(params)
    got = run(port.render_image_region(ImageRegionCtx.from_params(params)))
    assert got == want


@pytest.mark.parametrize("q", [None, "0.5"])
def test_handler_jpeg_is_pil_encode_of_the_jax_pixels(handlers, q):
    jax, port = handlers
    params = _params(tile="0,1,0,32,32", flip="v")
    png = jax(params)
    jax_rgba = jax_codecs.decode_to_rgba(png)
    params.update(format="jpeg")
    if q is not None:
        params["q"] = q
    got = run(port.render_image_region(ImageRegionCtx.from_params(params)))
    assert got == jax_codecs.encode_rgba(
        jax_rgba, "jpeg", None if q is None else float(q))


JPEG_CASES = {
    "tile": {"tile": "0,1,0,32,32"},
    "edge_tile": {"tile": "0,1,1,48,32"},
    "region": {"region": "5,7,40,30"},
    "flip_h": {"region": "5,7,40,30", "flip": "h"},
    "flip_v": {"tile": "0,1,0,32,32", "flip": "v"},
    "flip_hv": {"region": "3,2,37,45", "flip": "hv"},
    # Uniform noise overflows twice the wire cap: the dense route.
    "noise_tile": {"tile": "0,0,0,32,32", "imageId": str(IMG)},
}


@pytest.mark.parametrize("q", [None, "0.5", "0.9"])
@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_handler_jpeg_matches_jax(handlers, device_jpeg_handler, case, q):
    """The device JPEG route: the JAX handler's bytes (render, coefficient
    front end, sparse wire, native coder), flips and edge MCUs included."""
    jax, _ = handlers
    params = _params(format="jpeg", imageId=str(SMOOTH))
    params.update(JPEG_CASES[case])
    if q is not None:
        params["q"] = q
    jax_jpegenc._CAP_MEMO.clear()
    jpegenc._CAP_MEMO.clear()
    want = jax(params)
    got = run(device_jpeg_handler.render_image_region(
        ImageRegionCtx.from_params(params)))
    assert got[:2] == b"\xff\xd8" and got == want
    if device_jpeg_handler.s.raw_cache is not None:
        # The batcher codes from its bucket's frame, as JAX's does; the
        # direct route's B=1 frame is the tile's own, with its own cap.
        assert jpegenc._CAP_MEMO == jax_jpegenc._CAP_MEMO


def test_handler_errors(handlers):
    jax, port = handlers
    # A projection past the stack raises the JAX handler's ValueError (a
    # 500 in both apps); a projection inside it renders, as JAX does.
    for params, err in ((_params(imageId="99"), NotFoundError),
                        (_params(imageId=str(PRIVATE)), NotFoundError),
                        (_params(theZ="5"), BadRequestError),
                        (_params(theT="-1"), BadRequestError),
                        (_params(tile="4,0,0"), BadRequestError),
                        (_params(c="-1|0:1$FF0000,-2|0:1$FF0000"),
                         BadRequestError),
                        (_params(p="intmax|0:2"), ValueError),
                        (_params(format="gif"), NotFoundError)):
        with pytest.raises(err):
            run(port.render_image_region(ImageRegionCtx.from_params(params)))
    projected = _params(p="intmax|0:1")
    assert run(port.render_image_region(
        ImageRegionCtx.from_params(projected))) == jax(projected)


def test_app_get_matches_handler_and_maps_errors(dirs, handlers):
    from aiohttp.test_utils import TestClient, TestServer

    _, port = handlers
    base = f"/webgateway/render_image_region/{IMG}/1/0"
    query = {k: v for k, v in _params(tile="0,1,0,32,32").items()
             if k not in ("imageId", "theZ", "theT")}
    want = run(port.render_image_region(ImageRegionCtx.from_params(
        _params(tile="0,1,0,32,32"))))

    async def go():
        app = create_app(AppConfig(data_dir=dirs[0], lut_root=dirs[1]),
                         handler=port)
        async with TestClient(TestServer(app)) as client:
            r = await client.get(base + "/trailing/ignored", params=query)
            body = await r.read()
            assert (r.status, r.headers["Content-Type"]) == (200,
                                                            "image/png")
            r404 = await client.get(
                f"/webgateway/render_image/99/0/0", params=query)
            r400 = await client.get(
                f"/webclient/render_image/{IMG}/9/0", params=query)
            opts = await client.options("/")
            health = await client.get("/healthz")
            return (body, r404.status, r400.status, await opts.json(),
                    health.status)

    body, s404, s400, opts, health = run(go())
    assert body == want
    assert (s404, s400, health) == (404, 400, 200)
    assert opts["provider"] == "ImageRegionMicroservice"


def test_port_store_reads_and_writes_the_jax_layout(dirs, tmp_path):
    data_dir, _ = dirs
    jax_store = JaxStore(f"{data_dir}/{IMG}")
    store = ChunkedPyramidStore(f"{data_dir}/{IMG}")
    assert store.resolution_descriptions() == \
        jax_store.resolution_descriptions()
    for level, region in ((0, RegionDef(5, 7, 40, 30)),
                          (1, RegionDef(0, 0, 32, 24))):
        np.testing.assert_array_equal(
            store.get_region(1, 1, 0, region, level),
            jax_store.get_region(1, 1, 0, region, level))
    planes = np.random.default_rng(1).integers(
        0, 9000, size=(1, 1, 40, 24)).astype(np.uint16)
    build_pyramid(planes, str(tmp_path / "port"), chunk=(16, 16),
                  min_level_size=8)
    jax_build_pyramid(planes, str(tmp_path / "jax"), chunk=(16, 16),
                      min_level_size=8)
    for name in ("meta.json", "level_0.dat", "level_1.dat"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_codecs_match_jax():
    rgba = np.random.default_rng(2).integers(
        0, 256, size=(9, 11, 4)).astype(np.uint8)
    for fmt in ("png", "tif", "jpeg"):
        assert codecs.encode_rgba(rgba, fmt, 0.7) == \
            jax_codecs.encode_rgba(rgba, fmt, 0.7)


@pytest.mark.parametrize("case", [
    {"tile": "0,1,0,32,32", "flip": "hv"},
    {"region": "3,2,37,45", "flip": "v", "format": "jpeg"},
    {"tile": "0,1,0,32,32", "format": "jpeg", "q": "0.9"},
])
def test_direct_renderer_matches_default_posture(dirs, handlers, case):
    """``build_handler(batcher=False)``, the direct route with no raw
    cache and no single-flight, gives the default app's bytes."""
    jax, _ = handlers
    params = _params(imageId=str(SMOOTH), **case)
    direct = build_handler(*dirs, device="cpu", jpeg_host_max_px=0,
                           batcher=False)
    default = build_handler(*dirs, device="cpu", jpeg_host_max_px=0)
    got = run(direct.render_image_region(_ctx(params)))
    assert got == run(default.render_image_region(_ctx(params)))
    assert got == jax(params)


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_rewindow_from_warm_raw_cache_matches_cold(dirs, handlers, fmt):
    """A re-window of a cached tile is a raw-cache hit (no read, no copy)
    and gives the bytes of a cold render and of the JAX handler."""
    jax, _ = handlers
    handler = build_handler(*dirs, device="cpu", jpeg_host_max_px=0)
    cache = handler.s.raw_cache
    first = _params(format=fmt, imageId=str(SMOOTH), region="3,2,37,45",
                    flip="h")
    second = dict(first, c="1|300:30000$FF0000,2|100:50000$00FF00")
    run(handler.render_image_region(_ctx(first)))
    hits, misses = cache.hits, cache.misses
    warm = run(handler.render_image_region(_ctx(second)))
    assert (cache.hits, cache.misses) == (hits + 1, misses)
    cold = run(build_handler(*dirs, device="cpu", jpeg_host_max_px=0,
                             batcher=False).render_image_region(
        _ctx(second)))
    assert warm == cold == jax(second)


class _Gated:
    """A renderer that counts calls and holds each until its gate opens."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0
        self.gate = None

    async def render(self, *args):
        self.calls += 1
        await self.gate.wait()
        return await self.inner.render(*args)

    async def render_jpeg(self, *args):
        self.calls += 1
        await self.gate.wait()
        return await self.inner.render_jpeg(*args)

    async def close(self):
        await self.inner.close()


def _run_gated(handler, params_list, open_when):
    gated = _Gated(handler.s.renderer)
    handler.s.renderer = gated

    async def main():
        gated.gate = asyncio.Event()
        tasks = [asyncio.ensure_future(handler.render_image_region(
            _ctx(p))) for p in params_list]
        # Let every request reach the single-flight table before the gate
        # opens (one arriving after the leader settled would not
        # coalesce).
        for _ in range(3000):
            await asyncio.sleep(0.01)
            if open_when():
                break
        assert open_when()
        gated.gate.set()
        try:
            return await asyncio.gather(*tasks)
        finally:
            await gated.close()
    return gated, run(main())


def test_concurrent_identical_requests_render_once(dirs, handlers):
    jax, _ = handlers
    handler = build_handler(*dirs, device="cpu")
    flight = handler.s.single_flight
    params = _params(tile="0,1,0,32,32")
    n = 6
    gated, bodies = _run_gated(handler, [params] * n,
                               lambda: flight.hits == n - 1)
    assert gated.calls == 1                     # one pipeline run
    assert gated.inner.tiles_rendered == 1      # one tile rendered
    assert set(bodies) == {jax(params)}
    assert (flight.hits, flight.misses, flight.inflight()) == (n - 1, 1, 0)


def test_different_requests_do_not_coalesce(dirs):
    handler = build_handler(*dirs, device="cpu")
    flight = handler.s.single_flight
    a = _params(tile="0,1,0,32,32", c="1|0:60000$FF0000")
    b = _params(tile="0,1,0,32,32", c="1|0:30000$FF0000")
    gated, (one, two) = _run_gated(handler, [a, b],
                                   lambda: flight.inflight() == 2)
    assert one != two
    assert gated.calls == 2 and flight.hits == 0


@pytest.mark.parametrize("single_flight", [True, False])
def test_deadline_bounds_the_await(dirs, single_flight):
    """A request whose budget runs out while its render is held gets
    ``DeadlineExceededError`` at budget end, with single-flight (the
    waiter's own budget) and without it (the handler's bounded await, in
    the reference handler, which has no single-flight)."""
    handler = build_handler(*dirs, device="cpu", batcher=single_flight)
    assert (handler.s.single_flight is not None) == single_flight
    gated = _Gated(handler.s.renderer)
    handler.s.renderer = gated

    async def main():
        gated.gate = asyncio.Event()
        try:
            with transient.deadline_scope(200.0):
                with pytest.raises(transient.DeadlineExceededError):
                    await handler.render_image_region(
                        _ctx(_params(tile="0,1,0,32,32")))
        finally:
            gated.gate.set()
            await gated.close()
    run(main())
    assert gated.calls == 1


def test_app_maps_a_spent_request_deadline_to_504(dirs):
    """``fault-tolerance.request-deadline-ms`` opens each request's budget;
    a budget spent before the render answers 504, and a generous one
    serves the request."""
    from aiohttp.test_utils import TestClient, TestServer

    query = {k: v for k, v in _params(tile="0,1,0,32,32").items()
             if k not in ("imageId", "theZ", "theT")}
    url = f"/webgateway/render_image_region/{IMG}/1/0"

    async def go(budget_ms):
        app = create_app(AppConfig.from_dict({
            "data-dir": dirs[0],
            "omero.server": {"omero.script_repo_root": dirs[1]},
            "fault-tolerance": {"request-deadline-ms": budget_ms}}),
            device="cpu")
        async with TestClient(TestServer(app)) as client:
            r = await client.get(url, params=query)
            return r.status, await r.read()

    status, body = run(go(1e-6))
    assert status == 504 and b"deadline" in body
    assert run(go(60_000.0))[0] == 200


def test_param_order_shares_identity():
    a = _ctx({"imageId": str(IMG), "theZ": "0", "theT": "0", "m": "c",
              "c": "1|0:60000$FF0000", "format": "png"})
    b = _ctx({"format": "png", "c": "1|0:60000$FF0000", "m": "c",
              "theT": "0", "theZ": "0", "imageId": str(IMG)})
    assert render_identity_key(a) == render_identity_key(b)


def test_flipped_ragged_tiles_share_a_group(dirs, handlers):
    """Ragged tiles with mixed flips in one bucket group: each is mirrored
    before its edge padding, and each gives the JAX handler's bytes."""
    jax, _ = handlers
    handler = build_handler(*dirs, device="cpu", jpeg_host_max_px=0)
    batcher = handler.s.renderer
    # Co-arrivals on a CPU run are spread by their thread hops.
    batcher.linger_ms = 1000.0
    params = [_params(format="jpeg", imageId=str(SMOOTH), **case)
              for case in ({"region": "5,7,40,30", "flip": "h"},
                           {"region": "3,2,37,45", "flip": "hv"},
                           {"tile": "0,1,1,48,32", "flip": "v"},
                           {"tile": "0,1,0,32,32"})]

    async def main():
        try:
            return await asyncio.gather(*(
                handler.render_image_region(_ctx(p)) for p in params))
        finally:
            await batcher.close()

    got = run(main())
    assert batcher.tiles_rendered == len(params)
    assert batcher.batches_dispatched < len(params)
    for p, body in zip(params, got):
        assert body == jax(p)
