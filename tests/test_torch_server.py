"""Port handler and app against the JAX handler, over one pyramid written
by the JAX package's ``io.store.build_pyramid``.

png / tif: identical bytes.  jpeg above ``jpeg_host_max_px``: the device
route's bytes equal the JAX handler's device-route bytes (its
``cpu_fallback_max_px=0``).  jpeg at or below it (the default 256^2, which
every tile here is): the port encodes the device RGBA with PIL, the JAX
tiny path's bytes, so they equal ``codecs.encode_rgba(jax_rgba, "jpeg",
q)`` of the JAX render's pixels.
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
from omero_ms_image_region_tpu.server.handler import (
    ImageRegionHandler as JaxHandler, ImageRegionServices as JaxServices,
    Renderer as JaxRenderer,
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
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.server.errors import (
    BadRequestError, NotFoundError,
)
from omero_ms_image_region_tpu_torch.server.region import RegionDef

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


@pytest.fixture(scope="module")
def handlers(dirs):
    data_dir, lut_root = dirs
    jax = JaxHandler(JaxServices(
        pixels_service=JaxPixels(data_dir),
        metadata=JaxMetadata(data_dir),
        caches=Caches.from_config(CacheConfig()),
        can_read_memo=CanReadMemo(),
        renderer=JaxRenderer(kernel="xla"),
        lut_provider=JaxLuts(lut_root),
        cpu_fallback_max_px=0,
    ))
    return jax, build_handler(data_dir, lut_root, device="cpu")


@pytest.fixture(scope="module")
def device_jpeg_handler(dirs):
    """The port handler with every JPEG region on the device route."""
    return build_handler(*dirs, device="cpu", jpeg_host_max_px=0)


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
    want = run(jax.render_image_region(JaxCtx.from_params(params)))
    got = run(port.render_image_region(ImageRegionCtx.from_params(params)))
    assert got == want


@pytest.mark.parametrize("q", [None, "0.5"])
def test_handler_jpeg_is_pil_encode_of_the_jax_pixels(handlers, q):
    jax, port = handlers
    params = _params(tile="0,1,0,32,32", flip="v")
    png = run(jax.render_image_region(JaxCtx.from_params(params)))
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
    want = run(jax.render_image_region(JaxCtx.from_params(params)))
    got = run(device_jpeg_handler.render_image_region(
        ImageRegionCtx.from_params(params)))
    assert got[:2] == b"\xff\xd8" and got == want
    assert jpegenc._CAP_MEMO == jax_jpegenc._CAP_MEMO


def test_handler_errors(handlers):
    _, port = handlers
    for params, err in ((_params(imageId="99"), NotFoundError),
                        (_params(imageId=str(PRIVATE)), NotFoundError),
                        (_params(theZ="5"), BadRequestError),
                        (_params(theT="-1"), BadRequestError),
                        (_params(tile="4,0,0"), BadRequestError),
                        (_params(c="-1|0:1$FF0000,-2|0:1$FF0000"),
                         BadRequestError),
                        (_params(p="intmax|0:1"), BadRequestError),
                        (_params(format="gif"), NotFoundError)):
        with pytest.raises(err):
            run(port.render_image_region(ImageRegionCtx.from_params(params)))


def test_app_get_matches_handler_and_maps_errors(dirs, handlers):
    from aiohttp.test_utils import TestClient, TestServer

    _, port = handlers
    base = f"/webgateway/render_image_region/{IMG}/1/0"
    query = {k: v for k, v in _params(tile="0,1,0,32,32").items()
             if k not in ("imageId", "theZ", "theT")}
    want = run(port.render_image_region(ImageRegionCtx.from_params(
        _params(tile="0,1,0,32,32"))))

    async def go():
        app = create_app(*dirs, handler=port)
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
