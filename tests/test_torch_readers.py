"""The port's pixel readers (OME-TIFF, OME-NGFF, JPEG-in-TIFF, the chunked
store) against the JAX package's, and both default apps over them.

Every layout is written into ``tmp_path`` with the JAX package's writers,
PIL's JPEG encoder or the plain encoders of ``torch_tiff_fixtures``, and
read through both packages' ``PixelsService``: each region at each level,
z, c and t is ``np.array_equal`` to the JAX reader's, read fresh and into a
preallocated ``out=`` array; each Z-stack too; the level table, tile size,
dtype, Pixels description and ``Last-Modified`` source stamp are equal
(the in-memory source too, by itself).  A JPEG 2000 TIFF (33003) reads
as the JAX reader reads it.

``test_default_apps_serve_alike`` builds both default apps from one config
dict over an OME-TIFF and an NGFF image (every JPEG on the device route)
and holds each answer's status, body, ``ETag``, ``Last-Modified``,
``Cache-Control`` and ``Content-Type`` equal; ``POST /pyramid`` on a bare
TIFF answers alike in both (202 with equal job documents, the same 400s
and 404), and once both jobs are done a resolution-1 GET gives the same
bytes.
"""

import asyncio
import io
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from omero_ms_image_region_tpu.io.memory import (
    InMemoryPixelSource as JaxInMemory)
from omero_ms_image_region_tpu.io.ngff import write_ngff
from omero_ms_image_region_tpu.io.service import (
    PixelsService as JaxPixelsService)
from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.io.tiffwrite import write_ome_tiff
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.services.metadata import (
    LocalMetadataService as JaxMetadata)
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.io.memory import InMemoryPixelSource
from omero_ms_image_region_tpu_torch.io.service import PixelsService
from omero_ms_image_region_tpu_torch.server.app import create_app
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.region import RegionDef
from omero_ms_image_region_tpu_torch.services.metadata import (
    LocalMetadataService)
from omero_ms_image_region_tpu_torch.utils import telemetry

from torch_tiff_fixtures import jpeg12_stream, split_jpeg_tables, write_tiff
from vendor_tiff import smooth_rgb, write_jp2k_tiff

_OME_NS = 'xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06"'


def _u16(seed, shape):
    return np.random.default_rng(seed).integers(
        0, 60000, size=shape).astype(np.uint16)


def _ome_tiled(compression):
    def write(d):
        write_ome_tiff(_u16(1, (1, 2, 2, 200, 168)),
                       os.path.join(d, "img.ome.tiff"), tile=(64, 64),
                       compression=compression, n_levels=2)
    return write


def _tiled_deflate_predictor2(d):
    write_tiff(os.path.join(d, "p2.tif"), [_u16(2, (150, 190))],
               tile=(64, 64), compression=8, predictor=2)


def _stripped_lzw_int16(d):
    page = np.random.default_rng(3).integers(
        -30000, 30000, size=(97, 150)).astype(np.int16)
    write_tiff(os.path.join(d, "lzw.tif"), [page], tiled=False,
               rows_per_strip=13, compression=5)


def _packbits_uint8(d):
    rng = np.random.default_rng(4)
    pages = [np.repeat(rng.integers(0, 4, size=(60, 20)), 5, axis=1)
             .astype(np.uint8) for _ in range(3)]
    write_tiff(os.path.join(d, "pb.tif"), pages, tiled=False,
               rows_per_strip=16, compression=32773)


def _bigtiff_float32(d):
    page = np.random.default_rng(5).normal(0, 100, (90, 130)).astype(
        np.float32)
    write_tiff(os.path.join(d, "big.tif"), [page], tile=(64, 64),
               compression=8, predictor=3, bigtiff=True)


def _jfif(tile, quality=90):
    buf = io.BytesIO()
    Image.fromarray(tile).save(buf, "jpeg", quality=quality)
    return buf.getvalue()


def _jpeg7_rgb_tables(d):
    """Tiled RGB JPEG-in-TIFF: per-tile abbreviated streams sharing one
    JPEGTables stream (PIL's standard tables at one quality)."""
    rng = np.random.default_rng(6)
    img = smooth_rgb(128, 160)
    img = (img.astype(np.int16) + rng.integers(-20, 20, img.shape)) \
        .clip(0, 255).astype(np.uint8)
    tables, streams = None, []
    for gy in range(2):
        for gx in range(3):
            tile = np.zeros((64, 64, 3), np.uint8)
            part = img[gy * 64:(gy + 1) * 64, gx * 64:(gx + 1) * 64]
            tile[:part.shape[0], :part.shape[1]] = part
            tables, stream = split_jpeg_tables(_jfif(tile))
            streams.append(stream)
    write_tiff(os.path.join(d, "j7.tif"), [img], tile=(64, 64),
               compression=7, photometric=6, segments=[streams],
               jpeg_tables=tables)


def _jpeg12(d):
    """A tiled 12-bit JPEG TIFF: 8x8 tiles, one SOF1 block each."""
    streams = [jpeg12_stream(97 * k + 5) for k in range(6)]
    write_tiff(os.path.join(d, "j12.tif"), [np.zeros((16, 24), np.uint16)],
               tile=(8, 8), compression=7, segments=[streams], bits=12)


def _old_jpeg6(d):
    """Old-style JPEG (compression 6): one JFIF for the whole image,
    reached through JPEGInterchangeFormat, sliced into strips."""
    img = _content_gray(80, 100)
    write_tiff(os.path.join(d, "j6.tif"), [img], tiled=False,
               rows_per_strip=32, compression=6,
               segments=[[_jfif(img, quality=85)]], interchange=True)


def _content_gray(h, w):
    noise = np.random.default_rng(12).integers(-15, 15, (h, w))
    return (smooth_rgb(h, w)[..., 0].astype(np.int16) + noise).clip(
        0, 255).astype(np.uint8)


def _plain_multipage(d):
    """A plain TIFF of two full pages (Z) each followed by a reduced
    page (its level 1)."""
    rng = np.random.default_rng(7)
    full = [rng.integers(0, 4000, (96, 128)).astype(np.uint16)
            for _ in range(2)]
    pages = [full[0], full[0][::2, ::2], full[1], full[1][::2, ::2]]
    write_tiff(os.path.join(d, "pages.tif"), pages, tiled=False,
               rows_per_strip=16, reduced=(1, 3))


def _multifile_companion(d):
    W, H, Z, C = 64, 48, 2, 2
    planes = _u16(8, (C, Z, H, W))
    names = ["p0.ome.tiff", "p1.ome.tiff"]
    tds = "".join(
        f'<TiffData FirstZ="0" FirstC="{c}" FirstT="0" IFD="0" '
        f'PlaneCount="{Z}"><UUID FileName="{names[c]}">'
        f'urn:uuid:f{c}</UUID></TiffData>' for c in range(C))
    with open(os.path.join(d, "set.companion.ome"), "w") as f:
        f.write(f'<?xml version="1.0"?><OME {_OME_NS}><Image ID="Image:0">'
                f'<Pixels ID="Pixels:0" DimensionOrder="XYZCT" '
                f'Type="uint16" SizeX="{W}" SizeY="{H}" SizeZ="{Z}" '
                f'SizeC="{C}" SizeT="1" BigEndian="false">{tds}</Pixels>'
                f'</Image></OME>')
    stub = (f'<?xml version="1.0"?><OME {_OME_NS}><BinaryOnly '
            f'MetadataFile="set.companion.ome" UUID="urn:uuid:x"/></OME>')
    for c in range(C):
        write_ome_tiff(planes[c][None], os.path.join(d, names[c]),
                       tile=(64, 48), n_levels=1, description=stub)


def _ngff_zlib(d):
    """NGFF in a ``*.zarr`` child, T=2, edge chunks, one chunk missing
    (fill_value)."""
    root = os.path.join(d, "img.zarr")
    write_ngff(_u16(9, (2, 2, 1, 130, 150)), root, chunk=(64, 64),
               n_levels=2, compressor="zlib")
    os.remove(os.path.join(root, "0", "1.0.0.1.1"))


def _ngff_gzip_slash(d):
    write_ngff(_u16(10, (2, 2, 130, 150)), d, chunk=(64, 48), n_levels=2,
               compressor="gzip", dimension_separator="/")


def _chunked(d):
    build_pyramid(_u16(11, (2, 2, 130, 150)), d, chunk=(64, 64),
                  n_levels=2)


LAYOUTS = {
    "ome_tiled_none": _ome_tiled("none"),
    "ome_tiled_deflate": _ome_tiled("deflate"),
    "tiled_deflate_predictor2": _tiled_deflate_predictor2,
    "stripped_lzw_int16": _stripped_lzw_int16,
    "packbits_uint8": _packbits_uint8,
    "bigtiff_float32_predictor3": _bigtiff_float32,
    "jpeg7_rgb_tables": _jpeg7_rgb_tables,
    "jpeg12": _jpeg12,
    "old_jpeg6_interchange": _old_jpeg6,
    "plain_multipage_reduced_pages": _plain_multipage,
    "multifile_companion": _multifile_companion,
    "ngff_zlib": _ngff_zlib,
    "ngff_gzip_slash": _ngff_gzip_slash,
    "chunked_store": _chunked,
}
IDS = {name: i + 1 for i, name in enumerate(LAYOUTS)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("readers"))
    for name, write in LAYOUTS.items():
        d = os.path.join(root, str(IDS[name]))
        os.makedirs(d)
        write(d)
    return root


def _regions(sx, sy, tile):
    tw, th = tile
    out = [RegionDef(0, 0, sx, sy),
           RegionDef(tw // 2, th // 2, min(tw, sx - tw // 2),
                     min(th, sy - th // 2)),
           RegionDef(sx - min(37, sx), sy - min(29, sy), min(37, sx),
                     min(29, sy)),
           RegionDef(sx - 1, sy - 1, 1, 1)]
    return [r for r in out if r.width > 0 and r.height > 0]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_reader_reads_as_jax(tree, name):
    image = IDS[name]
    jax_service, service = JaxPixelsService(tree), PixelsService(tree)
    jax, src = (jax_service.get_pixel_source(image),
                service.get_pixel_source(image))
    try:
        assert type(src).__name__ == type(jax).__name__
        assert src.resolution_descriptions() == \
            jax.resolution_descriptions()
        assert src.tile_size() == jax.tile_size()
        assert src.dtype == jax.dtype
        sizes = (src.size_z, src.size_c, src.size_t)
        assert sizes == (jax.size_z, jax.size_c, jax.size_t)
        planes = [(z, c, t) for z in range(sizes[0])
                  for c in range(sizes[1]) for t in range(sizes[2])]
        for level, (sx, sy) in enumerate(src.resolution_descriptions()):
            for region in _regions(sx, sy, src.tile_size()):
                for z, c, t in planes:
                    want = jax.get_region(z, c, t, region, level)
                    got = src.get_region(z, c, t, region, level)
                    what = (level, region.as_tuple(), z, c, t)
                    assert got.dtype == want.dtype, what
                    assert np.array_equal(got, want), what
                    out = np.full(want.shape, 7, dtype=want.dtype)
                    assert src.get_region(z, c, t, region, level,
                                          out=out) is out
                    assert np.array_equal(out, want), what
        for c in range(sizes[1]):
            for t in range(sizes[2]):
                assert np.array_equal(src.get_stack(c, t),
                                      jax.get_stack(c, t))
    finally:
        jax_service.close()
        service.close()
    px = asyncio.run(LocalMetadataService(tree).get_pixels_description(
        image, None))
    jpx = asyncio.run(JaxMetadata(tree).get_pixels_description(image, None))
    fields = ("pixels_type", "size_x", "size_y", "size_z", "size_c",
              "size_t")
    assert [getattr(px, f) for f in fields] == \
        [getattr(jpx, f) for f in fields]
    assert LocalMetadataService(tree).source_mtime(image) == \
        JaxMetadata(tree).source_mtime(image)


def test_in_memory_source_reads_as_jax():
    planes = _u16(13, (2, 3, 70, 90))
    jax = JaxInMemory(planes, tile=(32, 32), pyramid_levels=3)
    src = InMemoryPixelSource(planes, tile=(32, 32), pyramid_levels=3)
    assert src.resolution_descriptions() == jax.resolution_descriptions()
    assert (src.tile_size(), src.dtype) == (jax.tile_size(), jax.dtype)
    for level, (sx, sy) in enumerate(src.resolution_descriptions()):
        for region in _regions(sx, sy, (32, 32)):
            want = jax.get_region(2, 1, 0, region, level)
            out = np.zeros_like(want)
            assert src.get_region(2, 1, 0, region, level, out=out) is out
            assert np.array_equal(out, want)
            assert np.array_equal(src.get_region(2, 1, 0, region, level),
                                  want)
    assert np.array_equal(src.get_stack(1, 0), jax.get_stack(1, 0))


def test_jp2k_tiff_reads_as_jax(tmp_path):
    """The 33003 (YCbCr) JPEG 2000 TIFF reads region for region as the
    JAX reader reads it, fresh and into an ``out=`` array."""
    d = tmp_path / "1"
    d.mkdir()
    write_jp2k_tiff(str(d / "wsi.tif"), smooth_rgb(64, 64), 33003)
    jax = JaxPixelsService(str(tmp_path)).get_pixel_source(1)
    src = PixelsService(str(tmp_path)).get_pixel_source(1)
    for region in (RegionDef(0, 0, 64, 64), RegionDef(5, 9, 37, 45)):
        for c in range(3):
            want = jax.get_region(0, c, 0, region, 0)
            assert np.array_equal(src.get_region(0, c, 0, region, 0), want)
            out = np.empty_like(want)
            src.get_region(0, c, 0, region, 0, out=out)
            assert np.array_equal(out, want)
    src.close()


def test_an_evicted_source_closes_once_no_reader_holds_it(tree):
    """The LRU parks an evicted TIFF source until its last reader lets it
    go, then closes it; ``invalidate`` does the same."""
    service = PixelsService(tree, max_open=1)
    held = service.get_pixel_source(IDS["ome_tiled_none"])
    service.get_pixel_source(IDS["chunked_store"])      # evicts ``held``
    assert not held._tf._f.closed                       # still read here
    region = RegionDef(0, 0, 64, 64)
    assert held.get_region(0, 0, 0, region, 0).shape == (64, 64)
    handle = held._tf._f
    del held
    service.get_pixel_source(IDS["chunked_store"])      # a hit drains
    assert handle.closed
    assert service.is_open(IDS["chunked_store"])
    service.invalidate(IDS["chunked_store"])
    assert service.get_open_source(IDS["chunked_store"]) is None
    service.close()


# ------------------------------------------------------ the default apps

CH = "c=1|0:60000$FF0000,2|0:60000$00FF00&m=c"
APP_IMAGES = {"tiff": 21, "ngff": 22}
BARE = 23
RAW = {"session-store": {"type": "static"},
       "renderer": {"cpu-fallback-max-px": 0},
       "pyramid": {"chunk": 128, "min-level-size": 128}}
CACHE_HEADERS = ("ETag", "Last-Modified", "Cache-Control", "Content-Type")


def _app_requests(image):
    region = f"/webgateway/render_image_region/{image}"
    return [
        ("GET", f"{region}/1/0?{CH}&tile=0,1,0,128,128&format=png", {}),
        ("GET", f"{region}/1/0?{CH}&tile=0,1,1,128,128&format=jpeg", {}),
        ("GET", f"{region}/0/0?{CH}&tile=1,0,0,128,128&format=jpeg", {}),
        ("GET", f"/webgateway/render_image/{image}/0/0?{CH}&format=jpeg",
         {}),
        ("GET", f"/webgateway/render_image/{image}/0/0?{CH}&format=png"
                f"&p=intmax|0:1", {}),
        ("GET", f"{region}/1/0?{CH}&tile=0,1,0,128,128&format=png",
         {"If-Modified-Since": "Fri, 01 Jan 2100 00:00:00 GMT"}),
    ]


REQUESTS = [r for image in APP_IMAGES.values() for r in _app_requests(image)]
STATUSES = [200, 200, 200, 200, 200, 304] * len(APP_IMAGES)


def _write_app_tree(root):
    planes = _u16(21, (2, 2, 256, 256))
    d = os.path.join(root, str(APP_IMAGES["tiff"]))
    os.makedirs(d)
    write_ome_tiff(planes, os.path.join(d, "img.ome.tiff"), tile=(128, 128),
                   compression="deflate", n_levels=2)
    write_ngff(_u16(22, (2, 2, 256, 256)),
               os.path.join(root, str(APP_IMAGES["ngff"]), "img.zarr"),
               chunk=(128, 128), n_levels=2)
    d = os.path.join(root, str(BARE))
    os.makedirs(d)
    write_ome_tiff(_u16(23, (2, 1, 256, 256)), os.path.join(d, "bare.tif"),
                   tile=(128, 128), n_levels=1)


async def _run_through(app, requests):
    from aiohttp.test_utils import TestClient, TestServer

    out = []
    async with TestClient(TestServer(app)) as client:
        for method, url, headers in requests:
            r = await client.request(method, url, headers=headers)
            out.append((r.status, r.headers, await r.read()))
    return out


async def _pyramid_flow(app):
    """The malformed POSTs, the build of the bare image (polled to its
    end), an unknown job, a resolution-1 GET and the /metrics scrape."""
    from aiohttp.test_utils import TestClient, TestServer

    bad = [b"not json", b"[1]", b"{}", b'{"imageId": "x"}',
           b'{"imageId": 999}']
    out = {}
    async with TestClient(TestServer(app)) as client:
        out["bad"] = []
        for body in bad:
            r = await client.post("/pyramid", data=body)
            out["bad"].append((r.status, await r.read()))
        r = await client.post("/pyramid", data=json.dumps(
            {"imageId": BARE}).encode())
        out["submit"] = (r.status, await r.json())
        job_id = out["submit"][1]["jobId"]
        for _ in range(1200):
            r = await client.get(f"/pyramid/{job_id}")
            doc = await r.json()
            if doc["state"] in ("done", "failed"):
                break
            await asyncio.sleep(0.05)
        out["done"] = doc
        out["unknown"] = (await client.get("/pyramid/pj-999")).status
        r = await client.get(f"/webgateway/render_image_region/{BARE}/0/0"
                             f"?{CH}&tile=1,0,0,128,128&format=png")
        out["level1"] = (r.status, await r.read())
        out["metrics"] = await (await client.get("/metrics")).text()
    return out


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """Both default apps over one tree (the GETs), then each over its own
    copy (a build writes into the image directory)."""
    root = str(tmp_path_factory.mktemp("apps"))
    _write_app_tree(os.path.join(root, "data"))
    raw = dict(RAW, **{"data-dir": os.path.join(root, "data")})
    jax_telemetry.reset()
    telemetry.reset()
    jax = asyncio.run(_run_through(jax_app(JaxConfig.from_dict(raw)),
                                   REQUESTS))
    port = asyncio.run(_run_through(
        create_app(AppConfig.from_dict(raw), "cpu"), REQUESTS))
    builds = {}
    for name, make, config in (("jax", jax_app, JaxConfig),
                               ("port", create_app, AppConfig)):
        data = os.path.join(root, name)
        shutil.copytree(os.path.join(root, "data"), data)
        raw = dict(RAW, **{"data-dir": data})
        app = (make(config.from_dict(raw)) if name == "jax"
               else make(config.from_dict(raw), "cpu"))
        builds[name] = (data, asyncio.run(_pyramid_flow(app)))
    return jax, port, builds


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_default_apps_serve_alike(apps, i):
    jax, port, _ = apps
    what = REQUESTS[i]
    assert port[i][0] == jax[i][0] == STATUSES[i], what
    assert port[i][2] == jax[i][2], what
    assert {h: port[i][1].get(h) for h in CACHE_HEADERS} == \
        {h: jax[i][1].get(h) for h in CACHE_HEADERS}, what
    if STATUSES[i] == 200:
        assert port[i][1]["Last-Modified"] and port[i][1]["ETag"]


@pytest.mark.parametrize("i", range(5))
def test_pyramid_post_refusals_answer_alike(apps, i):
    _, _, builds = apps
    jax, port = builds["jax"][1]["bad"][i], builds["port"][1]["bad"][i]
    assert port == jax
    assert port[0] == (404 if i == 4 else 400)


def test_pyramid_jobs_answer_alike(apps):
    _, _, builds = apps

    def doc_of(name, key):
        data, flow = builds[name]
        doc = dict(flow[key][1] if key == "submit" else flow[key])
        for k in ("jobId", "submittedAt", "doneAt"):
            doc.pop(k)
        for k in ("source", "dest"):
            doc[k] = os.path.relpath(doc[k], data)
        return doc

    assert builds["port"][1]["submit"][0] == \
        builds["jax"][1]["submit"][0] == 202
    assert doc_of("port", "submit") == doc_of("jax", "submit")
    done = doc_of("port", "done")
    assert done == doc_of("jax", "done")
    assert (done["state"], done["levelsDone"], done["levelsTotal"],
            done["dest"]) == ("done", 2, 2, f"{BARE}/pyramid.zarr")
    assert builds["port"][1]["unknown"] == builds["jax"][1]["unknown"] == 404


def test_pyramid_level_serves_alike(apps):
    _, _, builds = apps
    port, jax = builds["port"][1]["level1"], builds["jax"][1]["level1"]
    assert port[0] == jax[0] == 200
    assert port[1] == jax[1]


def test_pyramid_metrics_count_alike(apps):
    _, _, builds = apps

    def series(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith("imageregion_pyramid_"))

    port = series(builds["port"][1]["metrics"])
    assert port == series(builds["jax"][1]["metrics"])
    assert "imageregion_pyramid_levels_committed_total 2" in port
