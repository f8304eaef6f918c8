"""The port's OMERO binary-repository path against the JAX package's.

ROMIO: a legacy ``Pixels/<id>`` buffer (big-endian, XYZCT) read by the JAX
``RomioPixelSource`` and the port's, region for region (edge rows, full
width, every z, c and t; fresh and into an ``out=`` array), exactly
equal; a short file is refused alike.

Both default apps (``metadata-service: postgres``: the JAX app's own
startup swap on a stand-in ``asyncpg``, the port's on the ``db`` it is
given, one sqlite OMERO schema for both) over one repository root: a
ManagedRepository OME-TIFF fileset, a ROMIO buffer, an Aperio JPEG 2000
``.svs`` (33005), a fileset whose file is missing (404) and an outsider's
private image (404): every answer's status, body, ``ETag``,
``Cache-Control``, ``Vary`` and ``Content-Type`` are equal.
"""

import asyncio
import sys

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.romio import RomioPixelSource as JaxRomio
from omero_ms_image_region_tpu.io.tiffwrite import write_ome_tiff
from omero_ms_image_region_tpu.models.pixels import Pixels as JaxPixels
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu_torch.io.romio import RomioPixelSource
from omero_ms_image_region_tpu_torch.models.pixels import Pixels
from omero_ms_image_region_tpu_torch.server.app import create_app
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.region import RegionDef

from torch_db_fixtures import fake_asyncpg, seeded_db
from torch_workload_apps import cache_headers
from vendor_tiff import smooth_rgb, write_jp2k_tiff

SHAPE = (2, 3, 2, 37, 45)        # t, c, z, y, x of the ROMIO buffer


def _romio(path, dtype=np.uint16):
    t, c, z, y, x = SHAPE
    planes = np.random.default_rng(4).integers(
        0, np.iinfo(dtype).max, SHAPE).astype(dtype)
    # XYZCT: z fastest, then c, then t.
    path.write_bytes(planes.astype(np.dtype(dtype).newbyteorder(">"))
                     .tobytes())
    kw = dict(image_id=5, pixels_type=np.dtype(dtype).name, size_x=x,
              size_y=y, size_z=z, size_c=c, size_t=t)
    return planes, JaxPixels(**kw), Pixels(**kw)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_romio_regions_equal_jax(tmp_path, dtype):
    planes, jpx, ppx = _romio(tmp_path / "53", dtype)
    jax = JaxRomio(str(tmp_path / "53"), jpx)
    src = RomioPixelSource(str(tmp_path / "53"), ppx)
    assert src.dtype == jax.dtype
    assert src.resolution_descriptions() == jax.resolution_descriptions()
    assert src.tile_size() == jax.tile_size()
    regions = (RegionDef(0, 0, 45, 37), RegionDef(0, 30, 45, 7),
               RegionDef(40, 33, 5, 4), RegionDef(3, 5, 17, 11))
    for t in range(SHAPE[0]):
        for c in range(SHAPE[1]):
            for z in range(SHAPE[2]):
                for region in regions:
                    want = jax.get_region(z, c, t, region, 0)
                    assert np.array_equal(
                        want, planes[t, c, z, region.y:region.y
                                     + region.height,
                                     region.x:region.x + region.width])
                    got = src.get_region(z, c, t, region, 0)
                    assert got.dtype == want.dtype
                    assert np.array_equal(got, want)
                    out = np.empty_like(want)
                    src.get_region(z, c, t, region, 0, out=out)
                    assert np.array_equal(out, want)
            assert np.array_equal(src.get_stack(c, t), jax.get_stack(c, t))
    for bad in (lambda s: s.get_region(2, 0, 0, regions[0], 0),
                lambda s: s.get_region(0, 0, 0, RegionDef(40, 0, 6, 1), 0),
                lambda s: s.get_region(0, 0, 0, regions[0], 1)):
        errors = []
        for s in (jax, src):
            with pytest.raises(ValueError) as e:
                bad(s)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    (tmp_path / "short").write_bytes(b"\0" * 100)
    errors = []
    for cls, px in ((JaxRomio, jpx), (RomioPixelSource, ppx)):
        with pytest.raises(ValueError) as e:
            cls(str(tmp_path / "short"), px)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    src.close()
    jax.close()


# ------------------------------------------------------- the default apps

JP2K_IMAGE, MISSING_IMAGE = 6, 8


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """The repository root, an empty data directory, and the OMERO schema
    with the JAX seed plus an Aperio .svs fileset image (6) and a fileset
    image whose file is missing (8), both world-readable."""
    root = tmp_path_factory.mktemp("repo")
    omero = root / "OMERO"
    managed = omero / "ManagedRepository" / "demo_2" / "2026-07" / "31"
    managed.mkdir(parents=True)
    planes = np.random.default_rng(9).integers(
        0, 60000, (2, 1, 64, 96)).astype(np.uint16)
    write_ome_tiff(planes, str(managed / "img.ome.tiff"), tile=(32, 32),
                   n_levels=1)
    (managed / "a.fake").write_bytes(b"not pixel data")
    (omero / "Pixels").mkdir()
    romio = np.random.default_rng(10).integers(
        0, 60000, (2, 32, 48)).astype(np.uint16)
    (omero / "Pixels" / "53").write_bytes(romio.astype(">u2").tobytes())
    (omero / "ManagedRepository" / "lab").mkdir()
    write_jp2k_tiff(str(omero / "ManagedRepository" / "lab" / "slide.svs"),
                    smooth_rgb(100, 150), 33005, tile=64)
    (root / "data").mkdir()
    db = seeded_db()
    db.conn.executescript("""
        INSERT INTO image VALUES (6, 100, 12, 901);
        INSERT INTO image VALUES (8, 100, 12, 902);
        INSERT INTO fileset VALUES (901, 'lab/');
        INSERT INTO fileset VALUES (902, 'gone/');
        INSERT INTO filesetentry VALUES (3, 901, 802, 'slide.svs');
        INSERT INTO filesetentry VALUES (4, 902, 803, 'lost.ome.tiff');
        INSERT INTO originalfile VALUES (802, 'lab/', 'slide.svs',
                                         'image/tiff');
        INSERT INTO originalfile VALUES (803, 'gone/', 'lost.ome.tiff',
                                         'image/tiff');
        INSERT INTO pixels VALUES (54, 6, 150, 100, 1, 3, 1, 2);
        INSERT INTO pixels VALUES (55, 8, 64, 64, 1, 1, 1, 1);
    """)
    return {"omero.server": {"omero.data.dir": str(omero)},
            "data-dir": str(root / "data"),
            "session-store": {"type": "static"},
            "metadata-service": {"type": "postgres",
                                 "dsn": "postgresql://omero@h/omero"}}, db


RGB = "c=1|0:255$FF0000,2|0:255$00FF00,3|0:255$0000FF&m=c"
GREY = "c=1|0:60000$FF0000,2|0:60000$00FF00&m=c"
REQUESTS = [
    # (image, z, query, session cookie)
    (4, 0, f"tile=0,0,0,32,32&{GREY}&format=png", "sess-owner"),
    (4, 0, f"region=10,5,80,50&{GREY}&format=jpeg", "sess-outsider"),
    (4, 0, f"tile=0,2,1,32,32&{GREY}&format=png&flip=h", None),
    (5, 1, "region=8,4,24,16&c=1|0:60000$FFFFFF&m=g&format=png",
     "sess-owner"),
    (5, 0, "tile=0,0,0,48,32&c=1|0:60000$FF0000&m=c&format=jpeg",
     "sess-labmate"),
    (JP2K_IMAGE, 0, f"region=10,20,80,60&{RGB}&format=png", "sess-owner"),
    (JP2K_IMAGE, 0, f"tile=0,1,1,64,64&{RGB}&format=jpeg", None),
    (MISSING_IMAGE, 0, f"tile=0,0,0,32,32&{GREY}&format=png", "sess-owner"),
    (1, 0, f"tile=0,0,0,32,32&{GREY}&format=png", "sess-outsider"),
    (4, 0, f"tile=0,0,0,32,32&{GREY}&format=png", "sess-owner"),
]


def test_default_apps_serve_the_repository_alike(repo, monkeypatch):
    from aiohttp.test_utils import TestClient, TestServer

    raw, db = repo
    monkeypatch.setitem(sys.modules, "asyncpg", fake_asyncpg(db))

    async def through(app):
        out = []
        async with TestClient(TestServer(app)) as client:
            for image, z, query, session in REQUESTS:
                headers = ({"Cookie": f"sessionid={session}"}
                           if session else {})
                r = await client.get(
                    f"/webgateway/render_image_region/{image}/{z}/0?"
                    + query, headers=headers)
                out.append((r.status, await r.read(),
                            cache_headers(r.headers)))
        return out

    jax = asyncio.run(through(jax_app(JaxConfig.from_dict(dict(raw)))))
    port = asyncio.run(through(create_app(AppConfig.from_dict(dict(raw)),
                                          "cpu", db=db)))
    for request, want, got in zip(REQUESTS, jax, port):
        assert got == want, request
    assert [s for s, _, _ in port] == [200] * 7 + [404, 404, 200]
