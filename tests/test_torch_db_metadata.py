"""The port's OMERO-database metadata service and canRead memo against the
JAX package's.

Both ``DbMetadataService`` run the same PostgreSQL statements over
``tests/torch_db_fixtures.py``'s sqlite copy of the JAX tests' seed (the
permission longs -120, -56 and -52 reach ``can_read`` as they are).  Over
every session (owner, labmate, outsider, admin, a closed session, none)
and every object (private, group-read and public images, the fileset and
pre-FS images, a missing one; two masks and a missing one), ``can_read``,
``get_pixels_description``, ``get_mask`` and ``resolve_image_paths`` give
the JAX answers; so do the ROMIO path fan-out and the ``CanReadMemo``'s
TTL, put, get and shared-tier behaviour.  The handlers on the database
backend (as the JAX ``TestHandlerIntegration`` builds them) give the same
bytes and the same 404, and issue the same statements: a repeat request
inside the memo's TTL asks no ACL question of the database beyond the one
inside ``get_pixels_description``.
"""

import asyncio

import numpy as np
import pytest

from omero_ms_image_region_tpu.services import db_metadata as jax_db
from omero_ms_image_region_tpu.services.metadata import (
    CanReadMemo as JaxMemo)
from omero_ms_image_region_tpu_torch.services import db_metadata as db_mod
from omero_ms_image_region_tpu_torch.services.metadata import CanReadMemo

from torch_db_fixtures import SESSIONS, seeded_db


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module")
def services():
    db = seeded_db()
    return jax_db.DbMetadataService(db), db_mod.DbMetadataService(db)


CALLERS = (*SESSIONS, "sess-closed", None)
IMAGES = (1, 2, 3, 4, 5, 999)
MASKS = (70, 71, 999)


def test_permission_bits_are_the_jax_bits():
    assert (db_mod.USER_READ, db_mod.GROUP_READ, db_mod.WORLD_READ) == (
        jax_db.USER_READ, jax_db.GROUP_READ, jax_db.WORLD_READ)


@pytest.mark.parametrize("session", CALLERS)
def test_answers_equal_jax(services, session):
    jax, port = services

    def pixels(px):
        return None if px is None else (
            px.image_id, px.pixels_type, px.size_x, px.size_y, px.size_z,
            px.size_c, px.size_t)

    def mask(m):
        return None if m is None else (m.shape_id, m.width, m.height,
                                       m.bytes_, m.fill_color)

    async def answers(svc):
        out = []
        for image in IMAGES:
            out.append(await svc.can_read("Image", image, session))
            out.append(pixels(await svc.get_pixels_description(image,
                                                               session)))
        for shape in MASKS:
            out.append(await svc.can_read("Mask", shape, session))
            out.append(mask(await svc.get_mask(shape, session)))
        return out

    want = run(answers(jax))
    assert run(answers(port)) == want
    # The matrix reaches both answers: readable and not.
    assert True in want and False in want


def test_repository_paths_equal_jax(services):
    jax, port = services
    for image in IMAGES:
        assert (run(port.resolve_image_paths(image))
                == run(jax.resolve_image_paths(image)))
    assert run(port.resolve_image_paths(4)) == [
        "ManagedRepository/demo_2/2026-07/31/a.fake",
        "ManagedRepository/demo_2/2026-07/31/img.ome.tiff"]
    assert run(port.resolve_image_paths(5)) == ["Pixels/53"]
    for pixels_id in (0, 53, 999, 1000, 1234, 999999, 1234567,
                      1000000000):
        assert (db_mod._romio_rel_path(pixels_id)
                == jax_db._romio_rel_path(pixels_id))


class _Shared:
    """A shared tier: an async dict (``get`` / ``set``)."""

    def __init__(self):
        self.data = {}

    async def get(self, key):
        return self.data.get(key)

    async def set(self, key, value):
        self.data[key] = value


def test_can_read_memo_behaves_as_jax():
    def script(memo_cls):
        out = []
        memo = memo_cls(ttl_seconds=1000)
        out.append(memo.get("s", "Image", 1))
        memo.put("s", "Image", 1, True)
        memo.put(None, "Mask", 2, False)
        out += [memo.get("s", "Image", 1), memo.get(None, "Mask", 2),
                memo.get("t", "Image", 1)]
        expired = memo_cls(ttl_seconds=-1)
        expired.put("s", "Image", 1, True)
        out.append(expired.get("s", "Image", 1))
        shared = _Shared()
        a = memo_cls(ttl_seconds=1000, shared=shared)
        b = memo_cls(ttl_seconds=1000, shared=shared)
        run(a.put_async("s", "Image", 9, False))
        out += [run(b.get_async("s", "Image", 9)), b.get("s", "Image", 9),
                sorted(shared.data.items())]
        lone = memo_cls(ttl_seconds=1000)
        out.append(run(lone.get_async("s", "Image", 9)))
        return out

    assert script(CanReadMemo) == script(JaxMemo)


def test_handlers_on_the_database_serve_alike(tmp_path):
    """One image in a data directory, its ACL and pixels in the database:
    the labmate's tile is the same JPEG from both handlers, the outsider's
    the same 404; a repeat asks the database the same statements in both,
    and no more than a cold ``get_pixels_description``."""
    from omero_ms_image_region_tpu.io.service import (
        PixelsService as JaxPixels)
    from omero_ms_image_region_tpu.io.store import build_pyramid
    from omero_ms_image_region_tpu.ops.lut import LutProvider as JaxLuts
    from omero_ms_image_region_tpu.server.ctx import (
        ImageRegionCtx as JaxCtx)
    from omero_ms_image_region_tpu.server.handler import (
        ImageRegionHandler as JaxHandler, ImageRegionServices as JaxServices,
        NotFoundError as JaxNotFound, Renderer as JaxRenderer)
    from omero_ms_image_region_tpu.services.cache import CacheConfig, Caches
    from omero_ms_image_region_tpu_torch.io.service import PixelsService
    from omero_ms_image_region_tpu_torch.ops.lut import LutProvider
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
    from omero_ms_image_region_tpu_torch.server.errors import NotFoundError
    from omero_ms_image_region_tpu_torch.server.handler import (
        ImageRegionHandler, ImageRegionServices, Renderer)

    planes = np.random.default_rng(3).integers(
        0, 60000, (3, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(tmp_path / "2"), n_levels=1)
    db = seeded_db()
    jax = JaxHandler(JaxServices(
        pixels_service=JaxPixels(str(tmp_path)),
        metadata=jax_db.DbMetadataService(db),
        caches=Caches.from_config(CacheConfig()), can_read_memo=JaxMemo(),
        renderer=JaxRenderer(), lut_provider=JaxLuts()))
    port = ImageRegionHandler(ImageRegionServices(
        pixels_service=PixelsService(str(tmp_path)),
        metadata=db_mod.DbMetadataService(db), renderer=Renderer("cpu"),
        lut_provider=LutProvider()))
    params = {"imageId": "2", "theZ": "0", "theT": "0",
              "tile": "0,0,0,32,32", "m": "c", "c": "1|0:60000$FF0000"}

    def statements(handler, ctx_cls, session):
        before = db.statements
        body = run(handler.render_image_region(
            ctx_cls.from_params(dict(params), session)))
        return body, db.statements - before

    cold = run(db_mod.DbMetadataService(db).get_pixels_description(
        2, "sess-labmate"))
    assert cold is not None
    before = db.statements
    run(db_mod.DbMetadataService(db).get_pixels_description(
        2, "sess-labmate"))
    pixels_statements = db.statements - before
    counts = []
    for handler, ctx_cls in ((jax, JaxCtx), (port, ImageRegionCtx)):
        first, n_first = statements(handler, ctx_cls, "sess-labmate")
        second, n_second = statements(handler, ctx_cls, "sess-labmate")
        assert first == second and first[:2] == b"\xff\xd8"
        counts.append((first, n_first, n_second))
    assert counts[0] == counts[1]
    assert counts[1][2] == pixels_statements < counts[1][1]
    with pytest.raises(JaxNotFound):
        run(jax.render_image_region(JaxCtx.from_params(
            dict(params), "sess-outsider")))
    with pytest.raises(NotFoundError):
        run(port.render_image_region(ImageRegionCtx.from_params(
            dict(params), "sess-outsider")))
