"""The port's byte caches and the shared canRead memo against the JAX
package's.

* ``services.cache``: ``MemoryLRUCache``, the native LRU tier and
  ``CacheStack`` on the same operations as the JAX classes, a failing tier
  included (a failure reads as a miss, a hit back-fills the tiers above,
  a disabled stack touches nothing); ``Caches.from_config`` builds the
  same tiers.
* The cache keys (``ImageRegionCtx.pixels_metadata_cache_key``, the mask
  ctx's ``cache_key``) and the pixels-metadata value equal JAX's.
* Both default apps, from one config dict with the three caches on (and
  from ``conf/config.example.yaml``), answer a repeat GET from the cache
  (no render in the port's batcher, the same hit counts on both apps'
  ``/metrics``), a repeat mask GET, and another session's GET of a cached
  private image or mask with the same 404.
* Over the sqlite OMERO schema (``tests/torch_db_fixtures.py``) both
  handlers with the pixels-metadata cache ask the database the same
  statements on a repeat GET, and refuse the outsider a cached private
  image alike.
* With a stand-in ``redis.asyncio``, both apps write the same Redis keys
  and values (the byte tier and the canRead memo, its TTL included); a
  Redis that raises degrades to a miss in both, never a 500.
"""

import asyncio
import json
import os
import sys
import types

import numpy as np
import pytest
import yaml

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.models.pixels import Pixels as JaxPixels
from omero_ms_image_region_tpu.native import NativeLRUCache as JaxNative
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.server.ctx import (
    ImageRegionCtx as JaxCtx, ShapeMaskCtx as JaxMaskCtx)
from omero_ms_image_region_tpu.services import cache as jax_cache
from omero_ms_image_region_tpu_torch.models.pixels import Pixels
from omero_ms_image_region_tpu_torch.native import NativeLRUCache
from omero_ms_image_region_tpu_torch.server.app import (
    build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import (
    ImageRegionCtx, ShapeMaskCtx)
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.services import cache

from torch_db_fixtures import seeded_db
from torch_workload_apps import CH, IMG, exchange, write_tree

PRIVATE = 8
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "conf",
                       "config.example.yaml")
CACHES_ON = {"image-region-cache": {"enabled": True},
             "pixels-metadata-cache": {"enabled": True},
             "shape-mask-cache": {"enabled": True}}


def run(coro):
    return asyncio.run(coro)


class Flaky:
    """A tier that holds values and fails the operations named in
    ``broken``."""

    def __init__(self, broken=()):
        self.data = {}
        self.broken = set(broken)
        self.calls = []

    async def get(self, key):
        self.calls.append(("get", key))
        if "get" in self.broken:
            raise ConnectionError("tier down")
        return self.data.get(key)

    async def set(self, key, value):
        self.calls.append(("set", key))
        if "set" in self.broken:
            raise ConnectionError("tier down")
        self.data[key] = value


def _stack_script(mod, broken, enabled):
    """One script of operations on a stack of [LRU, Flaky, Flaky]; every
    observable result, in order."""
    upper = mod.MemoryLRUCache(64)
    middle, lower = Flaky(broken), Flaky()
    lower.data["deep"] = b"from-below"
    stack = mod.CacheStack([upper, middle, lower], enabled=enabled)

    async def script():
        out = []
        out.append(await stack.get_tiered("deep"))
        out.append(await stack.probe_tiered("deep"))
        out.append(await stack.get_tiered("missing"))
        await stack.set("k1", b"x" * 40)
        await stack.set("k2", b"y" * 40)           # evicts k1 upstairs
        out.append(await stack.get_tiered("k1"))
        out.append(await stack.get("k2"))
        out.append(await mod.get_with_tier(stack, "k2"))
        out.append(await mod.probe_with_tier(stack, "nothing"))
        out.append((upper.hits, upper.misses, upper.evictions,
                    upper.keys_by_recency()))
        out.append((sorted(middle.data), middle.calls, sorted(lower.data),
                    lower.calls))
        return out
    return run(script())


@pytest.mark.parametrize("broken, enabled", [
    ((), True), (("get",), True), (("set",), True),
    (("get", "set"), True), ((), False)])
def test_cache_stack_behaves_as_jax(broken, enabled):
    assert (_stack_script(cache, broken, enabled)
            == _stack_script(jax_cache, broken, enabled))


def test_native_lru_tier_behaves_as_jax():
    def script(cls):
        c = cls(max_bytes=16 * 100, shards=16)
        out = []

        async def go():
            for i in range(30):
                await c.set(f"key{i}", bytes([i]) * (50 + i))
            for i in (0, 3, 29, 31):
                out.append(await c.get(f"key{i}"))
            out.append((c.hits, c.misses, c.size_bytes))
        run(go())
        return out
    assert script(NativeLRUCache) == script(JaxNative)


def test_caches_from_config_build_the_jax_tiers(tmp_path):
    for cfg in ({}, {"image_region": True, "shape_mask": True},
                {"redis_uri": "redis://nowhere"},
                {"image_region": True, "disk_dir": str(tmp_path / "disk")}):
        mine = cache.Caches.from_config(cache.CacheConfig(**cfg))
        theirs = jax_cache.Caches.from_config(jax_cache.CacheConfig(**cfg))
        for name in ("image_region", "pixels_metadata", "shape_mask"):
            a, b = getattr(mine, name), getattr(theirs, name)
            assert a.enabled == b.enabled
            assert ([type(t).__name__ for t in a.tiers]
                    == [type(t).__name__ for t in b.tiers])
            # The disk tier's namespace and label (img:, meta:, mask:).
            assert ([(getattr(t, "prefix", None), cache.tier_label(t))
                     for t in a.tiers]
                    == [(getattr(t, "prefix", None), jax_cache.tier_label(t))
                        for t in b.tiers])
        assert mine.redis is theirs.redis is None   # no redis package
        assert (mine.disk is None) == (theirs.disk is None) == (
            "disk_dir" not in cfg)
    disabled = cache.Caches.disabled()
    assert not any(s.enabled for s in (disabled.image_region,
                                       disabled.pixels_metadata,
                                       disabled.shape_mask))


def test_cache_keys_and_values_match_jax():
    for image_id in (1, 7, 123456):
        assert (ImageRegionCtx.pixels_metadata_cache_key(image_id)
                == JaxCtx.pixels_metadata_cache_key(image_id))
    for params in ({"shapeId": "5"}, {"shapeId": "5", "color": "FF0000"},
                   {"shapeId": "9", "color": "00FF0080", "flip": "hv"}):
        assert (ShapeMaskCtx.from_params(params).cache_key()
                == JaxMaskCtx.from_params(params).cache_key())
    p = dict(image_id=7, pixels_type="uint16", size_x=300, size_y=200,
             size_z=4, size_c=2, size_t=3, dimension_order="XYCZT",
             pixels_id=70)
    assert Pixels(**p).to_json() == JaxPixels(**p).to_json()
    assert Pixels.from_json(JaxPixels(**p).to_json()) == Pixels(**p)


# ------------------------------------------------------ the default apps

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_tree(str(tmp_path_factory.mktemp("cache_apps")))
    planes = np.random.default_rng(12).integers(
        0, 60000, (2, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, os.path.join(root, str(PRIVATE)), n_levels=1)
    with open(os.path.join(root, str(PRIVATE), "acl.json"), "w") as f:
        json.dump({"sessions": ["someone"]}, f)
    return root


def _series(text: str, family: str) -> dict:
    return {line.split(" ")[0]: float(line.split(" ")[1])
            for line in text.splitlines() if line.startswith(family)}


def _requests():
    img = f"/webgateway/render_image_region/{IMG}/0/0/"
    prv = f"/webgateway/render_image_region/{PRIVATE}/0/0/"
    someone, other = ({"Cookie": "sessionid=someone"},
                      {"Cookie": "sessionid=other"})
    tile = f"?tile=0,0,0,256,256&{CH}&format=jpeg"
    small = "?tile=0,0,0,32,32&c=1|0:60000$FF0000&m=c&format=png"
    mask = "/webgateway/render_shape_mask"
    return [("GET", img + tile, {}), ("GET", img + tile, {}),
            ("GET", img + small, {}),
            ("GET", prv + small, someone), ("GET", prv + small, other),
            ("GET", prv + small, someone),
            ("GET", f"{mask}/1?color=FF0000", {}),
            ("GET", f"{mask}/1?color=FF0000", {}),
            # The mask key holds no flips (JAX's and the reference's).
            ("GET", f"{mask}/1?color=FF0000&flip=h", {}),
            ("GET", f"{mask}/5?color=00FF00", someone),
            ("GET", f"{mask}/5?color=00FF00", other),
            ("GET", f"{mask}/2", {}), ("GET", "/metrics", {})]


@pytest.mark.parametrize("source", ["dict", "example"])
def test_default_apps_answer_repeats_from_the_caches_alike(tree, source):
    if source == "example":
        with open(EXAMPLE) as f:
            raw = yaml.safe_load(f)
    else:
        raw = dict(CACHES_ON, **{"session-store": {"type": "static"}})
    raw["data-dir"] = tree
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(
        dict(raw)), "cpu"))
    jax, port = exchange(raw, _requests(), port_handler=handler)
    assert [a[0] for a in port] == [a[0] for a in jax] == [
        200, 200, 200, 200, 404, 200, 200, 200, 200, 200, 404, 200, 200]
    for (js, jh, jb), (ps, ph, pb) in list(zip(jax, port))[:-1]:
        assert pb == jb
        for k in ("ETag", "Cache-Control", "Vary", "Content-Type"):
            assert ph.get(k) == jh.get(k), k
    assert port[1][2] == port[0][2]
    assert port[7][2] == port[6][2] == port[8][2]
    # Renders: the three image tiles and the masks 1, 5 and 2 once each;
    # every repeat, and the refused session, came from the caches.
    assert handler.s.renderer.tiles_rendered == 6
    hits = _series(port[-1][2].decode(), "imageregion_cache_")
    assert hits == _series(jax[-1][2].decode(), "imageregion_cache_")
    assert hits[
        'imageregion_cache_hits{cache="image_region",tier="0"}'] == 3
    # Mask 1's two repeats, and mask 5's refused session twice: the
    # route's probe before the fairness token and the handler's.
    assert hits['imageregion_cache_hits{cache="shape_mask",tier="0"}'] == 4
    assert hits[
        'imageregion_cache_hits{cache="pixels_metadata",tier="0"}'] == 1


def test_handlers_on_the_database_with_caches_serve_alike(tmp_path):
    """The OMERO schema behind both handlers with all three caches on: the
    owner's private tile renders once, its repeat asks the database
    nothing in either package (memo and pixels-metadata cache), and the
    outsider gets a 404 from the cached bytes' ACL in both."""
    from omero_ms_image_region_tpu.io.service import (
        PixelsService as JaxPixelsService)
    from omero_ms_image_region_tpu.ops.lut import LutProvider as JaxLuts
    from omero_ms_image_region_tpu.server.handler import (
        ImageRegionHandler as JaxHandler, ImageRegionServices as JaxServices,
        NotFoundError as JaxNotFound, Renderer as JaxRenderer)
    from omero_ms_image_region_tpu.services import db_metadata as jax_db
    from omero_ms_image_region_tpu.services.metadata import (
        CanReadMemo as JaxMemo)
    from omero_ms_image_region_tpu_torch.io.service import PixelsService
    from omero_ms_image_region_tpu_torch.ops.lut import LutProvider
    from omero_ms_image_region_tpu_torch.server.errors import NotFoundError
    from omero_ms_image_region_tpu_torch.server.handler import (
        ImageRegionServices, Renderer)
    from omero_ms_image_region_tpu_torch.services import db_metadata

    planes = np.random.default_rng(3).integers(
        0, 60000, (4, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(tmp_path / "1"), n_levels=1)
    db = seeded_db()
    jax = JaxHandler(JaxServices(
        pixels_service=JaxPixelsService(str(tmp_path)),
        metadata=jax_db.DbMetadataService(db),
        caches=jax_cache.Caches.from_config(
            jax_cache.CacheConfig.enabled_all()),
        can_read_memo=JaxMemo(), renderer=JaxRenderer(),
        lut_provider=JaxLuts()))
    port = ImageRegionHandler(ImageRegionServices(
        pixels_service=PixelsService(str(tmp_path)),
        metadata=db_metadata.DbMetadataService(db), renderer=Renderer("cpu"),
        lut_provider=LutProvider(),
        caches=cache.Caches.from_config(cache.CacheConfig.enabled_all())))
    params = {"imageId": "1", "theZ": "0", "theT": "0",
              "tile": "0,0,0,32,32", "m": "c", "c": "1|0:60000$FF0000"}

    def get(handler, ctx_cls, session, p=params):
        before = db.statements
        body = run(handler.render_image_region(
            ctx_cls.from_params(dict(p), session)))
        return body, db.statements - before

    counts = []
    for handler, ctx_cls, missing in ((jax, JaxCtx, JaxNotFound),
                                      (port, ImageRegionCtx, NotFoundError)):
        first, n_first = get(handler, ctx_cls, "sess-owner")
        second, n_second = get(handler, ctx_cls, "sess-owner")
        # Another region: the image-region cache misses, the pixels come
        # from their cache and the ACL from the memo.
        third, n_third = get(handler, ctx_cls, "sess-owner",
                             dict(params, tile="0,1,1,32,32"))
        before = db.statements
        with pytest.raises(missing):
            run(handler.render_image_region(ctx_cls.from_params(
                dict(params), "sess-outsider")))
        counts.append((first, second, third, n_first, n_second, n_third,
                       db.statements - before))
    assert counts[0] == counts[1]
    first, second, third, n_first, n_second, n_third, n_out = counts[1]
    assert first == second != third and first[:2] == b"\xff\xd8"
    assert n_first > 0 and n_second == n_third == 0 and n_out > 0


def _fake_redis(store: dict, ttls: dict, fail: bool):
    """A stand-in ``redis`` package: ``redis.asyncio.from_url`` gives a
    client over ``store`` (``ttls`` records each ``px``), raising on every
    call when ``fail``."""
    class Client:
        def _check(self):
            if fail:
                raise ConnectionError("redis down")

        async def get(self, key):
            self._check()
            return store.get(key)

        async def set(self, key, value, px=None):
            self._check()
            store[key] = bytes(value)
            if px is not None:
                ttls[key] = px

        async def exists(self, key):
            self._check()
            return int(key in store)

        async def aclose(self):
            pass

    aio = types.ModuleType("redis.asyncio")
    aio.from_url = lambda uri, **kw: Client()
    pkg = types.ModuleType("redis")
    pkg.asyncio = aio
    return pkg, aio


@pytest.mark.parametrize("fail", [False, True])
def test_default_apps_share_the_same_redis_entries(tree, monkeypatch, fail):
    raw = dict(CACHES_ON, **{"session-store": {"type": "static"},
                             "redis-cache": {"uri": "redis://cache:6379/1"},
                             "data-dir": tree})
    img = f"/webgateway/render_image_region/{IMG}/0/0/"
    requests = [("GET", f"{img}?tile=0,0,0,256,256&{CH}&format=jpeg", {}),
                ("GET", f"{img}?tile=0,0,0,256,256&{CH}&format=jpeg",
                 {"Cookie": "sessionid=someone"}),
                ("GET", "/webgateway/render_shape_mask/3?color=0000FF", {})]
    stores = []

    def answers(build_app):
        store, ttls = {}, {}
        pkg, aio = _fake_redis(store, ttls, fail)
        monkeypatch.setitem(sys.modules, "redis", pkg)
        monkeypatch.setitem(sys.modules, "redis.asyncio", aio)
        out = _serve(build_app(), requests)
        stores.append((store, ttls))
        return out

    jax = answers(lambda: jax_app(JaxConfig.from_dict(dict(raw))))
    port = answers(lambda: create_app(
        AppConfig.from_dict(dict(raw)), "cpu", handler=ImageRegionHandler(
            build_services(AppConfig.from_dict(dict(raw)), "cpu"))))
    assert [a[0] for a in port] == [a[0] for a in jax] == [200, 200, 200]
    assert [a[2] for a in port] == [a[2] for a in jax]
    (jax_store, jax_ttls), (port_store, port_ttls) = stores
    assert port_store == jax_store and port_ttls == jax_ttls
    if fail:
        assert port_store == {}
    else:
        assert any(k.startswith("canRead:someone:Image:") for k in port_store)
        assert any(k.startswith("ome.model.core.Pixels:") for k in port_store)
        assert set(port_ttls) == {k for k in port_store
                                  if k.startswith("canRead:")}


def _serve(app, requests):
    """Each ``(method, url, headers)`` through ``app``: (status, headers,
    body) each."""
    from aiohttp.test_utils import TestClient, TestServer

    async def go():
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, url, headers in requests:
                r = await client.request(method, url, headers=headers)
                out.append((r.status, r.headers, await r.read()))
        return out
    return run(go())
