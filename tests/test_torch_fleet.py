"""The port's fleet (``parallel.fleet``) against the JAX package's.

* The ring: the JAX golden assignments and chains, and equal owners and
  chains for every key over members, virtual nodes and seeds (a wider
  sweep is marked ``slow``); ``plane_route_key`` is ``server.ctx``'s one
  definition and equal to JAX's for the same request.
* The routers: both packages' ``FleetRouter`` over the same stub members
  and the same scripted requests, on a virtual clock (each fleet module's
  ``time`` replaced by one whose ``monotonic`` the test moves; the stubs
  yield to the loop a fixed number of times, no sleeps): the member each
  render lands on, steals and their ``adopt_cache=False``, a member's death
  mid-burst, its cooldown and re-admission, ``failover: false``, ``close``
  and the hot-key promote, demote and repromote sequence.
* Both default apps from one config dict with ``fleet: {enabled: true,
  members: 2}`` over ``tests/torch_workload_apps.py``'s tree: the same
  statuses, bytes and serving member (the provenance header), the same
  fleet and drain series, ``/admin/*`` answers and ``/readyz``.
* A port sidecar in the test's event loop driven by the JAX
  ``RemoteMember`` through every fleet op (a render with and without
  adoption, ``byte_probe``, ``byte_fetch``, ``byte_put``,
  ``shard_manifest``, ``prestage``, ``shard_transfer``, ``explain``), the
  answers held to a JAX sidecar's, and the ``hello``'s member name.
* A shard manifest JAX's raw cache writes, prestaged by a port member,
  and the reverse.
"""

import asyncio
import os
import sys
import types

import numpy as np
import pytest

from omero_ms_image_region_tpu.parallel import fleet as jax_fleet
from omero_ms_image_region_tpu.server.app import (
    build_services as jax_build_services)
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.server.ctx import (
    ImageRegionCtx as JaxCtx)
from omero_ms_image_region_tpu.server.sidecar import (
    SidecarClient as JaxClient)
from omero_ms_image_region_tpu.server.sidecar import (
    run_sidecar as jax_run_sidecar)
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.parallel import fleet
from omero_ms_image_region_tpu_torch.server import ctx as port_ctx
from omero_ms_image_region_tpu_torch.server import sidecar
from omero_ms_image_region_tpu_torch.server.app import (build_services,
                                                        create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.utils import telemetry

sys.path.insert(0, os.path.dirname(__file__))
import torch_workload_apps as wa  # noqa: E402

PACKAGES = {"jax": (jax_fleet, JaxCtx, jax_telemetry),
            "port": (fleet, ImageRegionCtx, telemetry)}


@pytest.fixture(autouse=True)
def _fresh():
    jax_telemetry.reset()
    telemetry.reset()
    yield
    jax_telemetry.reset()
    telemetry.reset()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return wa.write_tree(str(tmp_path_factory.mktemp("fleet")))


def _params(tile="0,0,0,128,128", **extra):
    params = {"imageId": "1", "theZ": "0", "theT": "0", "m": "c"}
    if tile is not None:
        params["tile"] = tile
    params.update(extra)
    return params


# ------------------------------------------------------------ the ring

GOLDEN = {"plane-000": "m3", "plane-001": "m0", "plane-002": "m2",
          "plane-003": "m0", "plane-004": "m2", "plane-005": "m2",
          "plane-006": "m3", "plane-007": "m3", "plane-008": "m0",
          "plane-009": "m0", "plane-010": "m1", "plane-011": "m1"}


def test_the_ring_gives_the_jax_goldens():
    ring = fleet.HashRing(["m0", "m1", "m2", "m3"], replicas=64)
    assert {k: ring.member(k) for k in GOLDEN} == GOLDEN
    assert ring.chain("plane-000") == ["m3", "m2", "m0", "m1"]
    with pytest.raises(ValueError):
        fleet.HashRing([])
    with pytest.raises(ValueError):
        fleet.HashRing(["m0", "m0"])


@pytest.mark.parametrize("n, replicas, seed", [
    (4, 64, ""), (3, 16, "fed-a"),
    pytest.param(2, 1, "", marks=pytest.mark.slow),
    pytest.param(5, 128, "", marks=pytest.mark.slow),
    pytest.param(8, 64, "rack-2", marks=pytest.mark.slow),
    pytest.param(16, 8, "x", marks=pytest.mark.slow),
])
def test_owners_and_chains_equal_jax(n, replicas, seed):
    members = [f"m{i}" for i in range(n)]
    mine = fleet.HashRing(members, replicas=replicas, seed=seed)
    theirs = jax_fleet.HashRing(members, replicas=replicas, seed=seed)
    keys = [f"k{i}" for i in range(300)] + [
        port_ctx.plane_route_key(ImageRegionCtx.from_params(
            _params(tile=f"0,{x},{y},256,256"))) for x in range(6)
        for y in range(6)]
    assert [mine.chain(k) for k in keys] == [theirs.chain(k)
                                             for k in keys]


def test_plane_route_key_is_the_ctx_one_and_jax_equal():
    assert fleet.plane_route_key is port_ctx.plane_route_key
    cases = [_params(), _params(tile="0,1,0,128,128"), _params(theZ="3"),
             _params(c="1|1000:30000$00FF00"), _params(format="png"),
             _params(tile=None, region="0,0,64,32"),
             _params(tile="1,2,3,256,256", imageId="9")]
    for params in cases:
        assert (fleet.plane_route_key(ImageRegionCtx.from_params(params))
                == jax_fleet.plane_route_key(JaxCtx.from_params(params)))
    assert fleet.plane_route_key(ImageRegionCtx.from_params(_params())) \
        == "673758f592968bbaa5606b21d12bff3b"


# -------------------------------------------------------- the routers

class _Clock:
    """A module ``time`` whose monotonic clock the test moves."""

    def __init__(self):
        import time as real
        self.now = 1000.0
        self.perf_counter = real.perf_counter
        self.time = real.time

    def monotonic(self) -> float:
        return self.now


class _Stub:
    """A member handler: records (request, adopt_cache), yields to the loop
    ``yields`` times, dies with a ConnectionError from its
    ``die_after``-th call while ``dead``."""

    def __init__(self, name, log, yields=3, die_after=None):
        self.name, self.log, self.yields = name, log, yields
        self.die_after, self.calls = die_after, 0

    async def render_image_region(self, ctx, adopt_cache=True,
                                  skip_byte_cache=False):
        self.calls += 1
        if self.die_after is not None and self.calls > self.die_after:
            raise ConnectionError(f"{self.name} killed")
        self.log.append((self.name, ctx.label, adopt_cache))
        for _ in range(self.yields):
            await asyncio.sleep(0)
        return self.name.encode()


def _drive(pkg, script, monkeypatch, n=4, die=None, **router_kw):
    """Run ``script(router, make_ctx, clock)`` over ``pkg``'s router with
    ``n`` stub members (``die``: {member: die_after}); returns the script's
    result, the render log and the fleet and hot-key totals."""
    mod, ctx_cls, tel = PACKAGES[pkg]
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    log: list = []
    members = [mod.LocalMember(f"m{i}", _Stub(
        f"m{i}", log, die_after=(die or {}).get(f"m{i}")),
        down_cooldown_s=5.0) for i in range(n)]
    router = mod.FleetRouter(members, **router_kw)
    if router._heat is not None:
        router._heat.clock = clock.monotonic

    def make_ctx(label, **params):
        ctx = ctx_cls.from_params(_params(**params))
        ctx.label = label
        return ctx

    async def main():
        try:
            return await script(router, make_ctx, clock)
        finally:
            await router.close()

    out = asyncio.run(main())
    monkeypatch.undo()
    return out, log, tel.FLEET.totals(), tel.HOTKEY.totals()


def _both(script, monkeypatch, **kw):
    jax = _drive("jax", script, monkeypatch, **kw)
    port = _drive("port", script, monkeypatch, **kw)
    assert port == jax
    return port


async def _gather(router, ctxs):
    out = await asyncio.gather(*(router.dispatch(c) for c in ctxs),
                               return_exceptions=True)
    return [o if isinstance(o, bytes) else type(o).__name__ for o in out]


def test_routes_and_pins_match_jax(monkeypatch):
    async def script(router, make_ctx, clock):
        ctxs = [make_ctx(f"t{x}{y}", tile=f"0,{x},{y},128,128")
                for x in range(3) for y in range(3)]
        ctxs.append(make_ctx("rewindow", c="1|5:999$00FF00"))
        ctxs.append(make_ctx("full", tile=None))
        ctxs.append(make_ctx("proj", tile=None, p="intmax|0:3"))
        return (await _gather(router, ctxs),
                [router.owner_of(c) for c in ctxs])

    (out, owners), log, totals, _ = _both(
        script, monkeypatch, lane_width=1, steal_min_backlog=0)
    assert owners[0] == owners[9] == "m3"      # the re-window's owner
    assert owners[-2:] == ["m0", "m0"]         # pinned to member 0
    assert totals["routed"] == 12 and totals["stolen"] == 0


def test_steals_match_jax_and_never_adopt(monkeypatch):
    async def script(router, make_ctx, clock):
        return await _gather(router, [
            make_ctx(i, c=f"1|{i}:60000$FF0000") for i in range(12)])

    out, log, totals, _ = _both(script, monkeypatch, lane_width=1,
                                steal_min_backlog=2)
    stolen = [entry for entry in log if entry[0] != "m3"]
    assert stolen and all(adopt is False for _, _, adopt in stolen)
    assert all(adopt for name, _, adopt in log if name == "m3")
    assert totals["stolen"] == len(stolen)


def test_a_death_mid_burst_fails_over_with_no_failure(monkeypatch):
    async def script(router, make_ctx, clock):
        ctxs = [make_ctx(i, c=f"1|{i}:60000$FF0000") for i in range(10)]
        out = await _gather(router, ctxs)
        down = router.healthy_members()
        owner_while_down = router.owner_of(ctxs[0])
        # The cooldown ends: the owner is back at the next call.
        clock.now += 6.0
        back = router.owner_of(ctxs[0])
        return out, down, owner_while_down, back

    (out, down, while_down, back), log, totals, _ = _both(
        script, monkeypatch, lane_width=1, steal_min_backlog=0,
        die={"m3": 2})
    assert all(o == b"m0" or o == b"m3" for o in out)
    assert "m3" not in down and while_down == "m0" and back == "m3"
    assert totals["failed_over"] >= 1


def test_failover_off_fails_the_shard(monkeypatch):
    async def script(router, make_ctx, clock):
        ctxs = [make_ctx(i, c=f"1|{i}:60000$FF0000") for i in range(6)]
        out = await _gather(router, ctxs)
        return out, router.owner_of(ctxs[0])

    (out, owner), log, totals, _ = _both(
        script, monkeypatch, lane_width=1, steal_min_backlog=0,
        failover=False, die={"m3": 1})
    assert out.count(b"m3") == 1 and "ConnectionError" in out
    assert owner == "m3" and totals["failed_over"] == 0


def test_close_fails_pending_work_alike(monkeypatch):
    async def script(router, make_ctx, clock):
        tasks = [asyncio.ensure_future(router.dispatch(
            make_ctx(i, c=f"1|{i}:60000$FF0000"))) for i in range(6)]
        for _ in range(4):
            await asyncio.sleep(0)
        await router.close()
        out = await asyncio.gather(*tasks, return_exceptions=True)
        return [o if isinstance(o, bytes) else type(o).__name__
                for o in out]

    out, log, _, _ = _both(script, monkeypatch, n=2, lane_width=1)
    assert "RuntimeError" in out


def test_hot_keys_promote_demote_and_repromote_alike(monkeypatch):
    hotkey = types.SimpleNamespace(enabled=True, threshold=3.0,
                                   decay_s=10.0, max_replicas=2, top_k=16,
                                   demote_fraction=0.5)

    async def script(router, make_ctx, clock):
        hot = [make_ctx(f"h{i}", c=f"1|{i}:60000$FF0000") for i in range(8)]
        route = fleet.plane_route_key(hot[0])
        phases = [await _gather(router, hot[:4]),
                  router.replica_set(route), router.is_hot_route(route)]
        clock.now += 60.0       # the heat decays below the band
        phases += [await _gather(router, [make_ctx("cold", theZ="1")]),
                   router.is_hot_route(route)]
        phases += [await _gather(router, hot[4:]),
                   router.is_hot_route(route), router.replica_set(route)]
        return phases

    phases, log, totals, hot = _both(script, monkeypatch, lane_width=1,
                                     steal_min_backlog=0, hotkey=hotkey)
    assert len(phases[1]) == 2 and phases[1][0] == "m3" and phases[2]
    assert phases[4] is False and phases[6] is True
    assert hot["promoted"] == 2 and hot["demoted"] == 1
    assert hot["balanced"] >= 1 and hot["duplicate_staged"] == 0


# ------------------------------------------------------ the default apps

BASE = f"/webgateway/render_image_region/{wa.IMG}/0/0"


def _tile(x, y, fmt="jpeg"):
    return f"{BASE}?tile=0,{x},{y},64,64&{wa.CH}&format={fmt}"


def _exchange(raw: dict, requests):
    """Each (method, url) through both default apps built from ``raw``
    (the port's on the CPU, its fleet built by ``create_app``)."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run(app):
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, url in requests:
                r = await client.request(method, url)
                out.append((r.status, r.headers.copy(), await r.read()))
        return out

    jax_telemetry.reset()
    telemetry.reset()
    jax = asyncio.run(run(jax_app(JaxConfig.from_dict(dict(raw)))))
    port = asyncio.run(run(create_app(AppConfig.from_dict(dict(raw)),
                                      "cpu")))
    return jax, port


def _member(headers) -> str:
    for part in headers.get("X-Image-Region-Provenance", "").split("; "):
        if part.startswith("member="):
            return part[len("member="):]
    return "-"


def _fleet_series(text: bytes) -> dict:
    """The fleet, hot-key and drain series but the prestaged planes' total
    (an undrain's pre-stage-back lands in the background, after its
    answer)."""
    return {line.rsplit(" ", 1)[0]: line.rsplit(" ", 1)[1]
            for line in text.decode().splitlines()
            if line.startswith(("imageregion_fleet_", "imageregion_drain",
                                "imageregion_hotkey_"))
            and not line.startswith(
                "imageregion_drain_prestaged_planes_total")}


def test_both_fleet_apps_serve_route_and_drain_alike(data_dir):
    raw = {"data-dir": data_dir, "fleet": {"enabled": True, "members": 2},
           "renderer": {"cpu-fallback-max-px": 0},
           "raw-cache": {"prefetch": False},
           "telemetry": {"provenance-header": True},
           "image-region-cache": {"enabled": True},
           "sentinel": {"tick-interval-s": 3600}}
    requests = [("GET", _tile(x, y)) for x in range(2) for y in range(2)]
    requests += [("GET", _tile(0, 0, "png")), ("GET", _tile(1, 1)),
                 ("GET", "/admin/drain"), ("POST", "/admin/drain?member=m1"),
                 ("POST", "/admin/drain?member=m0"),
                 ("POST", "/admin/drain?member=zz"),
                 ("GET", _tile(1, 0, "png")), ("GET", "/readyz"),
                 ("POST", "/admin/undrain?member=m1"),
                 ("POST", "/admin/undrain"),
                 ("GET", "/admin/autoscaler"), ("GET", "/admin/federation"),
                 ("GET", "/readyz"), ("GET", "/metrics")]
    jax, port = _exchange(raw, requests)
    for (method, url), (js, jh, jb), (ps, ph, pb) in zip(requests, jax,
                                                         port):
        assert ps == js, url
        if url == "/metrics":
            assert _fleet_series(pb) == _fleet_series(jb)
            continue
        assert pb == jb, url
        assert _member(ph) == _member(jh), url
    members = {_member(h) for _, h, _ in port[:4]}
    assert members == {"m0", "m1"}            # both members served
    assert port[8][0] == 409 and port[9][0] == 400
    assert b'"drain": "draining: m1"' in port[11][2]


def test_fail_readyz_and_apps_without_a_fleet(data_dir):
    raw = {"data-dir": data_dir, "fleet": {"enabled": True, "members": 3},
           "drain": {"fail-readyz": True},
           "sentinel": {"tick-interval-s": 3600}}
    requests = [("GET", "/readyz"), ("POST", "/admin/drain?member=m2"),
                ("GET", "/readyz"), ("POST", "/admin/undrain?member=m2"),
                ("GET", "/readyz")]
    jax, port = _exchange(raw, requests)
    assert [s for s, _, _ in port] == [s for s, _, _ in jax] \
        == [200, 200, 503, 200, 200]
    plain = {"data-dir": data_dir, "sentinel": {"tick-interval-s": 3600}}
    requests = [("GET", "/admin/drain"), ("POST", "/admin/drain?member=m0"),
                ("POST", "/admin/undrain?member=m0")]
    jax, port = _exchange(plain, requests)
    assert [(s, b) for s, _, b in port] == [(s, b) for s, _, b in jax]
    assert {s for s, _, _ in port} == {400}


# ------------------------------------------------- sidecars and manifests

def _sidecar_raw(data_dir) -> dict:
    return {"data-dir": data_dir, "watchdog": {"enabled": False},
            "sentinel": {"enabled": False},
            "image-region-cache": {"enabled": True},
            "renderer": {"cpu-fallback-max-px": 0},
            "raw-cache": {"prefetch": False, "digest-dedup": True}}


async def _serving(run, sock):
    holder: dict = {}
    task = asyncio.create_task(run(holder))
    for _ in range(400):
        if task.done():
            raise AssertionError(f"sidecar died: {task.exception()!r}")
        if os.path.exists(sock):
            break
        await asyncio.sleep(0.05)
    return task, holder


async def _fleet_ops(sock, services, port_member=False):
    """Every fleet op through the JAX RemoteMember (``port_member``: the
    port's, with the port's client), as plain data."""
    member = (fleet.RemoteMember("m1", sidecar.SidecarClient(sock))
              if port_member
              else jax_fleet.RemoteMember("m1", JaxClient(sock)))
    try:
        params = {"imageId": str(wa.IMG), "theZ": "0", "theT": "0",
                  "tile": "0,1,0,64,64", "format": "png",
                  "c": "1|0:60000$FF0000,2|0:60000$00FF00", "m": "c"}
        owned = JaxCtx.from_params(params)
        stolen = JaxCtx.from_params(dict(params, tile="0,0,1,64,64"))
        raw = services.raw_cache
        body = await member.render(owned)
        planes = len(raw)
        stolen_body = await member.render(stolen, adopt_cache=False)
        after_steal = len(raw)
        probe = await member.byte_probe([owned.cache_key, "nope"])
        fetched = await member.byte_fetch(owned.cache_key,
                                          image_id=wa.IMG, session=None)
        missing = await member.byte_fetch("nope")
        put = await member.byte_put("peer-key", b"peer-bytes")
        put_probe = await member.byte_probe(["peer-key"])
        manifest = await member.shard_manifest(0)
        prestaged = await member.prestage_manifest(manifest)
        plane = np.arange(2 * 8 * 8, dtype=np.uint16).reshape(2, 8, 8)
        entry = {"key": [wa.IMG, 3, 0, 0, [0, 0, 8, 8], [0, 1]],
                 "digest": None, "route": "r-transfer",
                 "dtype": "uint16", "shape": [2, 8, 8],
                 "bytes": plane.tobytes()}
        transferred = await member.shard_transfer([entry])
        explained = await member.explain_residency(
            owned.cache_key, jax_fleet.plane_route_key(owned))
        manifest_after = await member.shard_manifest(0)
        return {"body": body, "planes": planes, "stolen": stolen_body,
                "after_steal": after_steal, "probe": probe,
                "fetched": fetched == body, "missing": missing, "put": put,
                "put_probe": put_probe, "manifest": manifest,
                "prestaged": prestaged, "transferred": transferred,
                "explained": sorted(explained),
                "manifest_after": sorted(
                    (tuple(e["key"][:4]), e.get("route"))
                    for e in manifest_after)}
    finally:
        await member.client.close()


def test_a_port_sidecar_answers_the_jax_remote_member_as_jax(
        data_dir, tmp_path):
    async def against(run, sock, port_member=False):
        task, holder = await _serving(run, sock)
        try:
            return await _fleet_ops(sock, holder["services"], port_member)
        finally:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    raw = _sidecar_raw(data_dir)
    jsock, psock = str(tmp_path / "j.sock"), str(tmp_path / "p.sock")
    jax = asyncio.run(against(lambda h: jax_run_sidecar(
        JaxConfig.from_dict(dict(raw)), jsock, services_out=h), jsock))
    telemetry.FLIGHT.set_member(None)
    port = asyncio.run(against(lambda h: sidecar.run_sidecar(
        AppConfig.from_dict(dict(raw)), psock, services_out=h,
        device="cpu"), psock))
    assert port == jax
    assert port["after_steal"] == port["planes"] == 1   # a steal adopts
    # The port's RemoteMember gets the same answers from a port sidecar.
    psock2 = str(tmp_path / "p2.sock")
    mine = asyncio.run(against(lambda h: sidecar.run_sidecar(
        AppConfig.from_dict(dict(raw)), psock2, services_out=h,
        device="cpu"), psock2, port_member=True))
    assert mine == port
    assert port["probe"] == [True, False] and port["fetched"]
    assert port["put_probe"] == [True] and port["transferred"] == 1
    # The hello named this process's member.
    assert telemetry.FLIGHT.member == "m1"


def _services(pkg, data_dir):
    raw = dict(_sidecar_raw(data_dir), **{"raw-cache": {"prefetch": False}})
    if pkg == "jax":
        return jax_build_services(JaxConfig.from_dict(raw))
    return build_services(AppConfig.from_dict(raw), "cpu")


def test_shard_manifests_cross_between_the_packages(data_dir):
    """A manifest of JAX's raw cache prestages into a port member, and a
    port member's into a JAX one, with the same keys and routes."""
    from omero_ms_image_region_tpu.server.handler import (
        ImageRegionHandler as JaxHandler)
    from omero_ms_image_region_tpu_torch.server.handler import (
        ImageRegionHandler)

    async def warm(handler, ctx_cls):
        for x in range(2):
            await handler.render_image_region(ctx_cls.from_params({
                "imageId": str(wa.IMG), "theZ": "1", "theT": "0",
                "tile": f"0,{x},1,64,64", "format": "png", "m": "c",
                "c": "1|0:60000$FF0000,2|0:60000$00FF00"}))

    def keyed(entries):
        return sorted((tuple(e["key"][:4]), tuple(e["key"][4]),
                       tuple(e["key"][5]), e.get("route"))
                      for e in entries)

    async def main():
        js, ps = _services("jax", data_dir), _services("port", data_dir)
        jm = jax_fleet.LocalMember("m0", JaxHandler(js), services=js)
        pm = fleet.LocalMember("m0", ImageRegionHandler(ps), services=ps)
        await warm(jm.handler, JaxCtx)
        jax_manifest = await jm.shard_manifest()
        assert await pm.prestage_manifest(jax_manifest) == 2
        port_manifest = await pm.shard_manifest()
        js2 = _services("jax", data_dir)
        jm2 = jax_fleet.LocalMember("m1", JaxHandler(js2), services=js2)
        assert await jm2.prestage_manifest(port_manifest) == 2
        return jax_manifest, port_manifest, await jm2.shard_manifest()

    jax_manifest, port_manifest, back = asyncio.run(main())
    assert keyed(port_manifest) == keyed(jax_manifest) == keyed(back)
    assert all(e.get("route") for e in port_manifest)
