"""The port's rolling drains and the fleet's seams against the JAX
package's.

* A drain decided alike: both packages' ``FleetRouter`` over the same
  recording members, a burst in flight on the drained member: the answer
  of ``drain_member`` (settled, planes, prestaged), where each render ran,
  the re-homed work, how the manifest is split between the successors,
  the pre-stage-back on undrain, the drain series and the decision
  ledger's records.
* A drain over real members (``build_local_members`` on the CPU, the
  direct renderer): after a warm grid, the drained member's planes are
  prestaged onto the same successors, and each member holds the same
  raw-cache keys in both packages.
* The fleet's seams: the shutdown chain's ``fleet-quiesce``, the pressure
  governor's queue source and replica shedding, and the prefetcher staging
  into the owning member's shard, each as in JAX.
"""

import asyncio
import os
import sys
import types

import pytest

from omero_ms_image_region_tpu.parallel import fleet as jax_fleet
from omero_ms_image_region_tpu.server import pressure as jax_pressure
from omero_ms_image_region_tpu.server import shutdown as jax_shutdown
from omero_ms_image_region_tpu.server.app import (
    FLEET_ROUTER_KEY, build_services as jax_build_services)
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.server.ctx import (
    ImageRegionCtx as JaxCtx)
from omero_ms_image_region_tpu.utils import decisions as jax_decisions
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.parallel import fleet
from omero_ms_image_region_tpu_torch.server import pressure, shutdown
from omero_ms_image_region_tpu_torch.server.app import (
    _front_key, build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.utils import decisions, telemetry

sys.path.insert(0, os.path.dirname(__file__))
import torch_workload_apps as wa  # noqa: E402

PACKAGES = {"jax": (jax_fleet, JaxCtx, jax_telemetry, jax_decisions),
            "port": (fleet, ImageRegionCtx, telemetry, decisions)}


@pytest.fixture(autouse=True)
def _fresh():
    for tel, dec in ((jax_telemetry, jax_decisions),
                     (telemetry, decisions)):
        tel.reset()
        dec.LEDGER.reset()
    yield
    jax_telemetry.reset()
    telemetry.reset()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return wa.write_tree(str(tmp_path_factory.mktemp("drain")))


def _tile_params(x, y, z=0, fmt="png", c=None):
    return {"imageId": str(wa.IMG), "theZ": str(z), "theT": "0",
            "tile": f"0,{x},{y},64,64", "format": fmt, "m": "c",
            "c": c or "1|0:60000$FF0000,2|0:60000$00FF00"}


# ------------------------------------------------- a drain, decided alike

def _recording(mod):
    """``mod.LocalMember`` that renders by yielding to the loop and
    records its manifest handoffs."""

    class Recording(mod.LocalMember):
        def __init__(self, name, log, manifest):
            super().__init__(name, self)
            self.log, self.manifest, self.prestaged = log, manifest, []

        async def render_image_region(self, ctx, adopt_cache=True,
                                      skip_byte_cache=False):
            self.log.append((self.name, ctx.label, adopt_cache))
            for _ in range(4):
                await asyncio.sleep(0)
            return self.name.encode()

        async def shard_manifest(self, limit=0):
            return self.manifest[:limit or None]

        async def prestage_manifest(self, entries):
            self.prestaged.append([e["route"] for e in entries])
            return len(entries)

    return Recording


def _drain_drill(pkg):
    mod, ctx_cls, tel, dec = PACKAGES[pkg]
    ctxs = []
    for i in range(12):
        ctx = ctx_cls.from_params(_tile_params(i % 4, i // 4))
        ctx.label = i
        ctxs.append(ctx)
    routes = [mod.plane_route_key(c) for c in ctxs]
    log: list = []
    Recording = _recording(mod)
    manifest = [{"key": [wa.IMG, 0, 0, 0, [64 * i, 0, 64, 64], [0, 1]],
                 "digest": None, "route": r} for i, r in enumerate(routes)]
    members = [Recording(f"m{i}", log, manifest if i == 1 else [])
               for i in range(3)]
    router = mod.FleetRouter(members, lane_width=1, steal_min_backlog=0)

    async def main():
        try:
            tasks = [asyncio.ensure_future(router.dispatch(c))
                     for c in ctxs]
            await asyncio.sleep(0)
            doc = await router.drain_member("m1", max_planes=8,
                                            settle_timeout_s=5.0)
            out = await asyncio.gather(*tasks)
            owners = [router.owner_of(c) for c in ctxs]
            router.undrain_member("m1")
            await router.last_undrain_prestage
            return doc, out, owners
        finally:
            await router.close()

    doc, out, owners = asyncio.run(main())
    marks = [sorted(k for k, v in getattr(c, "_provenance", {}).items()
                    if v is True) for c in ctxs]
    return {"doc": doc, "out": out, "owners": owners, "log": log,
            "marks": marks,
            "prestaged": {m.name: m.prestaged for m in members},
            "series": tel.DRAIN.metric_lines(),
            "ledger": [(r["kind"], r["verdict"], r.get("member"))
                       for r in dec.LEDGER.snapshot()]}


def test_a_drain_is_decided_as_in_jax():
    jax, port = _drain_drill("jax"), _drain_drill("port")
    assert port == jax
    assert port["doc"]["planes"] == 8 and port["doc"]["settled"]
    # The drained member's planes went to successors, and back on undrain.
    assert sum(len(batch) for name, calls in port["prestaged"].items()
               if name != "m1" for batch in calls) == 8
    assert [len(batch) for batch in port["prestaged"]["m1"]] == [8]
    assert ("drain", "done", "m1") in port["ledger"]


# ------------------------------------------------ a drain over real members

def _member_keys(router) -> dict:
    return {name: sorted(str(k) for k in member.services.raw_cache
                         ._entries)
            for name, member in router.members.items()}


def _real_fleet(pkg, data_dir):
    raw = {"data-dir": data_dir, "batcher": {"enabled": False},
           "raw-cache": {"prefetch": False},
           "renderer": {"cpu-fallback-max-px": 0}}
    mod, ctx_cls = PACKAGES[pkg][:2]
    if pkg == "jax":
        config = JaxConfig.from_dict(raw)
        services = jax_build_services(config)
    else:
        config = AppConfig.from_dict(raw)
        services = build_services(config, "cpu")
    members = mod.build_local_members(config, services, 3)
    router = mod.FleetRouter(members, lane_width=1, steal_min_backlog=0)
    handler = mod.FleetImageHandler(router, base_services=services)

    async def main():
        try:
            await asyncio.gather(*(
                handler.render_image_region(ctx_cls.from_params(
                    _tile_params(x, y))) for x in range(4)
                for y in range(4)))
            before = _member_keys(router)
            doc = await router.drain_member("m1")
            after = _member_keys(router)
            again = await handler.render_image_region(
                ctx_cls.from_params(_tile_params(3, 3, fmt="jpeg")))
            router.undrain_member("m1")
            return before, doc, after, len(again) > 0
        finally:
            await router.close()

    return asyncio.run(main())


def test_a_drain_hands_real_planes_to_the_same_successors(data_dir):
    jax = _real_fleet("jax", data_dir)
    port = _real_fleet("port", data_dir)
    assert port == jax
    before, doc, after, served = port
    assert doc["planes"] == len(before["m1"]) == doc["prestaged"] > 0
    # Each plane of m1 is now on a successor too; nothing else moved.
    moved = set(before["m1"])
    assert moved <= set(after["m0"]) | set(after["m2"])
    assert served


# ------------------------------------------------------------ the seams

def _router(mod, n=3, hot=False):
    members = [mod.LocalMember(f"m{i}", None) for i in range(n)]
    hotkey = (types.SimpleNamespace(enabled=True, threshold=1.0,
                                    decay_s=1e6, max_replicas=2, top_k=8,
                                    demote_fraction=0.5) if hot else None)
    return mod.FleetRouter(members, hotkey=hotkey)


def test_the_shutdown_chain_quiesces_the_fleet_as_in_jax():
    results = []
    for mod, chain_mod, cfg in ((jax_fleet, jax_shutdown, JaxConfig()),
                                (fleet, shutdown, AppConfig())):
        router = _router(mod)
        chain = chain_mod.build_shutdown_chain(cfg, None,
                                               fleet_router=router)
        ran = chain.run("SIGTERM")
        results.append((ran[:1], router.draining_members()))
    assert results[1] == results[0]
    assert results[1] == ([("fleet-quiesce", True)], ["m0", "m1", "m2"])
    assert telemetry.DRAIN.metric_lines() == \
        jax_telemetry.DRAIN.metric_lines()


def test_the_governor_reads_the_router_and_sheds_replicas_as_in_jax():
    seen = []
    for mod, ctx_cls, press, cfg in (
            (jax_fleet, JaxCtx, jax_pressure, JaxConfig().pressure),
            (fleet, ImageRegionCtx, pressure, AppConfig().pressure)):
        router = _router(mod, hot=True)
        router._observe_heat(mod.plane_route_key(ctx_cls.from_params(
            _tile_params(0, 0))))
        hot = router.hot_route_count()
        router._queues["m2"].append(_queued_work(mod, ctx_cls))
        queue = press.build_sources(router=router)["queue"]()
        actuators = press.build_actuators(cfg, router=router)
        actuators["evict_caches"].engage()
        seen.append((hot, queue, router.hot_route_count(),
                     sorted(actuators)))
    assert seen[1] == seen[0] == (1, 1.0, 0, ["evict_caches"])


def _queued_work(mod, ctx_cls):
    """A queued unit outside a loop (the depth source only counts it)."""
    work = mod._Work.__new__(mod._Work)
    work.bulk = False
    work.ctx = ctx_cls.from_params(_tile_params(1, 1))
    return work


def test_the_prefetcher_stages_into_the_owning_shard_as_in_jax(data_dir):
    """Both fleet apps serve the same tile GETs with the prefetcher on:
    every member's raw cache then holds the same keys, each predicted
    plane in the shard of the member that owns its route."""
    from aiohttp.test_utils import TestClient, TestServer

    raw = {"data-dir": data_dir, "fleet": {"enabled": True, "members": 2},
           "renderer": {"cpu-fallback-max-px": 0},
           "sentinel": {"tick-interval-s": 3600}}
    base = f"/webgateway/render_image_region/{wa.IMG}/0/0"

    async def run(app, router_of):
        async with TestClient(TestServer(app)) as client:
            for x, y in ((1, 1), (2, 1)):
                r = await client.get(
                    f"{base}?tile=0,{x},{y},64,64&{wa.CH}&format=png")
                assert r.status == 200
            router = router_of(app)
            prefetcher = router.members["m0"].services.prefetcher
            prefetcher.flush(timeout=30.0)
            return _member_keys(router)

    jax = asyncio.run(run(jax_app(JaxConfig.from_dict(dict(raw))),
                          lambda app: app[FLEET_ROUTER_KEY]))
    port = asyncio.run(run(create_app(AppConfig.from_dict(dict(raw)),
                                      "cpu"),
                           lambda app: app[_front_key()].router))
    assert port == jax
    assert sum(len(v) for v in port.values()) > 2   # predictions staged
