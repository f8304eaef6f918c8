"""The port's elastic autoscaler against the JAX package's.

* **The policy, tick for tick.**  Both packages' ``Autoscaler`` over stub
  routers on one virtual clock, through one seeded script of queue depths,
  pressure levels, predicted demand, replica pressure, member deaths and
  operator drains: each tick's verdict and ``status()`` document, the
  transitions, the ``imageregion_autoscaler_*`` lines, the ``autoscale.*``
  flight events and the ``kind=autoscaler`` decision records with their
  measured outcomes are equal.  The wide sweep of scripts is ``slow``.
* **The floor over the real router.**  JAX's property trajectories
  (concurrent ticks, deaths, operator drains) over each package's
  ``FleetRouter``: the same verdicts, and no scale-down below the floor.
* **The drill.**  JAX's elasticity drill on the port: three in-process
  members that render on the CPU and hold each render 50 ms (virtual
  device members), scaled down to the floor, grown back member by member
  by open-loop bursts of the port's load model, each joiner warm (its
  drained shard resident again, its owned tiles raw-cache hits), shrunk
  again; no error, no shed, transitions a cooldown apart.
* **The apps**, both built from one config dict: ``GET /admin/autoscaler``
  and ``/readyz``'s annotation, the 400 without an autoscaler, an
  autoscale drain that leaves ``drain.fail-readyz`` at 200 while an
  operator drain and the SIGTERM quiesce make it 503; a frontend with
  ``autoscaler.unit-config`` spawning its members' units at startup.
* **Sidecar units**: start and stop idempotent, a scale-down that stops
  the unit after its drain and a scale-up that restarts it before the
  undrain, a failed restart that parks the member for the next attempt;
  each in both packages, with the same tape.
"""

import asyncio
import os
import random
import tempfile
import types

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.parallel import fleet as jax_fleet
from omero_ms_image_region_tpu.server import autoscaler as jax_autoscaler
from omero_ms_image_region_tpu.server import sidecar as jax_sidecar
from omero_ms_image_region_tpu.server.app import (
    FLEET_ROUTER_KEY, create_app as jax_app)
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import decisions as jax_decisions
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.flagship import synthetic_wsi_tiles
from omero_ms_image_region_tpu_torch.parallel import fleet
from omero_ms_image_region_tpu_torch.server import autoscaler, sidecar
from omero_ms_image_region_tpu_torch.server.admission import (
    AdmissionController)
from omero_ms_image_region_tpu_torch.server.app import (
    _front_key, build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.server.singleflight import SingleFlight
from omero_ms_image_region_tpu_torch.services.loadmodel import (
    LoadModel, run_open_loop)
from omero_ms_image_region_tpu_torch.utils import decisions, telemetry

PACKAGES = {
    "jax": (jax_autoscaler, jax_fleet, JaxConfig, jax_telemetry,
            jax_decisions, jax_sidecar),
    "port": (autoscaler, fleet, AppConfig, telemetry, decisions, sidecar)}
GRID = 4
EDGE = 64


def _reset():
    for tel, dec in ((jax_telemetry, jax_decisions),
                     (telemetry, decisions)):
        tel.reset()
        dec.LEDGER.reset()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def data_dir():
    rng = np.random.default_rng(33)
    with tempfile.TemporaryDirectory() as tmp:
        planes = synthetic_wsi_tiles(rng, 2, 1, GRID * EDGE,
                                     GRID * EDGE).reshape(
            2, 1, GRID * EDGE, GRID * EDGE)
        build_pyramid(planes, os.path.join(tmp, "1"), n_levels=1)
        yield tmp


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Member:
    remote = False

    def __init__(self, name):
        self.name = name
        self.healthy = True
        self.draining = False
        self.drain_intent = None


class _Router:
    """Membership flags, a settable depth and replica pressure, and the
    drain surface the controller drives."""

    def __init__(self, n, lane_width=2, scale_factor=0.0):
        self.order = [f"m{i}" for i in range(n)]
        self.members = {name: _Member(name) for name in self.order}
        self.lane_width = lane_width
        self.hotkey = types.SimpleNamespace(scale_factor=scale_factor)
        self.depth = 0
        self.pressure = 0.0
        self.tape = []

    def queue_depth(self):
        return self.depth

    def replica_pressure(self):
        return self.pressure

    async def drain_member(self, name, intent="operator", **_kw):
        member = self.members[name]
        member.draining = True
        member.drain_intent = intent
        self.tape.append(("drain", name, intent))
        await asyncio.sleep(0)
        return {"member": name, "intent": intent}

    def undrain_member(self, name):
        member = self.members[name]
        member.draining = False
        member.drain_intent = None
        self.tape.append(("undrain", name))

    def draining_members(self, intent=None):
        return [n for n in self.order if self.members[n].draining
                and (intent is None
                     or self.members[n].drain_intent == intent)]


def _config(pkg, **overrides):
    loader = PACKAGES[pkg][2]
    raw = {"fleet": {"enabled": True, "members": 3},
           "autoscaler": {"enabled": True, "hold-ticks": 2,
                          "cooldown-s": 30, "queue-high-per-lane": 3,
                          "queue-low-per-lane": 0.5, **overrides}}
    return loader.from_dict(raw).autoscaler


def _script(seed, steps=150):
    """One seeded sequence of moves, the same for both packages."""
    rng = random.Random(seed)
    out = []
    for _ in range(steps):
        move = rng.random()
        if move < 0.12:
            out.append(("depth", rng.choice((0, 0, 1, 4, 12, 40))))
        elif move < 0.18:
            out.append(("level", rng.choice((0, 0, 1, 2))))
        elif move < 0.24:
            out.append(("demand", rng.choice((None, 5.0, 30.0, 90.0,
                                              "raise"))))
        elif move < 0.28:
            out.append(("pressure", rng.choice((0.0, 1.0, 3.5))))
        elif move < 0.32:
            out.append(("die", rng.randrange(4)))
        elif move < 0.36:
            out.append(("revive", rng.randrange(4)))
        elif move < 0.39:
            out.append(("operator", rng.randrange(4)))
        elif move < 0.42:
            out.append(("undrain", rng.randrange(4)))
        elif move < 0.6:
            out.append(("advance", rng.choice((1.0, 10.0, 31.0))))
        else:
            out.append(("tick", rng.random() < 0.5))
    return out


def _strip(events, prefixes):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events
            if e["kind"].startswith(prefixes)]


def _drive(pkg, script, **config):
    """Run ``script`` through ``pkg``'s Autoscaler; everything the two
    packages must agree on."""
    mod, _, _, tel, dec, _ = PACKAGES[pkg]
    tel.reset()
    dec.LEDGER.reset()
    clock = _Clock()
    router = _Router(4, scale_factor=2.0)
    gov = types.SimpleNamespace(level=0)
    demand = {"v": None}

    def demand_source():
        if demand["v"] == "raise":
            raise RuntimeError("demand feed down")
        return demand["v"]

    scaler = mod.Autoscaler(
        _config(pkg, floor=1, ceiling=4, **{"lane-capacity-tps": 10},
                **config),
        router, governor=gov, demand_source=demand_source, clock=clock)
    rows = []

    async def main():
        for op, arg in script:
            name = f"m{arg}" if isinstance(arg, int) else None
            if op == "depth":
                router.depth = arg
            elif op == "level":
                gov.level = arg
            elif op == "demand":
                demand["v"] = arg
            elif op == "pressure":
                router.pressure = arg
            elif op == "die":
                router.members[name].healthy = False
            elif op == "revive":
                router.members[name].healthy = True
            elif op == "operator" and not router.members[name].draining:
                await router.drain_member(name)
            elif op == "undrain" \
                    and router.members[name].drain_intent == "operator":
                router.undrain_member(name)
            elif op == "advance":
                clock.advance(arg)
            elif op == "tick":
                verdict = scaler.tick()
                if arg:                       # else the op stays in flight
                    await scaler.wait_op()
                rows.append((verdict, scaler.last_blocked,
                             scaler.status(), scaler.summary()))
        await scaler.wait_op()

    asyncio.run(main())
    return {"rows": rows, "transitions": scaler.transitions,
            "scaled_down": scaler._scaled_down, "tape": router.tape,
            "lines": tel.AUTOSCALER.metric_lines(),
            "flight": _strip(tel.FLIGHT.snapshot(),
                             ("autoscale.", "decision.autoscaler")),
            "ledger": [{k: v for k, v in r.items() if k != "ts"}
                       for r in dec.LEDGER.snapshot()
                       if r.get("kind") == "autoscaler"]}


def _assert_alike(seed, **config):
    script = _script(seed)
    jax = _drive("jax", script, **config)
    port = _drive("port", script, **config)
    for key in jax:
        assert port[key] == jax[key], (seed, key)
    return port


@pytest.mark.parametrize("seed", range(6))
def test_the_policy_decides_tick_for_tick_as_jax(seed):
    port = _assert_alike(seed)
    assert port["rows"]
    assert any(r[0] is not None for r in port["rows"])


@pytest.mark.parametrize("config", [
    {"hold-ticks": 1, "cooldown-s": 0},
    {"queue-high-per-lane": 1.0, "queue-low-per-lane": 0.0,
     "diurnal-period-s": 0},
])
def test_the_policy_under_other_settings_decides_as_jax(config):
    for seed in (11, 12):
        _assert_alike(seed, **config)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(6, 60))
def test_the_policy_decides_as_jax_over_many_scripts(seed):
    _assert_alike(seed)


def _fenced(pkg):
    """Install in ``pkg``'s federation a quorum tracker that has heard
    neither other host of a three-host manifest past its suspect window:
    a fenced minority.  Returns the federation module."""
    import importlib
    fed = importlib.import_module(
        "omero_ms_image_region_tpu.parallel.federation" if pkg == "jax"
        else "omero_ms_image_region_tpu_torch.parallel.federation")
    manifest = fed.FleetManifest([fed.MemberSpec(f"m{i}", f"h{i}")
                                  for i in range(3)])
    now = {"t": 0.0}
    tracker = fed.QuorumTracker(manifest, "h0", suspect_after_s=1.0,
                                clock=lambda: now["t"])
    now["t"] = 10.0
    fed.install_quorum(tracker)
    return fed


def test_the_sweep_reaches_every_verdict():
    """The seeds of the fast test exercise each verdict and blocked
    reason; ``quorum``, the federation's fence, on a fenced host, where
    both packages block every wanted transition alike."""
    seen = set()
    for seed in range(6):
        for row in _drive("port", _script(seed))["rows"]:
            seen.add(row[0])
    assert {"up", "down", None, "blocked:cooldown", "blocked:busy",
            "blocked:floor"} <= seen
    assert {"blocked:ceiling", "blocked:no-member"} & seen
    fenced = {}
    for pkg in ("jax", "port"):
        fed = _fenced(pkg)
        try:
            fenced[pkg] = _drive(pkg, _script(0))
            fenced[pkg]["refusals"] = fed.quorum_status()["refusals"]
        finally:
            fed.install_quorum(None)
    assert fenced["port"] == fenced["jax"]
    verdicts = {row[0] for row in fenced["port"]["rows"]}
    assert "blocked:quorum" in verdicts
    assert not {"up", "down"} & verdicts
    assert fenced["port"]["refusals"]["autoscaler"] >= 1


def test_the_replica_pressure_signal_as_jax():
    """The router's replica pressure grows the fleet past
    ``hotkey.scale-factor``, in both packages, over each package's real
    ``FleetRouter`` (its ``HeatTracker`` on a virtual clock)."""
    out = []
    for pkg in ("jax", "port"):
        mod, fl, _, tel, _, _ = PACKAGES[pkg]
        tel.reset()
        clock = _Clock()
        members = [fl.LocalMember(f"m{i}", None) for i in range(3)]
        hotkey = types.SimpleNamespace(
            enabled=True, threshold=2.0, decay_s=1e6, max_replicas=2,
            top_k=8, demote_fraction=0.5, scale_factor=2.0)
        router = fl.FleetRouter(members, hotkey=hotkey)
        router._heat.clock = clock
        route = "r-hot"
        for _ in range(3):
            router._observe_heat(route)
        pressure = [router.replica_pressure()]
        for _ in range(3):
            router._observe_heat(route)
        pressure.append(router.replica_pressure())
        members[2].draining = True
        members[2].drain_intent = "autoscale"
        scaler = mod.Autoscaler(_config(pkg, **{"hold-ticks": 1}), router,
                                clock=clock)
        scaler._scaled_down.append("m2")
        verdict = scaler.tick()
        out.append((pressure, verdict, scaler.signals()["replica_pressure"],
                    [line for line in tel.HOTKEY.metric_lines()
                     if "pressure" in line]))
    assert out[1] == out[0]
    assert out[0][0] == [1.5, 3.0] and out[0][1] == "up"


# ------------------------------------------------- the floor, real router

class _StubMember:
    remote = False

    def __init__(self, name):
        self.name = name
        self.healthy = True
        self.draining = False
        self.drain_intent = None

    def mark_down(self):
        self.healthy = False

    def revive(self):
        self.healthy = True

    def queue_depth(self):
        return 0

    def resident_digests(self):
        return set()

    def resident_planes(self):
        return 0

    async def shard_manifest(self, limit=0):
        return []

    async def prestage_manifest(self, entries):
        return 0


def _floor_trials(pkg):
    """JAX's floor-property trajectories over ``pkg``'s real router: every
    verdict, and the floor checked at every step."""
    mod, fl = PACKAGES[pkg][:2]

    class DepthRouter(fl.FleetRouter):
        depth_override = 0

        def queue_depth(self):
            return self.depth_override

    rng = random.Random(2026)
    verdicts = []

    async def trial():
        n = rng.choice((2, 3, 4, 5))
        floor = rng.randrange(1, n)
        router = DepthRouter([_StubMember(f"m{i}") for i in range(n)],
                             lane_width=2, steal_min_backlog=0)
        clock = _Clock()
        scaler = mod.Autoscaler(
            _config(pkg, floor=floor, **{"hold-ticks": 1,
                                         "cooldown-s": 0}),
            router, clock=clock,
            drain_kwargs={"prestage": False, "settle_timeout_s": 0.2})
        operator = set()
        try:
            for _ in range(80):
                move = rng.random()
                name = rng.choice(router.order)
                member = router.members[name]
                if move < 0.15:
                    member.mark_down()
                elif move < 0.30:
                    member.revive()
                elif move < 0.40 and not member.draining:
                    if [m for m in router.order
                            if router._routable(m) and m != name]:
                        await router.drain_member(
                            name, prestage=False, settle_timeout_s=0.2)
                        operator.add(name)
                elif move < 0.45 and name in operator:
                    router.undrain_member(name)
                    operator.discard(name)
                elif move < 0.55:
                    router.depth_override = rng.choice((0, 0, 200))
                else:
                    for _ in range(rng.randrange(1, 4)):
                        clock.advance(1)
                        verdict = scaler.tick()
                        verdicts.append(verdict)
                        if verdict == "down":
                            active = [m for m in router.order
                                      if not router.members[m].draining]
                            assert len(active) >= floor
                            assert len([m for m in active
                                        if router.members[m].healthy]) \
                                >= floor
                    await scaler.wait_op()
                if not operator:
                    assert len([m for m in router.order
                                if not router.members[m].draining]) >= floor
                for op_name in operator:
                    assert (router.members[op_name].drain_intent
                            != "autoscale"
                            or not router.members[op_name].draining)
        finally:
            await scaler.wait_op()
            await router.close()

    for _ in range(12):
        asyncio.run(trial())
    return verdicts


def test_the_floor_holds_over_the_real_router_as_in_jax():
    jax, port = _floor_trials("jax"), _floor_trials("port")
    assert port == jax
    assert port.count("down") > 5


# -------------------------------------------------------------- the drill

def _keys(member):
    """The raw-cache keys a member holds (its shard)."""
    return {repr(e["key"])
            for e in member.services.raw_cache.snapshot_entries()}


def test_the_elasticity_drill_on_the_port(data_dir):
    """JAX's acceptance drill on the port's fleet (virtual device members:
    CPU renders held 50 ms each): idle -> two autoscale drains to the
    floor -> the parked members' raw caches dropped -> open-loop bursts
    grow the fleet back, each joiner warm -> two drains again.  Zero 5xx
    and zero sheds; transitions a cooldown apart on the policy clock."""
    exec_ms = 50.0
    cooldown = 60.0

    class VirtualDeviceMember(fleet.LocalMember):
        async def render(self, ctx, adopt_cache=True):
            data = await super().render(ctx, adopt_cache)
            await asyncio.sleep(exec_ms / 1000.0)
            return data

    def ctx(x, y, w, session=None):
        c = ImageRegionCtx.from_params({
            "imageId": "1", "theZ": "0", "theT": "0",
            "tile": f"0,{x},{y},{EDGE},{EDGE}", "format": "png", "m": "c",
            "c": f"1|0:{w}$FF0000,2|0:{w - 700}$00FF00"})
        c.omero_session_key = session
        return c

    working = [ctx(x, y, 30000 + v * 800) for v in range(2)
               for x in range(GRID) for y in range(GRID)]
    model = LoadModel(viewers=48, seed=37, duration_s=60.0, grid=GRID,
                      diurnal_amplitude=0.0, bulk_fraction=0.0,
                      mask_fraction=0.0, zoom_fraction=0.0)
    natural = model.events()

    async def drill():
        config = AppConfig.from_dict({
            "data-dir": data_dir, "batcher": {"enabled": False},
            "raw-cache": {"enabled": True, "prefetch": False},
            "renderer": {"cpu-fallback-max-px": 0}})
        services = build_services(config, "cpu")
        members = [VirtualDeviceMember(
            m.name, m.handler, m.services,
            down_cooldown_s=m.down_cooldown_s,
            byte_cache_prechecked=m.byte_cache_prechecked)
            for m in fleet.build_local_members(config, services, 3)]
        router = fleet.FleetRouter(members, lane_width=2,
                                   steal_min_backlog=0)
        handler = fleet.FleetImageHandler(
            router, single_flight=SingleFlight(),
            admission=AdmissionController(4096, renderer=router),
            base_services=services)
        clock = _Clock()
        scaler = autoscaler.Autoscaler(
            _config("port", floor=1, **{
                "hold-ticks": 1, "cooldown-s": cooldown,
                "queue-high-per-lane": 2.0, "queue-low-per-lane": 0.25}),
            router, clock=clock,
            drain_kwargs={"prestage": True, "max_planes": 256,
                          "settle_timeout_s": 10.0})

        async def submit(arrival):
            sid = int(arrival.session.rsplit("-", 1)[1])
            w = 21000 + (sid * 131 + arrival.step * 37) % 18000
            assert await handler.render_image_region(
                ctx(arrival.x, arrival.y, w, arrival.session))

        reports, warm = [], {}
        try:
            await asyncio.gather(*(handler.render_image_region(c)
                                   for c in working))
            shard_at_drain = {}
            for expect in ("m2", "m1"):
                clock.advance(cooldown + 1)
                shard_at_drain[expect] = _keys(router.members[expect])
                assert scaler.tick() == "down"
                await scaler.wait_op()
                assert router.members[expect].drain_intent == "autoscale"
            clock.advance(cooldown + 1)
            assert scaler.tick() == "blocked:floor"
            assert scaler.active_members() == ["m0"]
            for name in ("m1", "m2"):         # a restart drops the shard
                router.members[name].services.raw_cache.clear()
            for expect in ("m1", "m2"):
                # JAX's offered rate (3x one member's nominal), over a
                # 1 s window (JAX's is 2 s) to keep the drill short.
                burst = model.window(3.0 * 2 * 1000.0 / exec_ms, 1.0,
                                     natural)
                burst_task = asyncio.create_task(run_open_loop(submit,
                                                               burst))
                grown = None
                for _ in range(400):
                    if router.queue_depth() >= 2 * 2 * 2:
                        clock.advance(cooldown + 1)
                        if scaler.tick() == "up":
                            grown = "up"
                            break
                    await asyncio.sleep(0.01)
                assert grown == "up", "burst never grew the fleet"
                assert not router.members[expect].draining
                reports.append(await burst_task)
                await router.last_undrain_prestage
                member = router.members[expect]
                assert shard_at_drain[expect] and shard_at_drain[
                    expect] <= _keys(member), f"{expect} rejoined cold"
                owned = [c for c in working if router.owner_of(c) == expect]
                hits0 = member.services.raw_cache.hits
                for c in owned:
                    await handler.render_image_region(c)
                warm[expect] = ((member.services.raw_cache.hits - hits0)
                                / max(1, len(owned)), len(owned))
            for _ in range(2):
                clock.advance(cooldown + 1)
                assert scaler.tick() == "down"
                await scaler.wait_op()
            assert scaler.active_members() == ["m0"]
        finally:
            await router.close()
            await services.renderer.close()
        return scaler, reports, warm

    scaler, reports, warm = asyncio.run(drill())
    for report in reports:
        assert report.errors == [] and report.sheds == 0
        assert report.served > 0
    for name, (rate, owned) in warm.items():
        assert owned and rate >= 0.8, (name, rate)
    assert [t["action"] for t in scaler.transitions] == [
        "down", "down", "up", "up", "down", "down"]
    times = [t["t"] for t in scaler.transitions]
    assert all(b - a >= cooldown for a, b in zip(times, times[1:]))
    assert telemetry.AUTOSCALER.transitions == {"down": 4, "up": 2}
    kinds = [e["kind"] for e in telemetry.FLIGHT.snapshot()]
    assert "autoscale.down" in kinds and "autoscale.up" in kinds
    lines = "\n".join(telemetry.LOADMODEL.metric_lines())
    assert 'imageregion_loadmodel_completed_total{class="interactive"}' \
        in lines


# ---------------------------------------------------------------- the apps

def _app_raw(data_dir, **autoscaler_overrides):
    return {"data-dir": data_dir, "batcher": {"enabled": False},
            "raw-cache": {"enabled": True, "prefetch": False},
            "renderer": {"cpu-fallback-max-px": 0},
            "sentinel": {"tick-interval-s": 3600},
            "fleet": {"enabled": True, "members": 2},
            "autoscaler": {"enabled": True, "interval-s": 30,
                           **autoscaler_overrides}}


def _both_apps(raw, scenario):
    """``scenario(client, router)`` through the JAX app and the port's,
    each built from ``raw``."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run(app, router_of):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await scenario(client, router_of(app))
        finally:
            await client.close()

    out = []
    for make, router_of in (
            (lambda: jax_app(JaxConfig.from_dict(raw)),
             lambda app: app[FLEET_ROUTER_KEY]),
            (lambda: create_app(AppConfig.from_dict(raw), "cpu"),
             lambda app: app[_front_key()].router)):
        _reset()
        out.append(asyncio.run(run(make(), router_of)))
    return out


def test_the_admin_status_and_readyz_annotation_as_jax(data_dir):
    async def scenario(client, router):
        r = await client.get("/admin/autoscaler")
        doc = await r.json()
        ready = await client.get("/readyz")
        return r.status, doc, ready.status, await ready.json()

    jax, port = _both_apps(_app_raw(data_dir), scenario)
    assert port == jax
    status, doc, ready, body = port
    assert status == 200 and doc["enabled"] is True
    assert doc["floor"] == 1 and doc["ceiling"] == 2
    assert doc["active"] == ["m0", "m1"] and doc["transitions"] == []
    assert "queue_per_lane" in doc["signals"]
    assert ready == 200
    assert body["checks"]["autoscaler"] == "2/2 active (floor 1)"


def test_without_an_autoscaler_the_status_is_jaxs_400(data_dir):
    raw = {"data-dir": data_dir, "sentinel": {"tick-interval-s": 3600},
           "fleet": {"enabled": True, "members": 2}}

    async def scenario(client, router):
        r = await client.get("/admin/autoscaler")
        return r.status, await r.read()

    jax, port = _both_apps(raw, scenario)
    assert port == jax and port[0] == 400


@pytest.mark.parametrize("intent, status", [("operator", 503),
                                            ("autoscale", 200)])
def test_an_autoscale_drain_never_trips_fail_readyz(data_dir, intent,
                                                    status):
    raw = _app_raw(data_dir)
    raw["drain"] = {"fail-readyz": True}

    async def scenario(client, router):
        await router.drain_member("m1", prestage=False,
                                  settle_timeout_s=2.0, intent=intent)
        r = await client.get("/readyz")
        body = await r.json()
        router.undrain_member("m1")
        after = (await client.get("/readyz")).status
        return r.status, body["checks"]["drain"], after

    jax, port = _both_apps(raw, scenario)
    assert port == jax
    assert port[0] == status and port[2] == 200
    assert port[1] == ("draining: m1(autoscale)" if intent == "autoscale"
                       else "draining: m1")


def test_the_sigterm_quiesce_still_trips_fail_readyz(data_dir):
    raw = _app_raw(data_dir)
    raw["drain"] = {"fail-readyz": True}

    async def scenario(client, router):
        for name in router.order:         # the quiesce: no intent
            router.members[name].draining = True
        r = await client.get("/readyz")
        return r.status, (await r.json())["checks"]

    jax, port = _both_apps(raw, scenario)
    assert port == jax and port[0] == 503


def test_a_frontend_spawns_its_units_at_startup(tmp_path, monkeypatch):
    """``autoscaler.unit-config`` in a ``fleet.sockets`` frontend: the
    startup hook starts one unit per member on its socket before the app
    serves, and cleanup stops them (the spawn stood in for here)."""
    from aiohttp.test_utils import TestClient, TestServer

    spawned = []

    def spawn(config_path, sock, extra_args=None):
        proc = _FakeProc()
        spawned.append((config_path, sock, proc))
        return proc

    monkeypatch.setattr(sidecar, "spawn_sidecar", spawn)
    socks = [str(tmp_path / "a.sock"), str(tmp_path / "b.sock")]
    raw = {"data-dir": str(tmp_path), "sidecar": {"role": "frontend"},
           "http-cache": {"epoch": "1"}, "watchdog": {"enabled": False},
           "sentinel": {"enabled": False},
           "fleet": {"enabled": True, "sockets": socks},
           "autoscaler": {"enabled": True, "interval-s": 30,
                          "unit-config": "/etc/sidecar.yaml"}}
    app = create_app(AppConfig.from_dict(raw), "cpu")
    front = app[_front_key()]

    async def main():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            started = [(c, s) for c, s, _ in spawned]
            alive = [front.unit_lifecycle.alive(n) for n in ("m0", "m1")]
            status = (await client.get("/admin/autoscaler")).status
        finally:
            await client.close()
        return started, alive, status

    started, alive, status = asyncio.run(main())
    assert sorted(started) == [("/etc/sidecar.yaml", s) for s in socks]
    assert alive == [True, True] and status == 200
    assert [p.terminated for _, _, p in spawned] == [1, 1]


# ------------------------------------------------------------ sidecar units

class _FakeProc:
    def __init__(self):
        self.alive = True
        self.terminated = 0
        self.pid = 4242

    def poll(self):
        return None if self.alive else 0

    def terminate(self):
        self.terminated += 1
        self.alive = False

    def wait(self, timeout=None):
        return 0

    def kill(self):
        self.alive = False


def _lifecycle(pkg, names, spawn_fn=None):
    sc = PACKAGES[pkg][5]
    spawned = []

    def default_spawn():
        proc = _FakeProc()
        spawned.append(proc)
        return proc

    return sc.SidecarUnitLifecycle(
        {n: sc.SidecarUnit(n, spawn_fn or default_spawn)
         for n in names}), spawned


def _units_idempotent(pkg):
    tel = PACKAGES[pkg][3]
    lc, spawned = _lifecycle(pkg, ["m0"])
    lc.start("m0")
    lc.start("m0")
    row = [len(spawned), lc.alive("m0")]
    lc.stop("m0")
    lc.stop("m0")
    row += [spawned[0].terminated, lc.alive("m0")]
    lc.start("m0")
    lc.stop("unknown")
    row += [len(spawned), lc.units["m0"].starts, lc.units["m0"].stops,
            [e["kind"] for e in _strip(tel.FLIGHT.snapshot(),
                                       ("autoscale.",))]]
    return row


def test_unit_start_and_stop_are_idempotent_as_in_jax():
    jax, port = _units_idempotent("jax"), _units_idempotent("port")
    assert port == jax
    assert port[:4] == [1, True, 1, False] and port[4] == 2


def _unit_drill(pkg):
    mod = PACKAGES[pkg][0]
    tel = PACKAGES[pkg][3]

    async def main():
        clock = _Clock()
        router = _Router(3)
        lc, _ = _lifecycle(pkg, router.order)
        lc.start_all()
        unit = lc.units["m2"]
        real_stop, real_start = unit.stop, unit.start
        unit.stop = lambda *a, **k: (router.tape.append(("stop", "m2")),
                                     real_stop(*a, **k))[1]
        unit.start = lambda: (router.tape.append(("start", "m2")),
                              real_start())[1]
        scaler = mod.Autoscaler(_config(pkg), router, lifecycle=lc,
                                clock=clock)
        verdicts = []
        for _ in range(2):
            verdicts.append(scaler.tick())
            await scaler.wait_op()
        alive_after_down = [lc.alive(n) for n in router.order]
        clock.advance(31)
        router.depth = 100
        for _ in range(2):
            verdicts.append(scaler.tick())
            await scaler.wait_op()
        return (verdicts, alive_after_down,
                [lc.alive(n) for n in router.order], router.tape,
                router.members["m2"].draining,
                [e["kind"] for e in _strip(tel.FLIGHT.snapshot(),
                                           ("autoscale.",))])

    return asyncio.run(main())


def test_scale_down_stops_the_unit_and_scale_up_restarts_it_first():
    jax, port = _unit_drill("jax"), _unit_drill("port")
    assert port == jax
    verdicts, after_down, after_up, tape, draining, kinds = port
    assert verdicts[1] == "down" and verdicts[3] == "up"
    assert after_down == [True, True, False]
    assert after_up == [True, True, True] and not draining
    assert tape == [("drain", "m2", "autoscale"), ("stop", "m2"),
                    ("start", "m2"), ("undrain", "m2")]
    assert "autoscale.unit-stop" in kinds and "autoscale.unit-start" in kinds


def _failed_respawn(pkg):
    mod = PACKAGES[pkg][0]
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("socket never appeared")
        return _FakeProc()

    async def main():
        clock = _Clock()
        router = _Router(2)
        lc, _ = _lifecycle(pkg, ["m1"], spawn_fn=flaky)
        scaler = mod.Autoscaler(_config(pkg, floor=1), router,
                                lifecycle=lc, clock=clock)
        rows = []

        async def ticks():
            for _ in range(2):
                verdict = scaler.tick()
                await scaler.wait_op()
            rows.append((verdict, router.members["m1"].draining,
                         list(scaler._scaled_down), lc.alive("m1")))
        await ticks()
        router.depth = 100
        for _ in range(3):
            clock.advance(31)
            await ticks()
        return rows

    return asyncio.run(main())


def test_a_failed_restart_parks_the_member_for_retry_as_in_jax():
    jax, port = _failed_respawn("jax"), _failed_respawn("port")
    assert port == jax
    assert port == [("down", True, ["m1"], False),
                    ("up", True, ["m1"], False),
                    ("up", True, ["m1"], False),
                    ("up", False, [], True)]
