"""The port's pressure governor and brownout ladder against the JAX
package's.

Both governors are driven by one controllable ``queue`` signal over the
JAX test's trajectories (``tests/test_pressure.py``: seeded random walks
over the three levels, a sustained critical and its release, elevated
holds, hysteresis between the watermarks): the engaged ladder prefix, the
level, the prefetch budget, the ``/readyz`` summary and the
``imageregion_pressure_*`` lines are equal tick by tick.  The loaders
accept and refuse the same ``pressure`` blocks.  The port's actuators act
on its own objects (the prefetcher's and warm-state's pause, the raw
cache's and disk tier's eviction, the batcher's lane cap, under which one
lane takes groups), and the pyramid job parks under ``shed_bulk``.

Both default apps, built from one config dict with ``pressure.enabled``
and the ladder driven to ``critical``: an interactive tile's JPEG is
byte-identical to the JAX app's under ``drop_quality`` (tolerance 0),
equal to an uncapped request at quality 60, and carries ``no-store`` and
no ETag; a ``p=`` projection answers 503 with the same ``Retry-After``;
the admission bound is scaled alike; the provenance header names the
ladder and the ``quality_capped`` flag.
"""

import asyncio
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server import jobs as jax_jobs
from omero_ms_image_region_tpu.server import pressure as jax_pressure
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.io.devicecache import DeviceRawCache
from omero_ms_image_region_tpu_torch.server import jobs, pressure
from omero_ms_image_region_tpu_torch.server.app import (
    build_services, create_app)
from omero_ms_image_region_tpu_torch.server.batcher import (
    BatchingRenderer)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.utils import telemetry

IMG = 7
C = "1|0:60000$FF0000,2|0:60000$00FF00"
BASE = f"/webgateway/render_image_region/{IMG}/0/0"
# Levels through the classifier (high 48: ok < low 16, elevated >= 48,
# critical >= 48 x 1.25).
LEVEL_VALUES = {0: 0.0, 1: 48.0, 2: 60.0}


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (jax_telemetry, telemetry):
        mod.reset()
    jax_pressure.uninstall()
    pressure.uninstall()
    yield
    jax_pressure.uninstall()
    pressure.uninstall()
    for mod in (jax_telemetry, telemetry):
        mod.reset()


def _governor(pkg, cfg_cls, raw, value, actuators=None):
    config = cfg_cls.from_dict({"pressure": dict(raw, enabled=True)}) \
        .pressure
    return pkg.PressureGovernor(config, actuators or {},
                                {"queue": lambda: value["queue"]})


def _trajectory(levels, raw=None):
    """Each package's (engaged, level, budget, summary) per tick, and its
    last pressure lines."""
    out = []
    for pkg, cfg, tel in ((jax_pressure, JaxConfig, jax_telemetry),
                          (pressure, AppConfig, telemetry)):
        tel.reset()
        value = {"queue": 0.0}
        gov = _governor(pkg, cfg, raw or {}, value)
        trail = []
        for level in levels:
            value["queue"] = LEVEL_VALUES[level] if level in LEVEL_VALUES \
                else level
            gov.tick()
            trail.append((tuple(gov.engaged_steps()), gov.level,
                          gov.prefetch_budget(), gov.summary(),
                          gov.quality_cap(), gov.admission_scale(),
                          gov.bulk_shed_active()))
        out.append((trail, tel.PRESSURE.metric_lines(),
                    tel.PREFETCH.budget_scale))
    return out


@pytest.mark.parametrize("seed", [1234, 4321, 7])
def test_random_trajectories_match_jax(seed):
    rng = random.Random(seed)
    levels = [rng.choice((0, 0, 1, 1, 2)) for _ in range(240)]
    jax, port = _trajectory(levels)
    assert port == jax
    ladder = AppConfig().pressure.ladder
    for engaged, *_ in port[0]:
        assert engaged == ladder[:len(engaged)]
        if "tighten_admission" in engaged:
            assert "shed_bulk" in engaged


@pytest.mark.parametrize("levels, raw", [
    ([2] * 9 + [0] * 25, {}),                         # walk and release
    ([1] * 5 + [2] * 3 + [0] * 12, {"step-hold-ticks": 3}),
    ([48.0, 30.0, 10.0, 48.0, 47.0, 15.0, 16.0], {}),   # hysteresis
    ([2] * 4 + [0] * 10, {"ladder": ["cap_lanes", "drop_quality",
                                     "shed_bulk"],
                          "release-hold-ticks": 2}),
])
def test_fixed_trajectories_match_jax(levels, raw):
    jax, port = _trajectory(levels, raw)
    assert port == jax


@pytest.mark.parametrize("block", [
    {"ladder": ["tighten_admission", "shed_bulk"]},
    {"ladder": ["pause_prefetch", "pause_prefetch"]},
    {"ladder": ["nap"]},
    {"hbm-high": 0.5, "hbm-low": 0.6},
    {"critical-factor": 0.9}, {"quality-cap": 0}, {"evict-to-frac": 1.0},
    {"lane-cap": 0}, {"admission-scale": 0.0}, {"interval-s": 0},
    {"prefetch-budget-elevated": 0.2, "prefetch-budget-critical": 0.6},
    {"enabled": True, "hbm-high": 0.5, "hbm-low": 0.25, "lane-cap": 2,
     "ladder": ["evict_caches", "cap_lanes", "drop_quality"]},
])
def test_the_loader_accepts_and_refuses_as_jax(block):
    def load(cls):
        try:
            return cls.from_dict({"pressure": block}).pressure.__dict__
        except ValueError as e:
            return str(e).split(" ")[0]
    assert load(AppConfig) == load(JaxConfig)


def test_the_actuators_act_on_the_port_objects(tmp_path):
    raw_cache = DeviceRawCache(4000, device="cpu")
    for i in range(4):
        raw_cache.get_or_load(("k", i), lambda: np.zeros(900, np.uint8))
    disk = SimpleNamespace(fracs=[], max_bytes=1, size_bytes=0,
                           evict_to_fraction=lambda f: disk.fracs.append(f))
    services = SimpleNamespace(
        prefetcher=SimpleNamespace(paused=False),
        warmstate=SimpleNamespace(paused=False), raw_cache=raw_cache,
        caches=SimpleNamespace(disk=disk),
        renderer=BatchingRenderer("cpu"))
    config = AppConfig.from_dict({"pressure": {
        "enabled": True, "evict-to-frac": 0.5,
        "ladder": ["pause_prefetch", "pause_snapshots", "evict_caches",
                   "cap_lanes"]}}).pressure
    act = pressure.build_actuators(config, services=services)
    assert sorted(act) == ["cap_lanes", "evict_caches", "pause_prefetch",
                           "pause_snapshots"]
    value = {"queue": 60.0}
    gov = pressure.PressureGovernor(config, act,
                                    {"queue": lambda: value["queue"]})
    for _ in range(4):
        gov.tick()
    assert services.prefetcher.paused and services.warmstate.paused
    assert raw_cache.size_bytes <= 2000 and disk.fracs[0] == 0.5
    assert services.renderer._lane_cap == 1
    assert telemetry.FLIGHT.snapshot()[0]["kind"] == "pressure.level"
    assert any(e["kind"] == "rawcache.pressure-evict"
               for e in telemetry.FLIGHT.snapshot())
    value["queue"] = 0.0
    for _ in range(4 * config.release_hold_ticks):
        gov.tick()
    assert gov.engaged_steps() == []
    assert not services.prefetcher.paused and not services.warmstate.paused
    assert services.renderer._lane_cap == 0
    sources = pressure.build_sources(services=services)
    assert sources["hbm"]() == raw_cache.size_bytes / 4000
    assert sources["queue"]() == 0.0 and sources["host_rss_mb"]() > 0


def test_a_capped_batcher_runs_one_group_at_a_time():
    """Under ``set_lane_cap(1)`` two lanes take one group at a time;
    lifting the cap lets the second lane take groups again."""
    renderer = BatchingRenderer("cpu", device_lanes=2)
    inside, peak, lock = [0], [0], threading.Lock()

    def hold():
        with renderer._lane():
            with lock:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            time.sleep(0.05)
            with lock:
                inside[0] -= 1

    for cap, want in ((1, 1), (0, 2)):
        renderer.set_lane_cap(cap)
        peak[0] = 0
        threads = [threading.Thread(target=hold) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert peak[0] == want


def test_the_pyramid_job_parks_under_shed_bulk(tmp_path):
    states = []
    for pkg, mgr_mod, cfg in ((jax_pressure, jax_jobs, JaxConfig),
                              (pressure, jobs, AppConfig)):
        value = {"queue": 60.0}
        gov = _governor(pkg, cfg, {"ladder": ["shed_bulk"]}, value)
        gov.tick()
        pkg.install(gov)
        manager = mgr_mod.PyramidJobManager(defer_poll_s=0.01)
        job = mgr_mod.PyramidJob(job_id="pj-1", source=str(tmp_path),
                                 dest=str(tmp_path / "p"))

        async def run():
            task = asyncio.create_task(manager._wait_pressure(job))
            await asyncio.sleep(0.05)
            parked = (job.state, task.done())
            pkg.uninstall()
            await asyncio.wait_for(task, 1.0)
            return parked, job.state
        states.append(asyncio.run(run()))
    assert states[0] == states[1] == (("deferred", False), "running")
    assert telemetry.FLIGHT.snapshot()[-1]["kind"] == "pyramid.deferred"


# -------------------------------------------------------------- apps

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pressure")
    planes = np.random.default_rng(21).integers(
        0, 60000, size=(2, 2, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


def _critical(gov):
    gov.sources = {"queue": lambda: 1e9}
    while gov.engaged < len(gov.ladder):
        gov.tick()


async def _under_pressure(app, active):
    from aiohttp.test_utils import TestClient, TestServer

    tile = {"tile": "0,0,0,64,48", "c": C, "m": "c", "format": "jpeg"}
    async with TestClient(TestServer(app)) as client:
        _critical(active())
        out = {}
        for name, query in (("capped", tile),
                            ("q60", dict(tile, q="0.6")),
                            ("bulk", {"p": "intmax|0:1", "c": C,
                                      "format": "png"})):
            r = await client.get(BASE, params=query)
            out[name] = (r.status, dict(r.headers), await r.read())
        r = await client.get("/readyz")
        out["readyz"] = await r.json()
        from urllib.parse import quote
        r = await client.get("/debug/explain?path=" + quote(
            f"{BASE}?tile=0,0,0,64,48"))
        out["explain"] = await r.json()
    return out


def test_drop_quality_and_shed_bulk_match_jax(data_dir):
    raw = {"data-dir": data_dir, "renderer": {"cpu-fallback-max-px": 0},
           "watchdog": {"enabled": False}, "raw-cache": {"prefetch": False},
           "telemetry": {"provenance-header": True},
           "pressure": {"enabled": True, "interval-s": 60,
                        "ladder": ["drop_quality", "shed_bulk",
                                   "tighten_admission"]}}
    jax = asyncio.run(_under_pressure(
        jax_app(JaxConfig.from_dict(dict(raw))), jax_pressure.active))
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(
        dict(raw)), "cpu"))
    port = asyncio.run(_under_pressure(create_app(
        AppConfig.from_dict(dict(raw)), "cpu", handler=handler),
        pressure.active))

    (js, jh, jb), (ps, ph, pb) = jax["capped"], port["capped"]
    assert ps == js == 200 and pb == jb and pb[:2] == b"\xff\xd8"
    assert port["q60"][2] == pb and jax["q60"][2] == jb
    for h in (jh, ph):
        assert h["Cache-Control"] == "no-store"
        assert "ETag" not in h and "Vary" not in h
    prov = ph["X-Image-Region-Provenance"]
    assert "ladder=drop_quality,shed_bulk,tighten_admission" in prov
    assert "flags=quality_capped" in prov
    strip = lambda v: "; ".join(p for p in v.split("; ")    # noqa: E731
                                if not p.startswith(("trace=", "member=")))
    assert strip(prov) == strip(jh["X-Image-Region-Provenance"])

    (js, jh, jb), (ps, ph, pb) = jax["bulk"], port["bulk"]
    assert ps == js == 503 and ph["Retry-After"] == jh["Retry-After"] == "5"
    assert pb == jb
    assert port["readyz"] == jax["readyz"]
    assert port["readyz"]["checks"]["pressure"] == (
        "critical; steps=drop_quality,shed_bulk,tighten_admission")
    adm = [d["explain"]["admission"] for d in (jax, port)]
    for a in adm:
        a.pop("estimated_wait_ms")
    assert adm[1] == adm[0] and adm[1]["effective_max_queue"] == 128
    assert port["explain"]["pressure"] == jax["explain"]["pressure"]
    assert telemetry.RESILIENCE.shed == {"pressure-bulk": 1}
