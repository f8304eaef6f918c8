"""The port's perf sentinel against the JAX package's.

The same observation stream, made from a seed with numpy, goes through the
JAX ``SentinelEngine`` and the port's on one virtual clock, with stub
capture callables for the flight ring, costs and exemplars: the tick
summaries and verdicts are equal tick by tick (warm-up, a step to a slower
latency, the confirmed drift with its one incident bundle and decision
record, a still-drifting tick, a quiet window, the recovery), and so are
the ``imageregion_sentinel_*`` lines, the learned baselines' export and
load and the closed vocabularies.  The port's bundle profile goes through
``telemetry.capture_profile`` (``torch.profiler``; a Chrome trace), its
tick runs on a worker thread, and the warm-state manifest carries the
baselines across a restart.  The port's sentinel built at the repo root
reads no record: its watermarks are ``{}``, where the JAX loader finds the
repo's TPU and CPU marks.
"""

import asyncio
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from omero_ms_image_region_tpu.server import sentinel as jax_sentinel
from omero_ms_image_region_tpu.utils import decisions as jax_decisions
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.server import sentinel
from omero_ms_image_region_tpu_torch.server.config import (
    AppConfig, SentinelConfig)
from omero_ms_image_region_tpu_torch.services.warmstate import (
    WarmStateManager)
from omero_ms_image_region_tpu_torch.utils import decisions, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = "render_image_region|s64k"


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (jax_telemetry, telemetry):
        mod.reset()
    jax_decisions.LEDGER.reset()
    yield
    for mod in (jax_telemetry, telemetry):
        mod.reset()
    jax_decisions.LEDGER.reset()
    sentinel.uninstall()


def _engine(mod, bundle_dir, clk, **over):
    kwargs = dict(
        member="t0", tick_interval_s=5.0, confirm_ticks=2,
        recover_ticks=2, min_samples=8, warmup_ticks=2, drift_ratio=1.5,
        baseline_alpha=0.2, bundle_dir=str(bundle_dir), max_bundles=3,
        profile_ms=10, clock=lambda: clk[0],
        profile_fn=lambda directory, ms: {"skipped": "test"},
        flight_fn=lambda: {"events": [{"kind": "test"}]},
        costs_fn=lambda: [{"trace": "t-1"}],
        exemplars_fn=lambda: {"render_image_region": []})
    kwargs.update(over)
    return mod.SentinelEngine(**kwargs)


# (latency centre ms, observations) per tick: warm-up, a step to 40 ms
# (confirmed on its second window), a quiet window, still drifting, and
# the recovery.
SCHEDULE = ([(12.0, 12)] * 3 + [(40.0, 12), (40.0, 3), (40.0, 12),
                                 (40.0, 12), (12.0, 12), (12.0, 12),
                                 (12.0, 12), (25.0, 12)])


def _drill(mod, bundle_dir, seed, watermarks):
    rng = np.random.default_rng(seed)
    clk = [0.0]
    eng = _engine(mod, bundle_dir, clk, watermarks=watermarks)
    summaries = []
    for centre, n in SCHEDULE:
        for jitter in rng.uniform(0.97, 1.09, n):
            eng.observe("render_image_region", 65536, centre * jitter)
        eng.observe("render_birds_eye_view", 10 ** 9, 1.0)   # overflow
        clk[0] += 5.0
        s = eng.tick()
        s = dict(s, last_bundle=bool(s["last_bundle"]))
        summaries.append((s, eng.verdict))
    return eng, summaries


@pytest.mark.parametrize("seed, watermarks", [
    (0, {}),
    (1, {"bench": {"p50_service_tile_ms_ex_rtt": {"value": 5.0},
                   "service_tiles_per_sec": {"value": 0.001}}}),
    (2, {"bench": {"p50_service_tile_ms_ex_rtt": {"value": 200.0}}}),
])
def test_verdicts_match_jax_tick_by_tick(tmp_path, seed, watermarks):
    out = []
    for name, mod, ledger, tel in (
            ("jax", jax_sentinel, jax_decisions.LEDGER, jax_telemetry),
            ("port", sentinel, decisions.LEDGER, telemetry)):
        eng, summaries = _drill(mod, tmp_path / name, seed, watermarks)
        records = [(r["kind"], r["verdict"], r.get("detail"))
                   for r in ledger.snapshot()]
        bundles = sorted(os.listdir(tmp_path / name)) \
            if os.path.isdir(tmp_path / name) else []
        manifests = []
        for b in bundles:
            with open(tmp_path / name / b / "manifest.json") as f:
                doc = json.load(f)
            manifests.append((doc["kind"], doc["member"], doc["drifting"],
                              doc["files"]))
        merged = tel.SENTINEL.merged()
        for row in merged["members"].values():
            row["summary"]["last_bundle"] = bool(
                row["summary"]["last_bundle"])
        out.append((summaries, records, manifests, merged,
                    tel.SENTINEL.metric_lines(), eng.export_baseline()))
    assert out[1] == out[0]
    verdicts = [v for _, v in out[1][0]]
    if seed < 2:
        assert verdicts.count("drifting") >= 2 and verdicts[-1] == "ok"
        assert len(out[1][2]) == 1           # one bundle per incident
    else:
        # A latency floor of 200 ms: 40 ms is no drift.
        assert "drifting" not in verdicts and not out[1][2]


def test_vocabularies_match_jax():
    assert sentinel.ROUTE_CLASSES == jax_sentinel.ROUTE_CLASSES
    assert sentinel.SHAPE_BUCKETS == jax_sentinel.SHAPE_BUCKETS
    sizes = [0, 1, 4096, 4097, 65536, 65537, 1 << 20, 1 << 22, 1 << 30]
    assert [sentinel.shape_bucket(n) for n in sizes] == \
        [jax_sentinel.shape_bucket(n) for n in sizes]
    routes = list(jax_sentinel.ROUTE_CLASSES) + ["render_overlay", ""]
    assert [sentinel.route_class(r) for r in routes] == \
        [jax_sentinel.route_class(r) for r in routes]


def test_baselines_export_and_load_match_jax(tmp_path):
    docs = []
    for mod in (jax_sentinel, sentinel):
        eng, _ = _drill(mod, tmp_path / mod.__name__, 3, {})
        doc = eng.export_baseline()
        fresh = _engine(mod, "", [0.0])
        foreign = [fresh.load_baseline(d) for d in (
            None, {"version": 99}, {"version": 1, "baselines": {
                KEY: {"p50": 1.0, "p99": 2.0, "ticks": 5},
                "made_up_route|s64k": {"p99": 2.0},
                "render_image_region|s9k": {"p99": 2.0},
                "render_image|s4k": {"p99": "NaNope"}}})]
        again = _engine(mod, "", [0.0])
        docs.append((doc, again.load_baseline(doc), foreign,
                     again.export_baseline()))
    assert docs[1] == docs[0]
    assert KEY in docs[1][0]["baselines"]


def test_the_port_sentinel_reads_no_records():
    """Built at the repo root, the port's sentinel has no watermark; the
    JAX loader finds the committed TPU and CPU marks there."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        eng = sentinel.engine_from_config(SentinelConfig(), member="local")
        cfg = AppConfig.from_dict({"sentinel": {"records-dir": REPO}})
        eng2 = sentinel.engine_from_config(cfg.sentinel, member="local")
    finally:
        os.chdir(cwd)
    assert eng.watermarks == {} and eng2.watermarks == {}
    assert jax_sentinel.load_repo_watermarks(REPO)
    assert not any("bench_gate" in m for m in sys.modules
                   if "torch" in m)


def test_the_bundle_profiles_with_torch_profiler(tmp_path):
    """No injected profiler: the bundle's profile is a
    ``telemetry.capture_profile`` Chrome trace, its directory relative to
    the bundle."""
    clk = [0.0]
    eng = _engine(sentinel, tmp_path, clk, profile_fn=None, profile_ms=5,
                  watermarks={})
    for centre, n in SCHEDULE[:5]:
        for i in range(n):
            eng.observe("render_image_region", 65536, centre + i * 0.1)
        clk[0] += 5.0
        eng.tick()
    for centre in (40.0, 40.0):
        for i in range(12):
            eng.observe("render_image_region", 65536, centre + i * 0.1)
        clk[0] += 5.0
        eng.tick()
    assert eng.verdict == "drifting"
    (bundle,) = os.listdir(tmp_path)
    with open(tmp_path / bundle / "profile.json") as f:
        prof = json.load(f)
    assert prof["files"] == ["trace.json"] and prof["bytes"] > 0
    assert os.path.exists(tmp_path / bundle / prof["dir"] / "trace.json")
    assert telemetry.FLIGHT.snapshot()[-1]["kind"] == "sentinel.capture"


def test_the_tick_runs_on_a_worker_thread(tmp_path):
    import threading
    seen = []
    eng = sentinel.SentinelEngine(tick_interval_s=0.01)
    eng.tick = lambda: seen.append(threading.current_thread().name)

    async def run():
        task = asyncio.create_task(eng.run())
        while len(seen) < 2:
            await asyncio.sleep(0.01)
        eng.close()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    asyncio.run(run())
    assert threading.main_thread().name not in seen


def test_the_manifest_carries_the_baselines(tmp_path):
    eng, _ = _drill(sentinel, tmp_path / "b", 4, {})
    sentinel.install(eng)
    services = SimpleNamespace(caches=None, raw_cache=None, renderer=None)
    manager = WarmStateManager(str(tmp_path / "ws"), services,
                               snapshot_interval_s=0)
    assert manager.snapshot_now()
    with open(manager.manifest_path) as f:
        doc = json.load(f)
    assert doc["sentinel"] == eng.export_baseline()
    # The next life restores them before anything else.
    fresh = _engine(sentinel, "", [0.0])
    sentinel.install(fresh)
    manager._rehydrate()
    assert fresh.export_baseline()["baselines"][KEY]["p99"] == \
        doc["sentinel"]["baselines"][KEY]["p99"]
