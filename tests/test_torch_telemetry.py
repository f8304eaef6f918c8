"""Spans, traces and ``/metrics`` of the port against the JAX package.

The same request sequence goes through both default apps, built from one
config dict over one pyramid the test writes (every JPEG region on the
device route): the port's scrape carries the same families, with the same
label keys, as the JAX app's for every family the port has; the request
counts are equal; the scrape passes the repo's cardinality budget
(``scripts/metrics_lint.py`` against ``conf/metrics_budget.json``); and
every span of the render path has samples.  A coalesced follower records
its wait, and a span recorded in a lane thread lands on the trace of every
member of its group.
"""

import asyncio
import importlib.util
import os
import re

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu.utils.stopwatch import (
    REGISTRY as JAX_SPANS)
from omero_ms_image_region_tpu_torch.models.pixels import Pixels
from omero_ms_image_region_tpu_torch.models.rendering import (
    RenderingModel, default_rendering_def)
from omero_ms_image_region_tpu_torch.ops.render import pack_settings
from omero_ms_image_region_tpu_torch.server.app import (
    build_handler, build_services, create_app)
from omero_ms_image_region_tpu_torch.server.batcher import (
    BatchingRenderer)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.utils import (
    faultinject, telemetry, transient)
from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 7
C = "1|0:60000$FF0000,2|0:60000$00FF00"
BASE = f"/webgateway/render_image_region/{IMG}/0/0"
RENDER_SPANS = ("canRead", "get_pixels_description",
                "PixelsService.getPixelBuffer", "PixelsService.readRegion",
                "Renderer.renderAsPackedInt", "encodeImage",
                "batcher.queueWait", "batcher.stage",
                "Renderer.renderAsPackedInt.batch", "jfif.encodeBatch")
_SERIES = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})? (\S+)$")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("telemetry")
    planes = np.random.default_rng(6).integers(
        0, 60000, size=(2, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


def _lint():
    spec = importlib.util.spec_from_file_location(
        "metrics_lint", os.path.join(REPO, "scripts", "metrics_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _series(text: str):
    """{(name, labels-without-le): value} of an exposition."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, labels, value = _SERIES.match(line).groups()
        out[(name, labels or "")] = float(value)
    return out


def _families(text: str, types: dict) -> set:
    """(family, label keys) of an exposition, for the families in
    ``types``."""
    fams = set()
    for name, labels in _series(text):
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    types.get(name[:-len(suffix)]) == "histogram":
                fam = name[:-len(suffix)]
        if fam in types:
            keys = tuple(sorted(kv.split("=")[0]
                                for kv in labels.split(",") if kv))
            fams.add((fam, keys))
    return fams


async def _drive(app):
    """The sequence: a device-route JPEG GET, its If-None-Match repeat, a
    HEAD, two identical concurrent JPEG GETs, a PNG GET, a 404 and a 400;
    then the scrape."""
    from aiohttp.test_utils import TestClient, TestServer

    async with TestClient(TestServer(app)) as client:
        jpeg = {"tile": "0,0,0,48,40", "c": C, "m": "c", "format": "jpeg"}
        r = await client.get(BASE, params=jpeg)
        etag = r.headers["ETag"]
        await client.get(BASE, params=jpeg, headers={"If-None-Match": etag})
        await client.head(BASE, params=jpeg)
        twin = dict(jpeg, tile="0,1,1,32,32")
        await asyncio.gather(client.get(BASE, params=twin),
                             client.get(BASE, params=twin))
        await client.get(BASE, params=dict(jpeg, format="png"))
        await client.get("/webgateway/render_image/99/0/0", params=jpeg)
        await client.get(f"/webgateway/render_image/{IMG}/5/0",
                         params=jpeg)
        r = await client.get("/metrics")
        return r.headers["Content-Type"], await r.text()


def test_metrics_match_jax(data_dir):
    # The perf sentinels (on by default) tick once an hour here: a tick in
    # one app's run and not the other's would add the sentinel families to
    # one scrape.
    raw = {"data-dir": data_dir, "renderer": {"cpu-fallback-max-px": 0},
           "sentinel": {"tick-interval-s": 3600}}
    jax_telemetry.reset()
    JAX_SPANS.reset()
    _, jax_text = asyncio.run(_drive(jax_app(JaxConfig.from_dict(raw))))
    telemetry.reset()
    REGISTRY.reset()
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(raw),
                                                "cpu"))
    content_type, text = asyncio.run(_drive(create_app(
        AppConfig.from_dict(raw), "cpu", handler=handler)))

    assert content_type.startswith("text/plain")
    types = telemetry.METRIC_TYPES
    port_fams = _families(text, types)
    # The shape-cost estimates differ by design: the port counts its
    # kernels' bytes and operations when a shape first runs, the JAX
    # batcher asks XLA's cost_analysis() on a thread 5 s later.
    estimates = {("imageregion_shape_estimated_flops", ("shape",)),
                 ("imageregion_shape_estimated_bytes", ("shape",))}
    assert port_fams - estimates == _families(jax_text, types) - estimates
    # Every ported family but the shed and watchdog counters, the
    # prefetcher's skips, the workload routes' families and the pyramid
    # job's, which this sequence never moves (tests/test_torch_workloads.py,
    # tests/test_torch_readers.py and tests/test_torch_prefetch.py hold
    # those to the JAX app's), the byte caches' evictions, which the
    # native LRU tier does not count in either package, and the build
    # store's, which exist only with persistence on
    # (tests/test_torch_warmstate.py); and the forensics and overload
    # families this default app does not move (no SLO objective, no
    # decision, no sentinel tick, no pressure governor:
    # tests/test_torch_forensics.py, tests/test_torch_sentinel.py and
    # tests/test_torch_pressure.py hold those to the JAX app's); and the
    # sidecar client's breaker, retries and attempts, which only a
    # frontend has (tests/test_torch_sidecar.py); and the QoS sheds by
    # class, which only a session's fairness shed moves
    # (tests/test_torch_growth.py), and dequeues, the fleet router's; and
    # the fleet's families, which only a fleet moves (its drain totals
    # excepted: both apps always emit them), held to the JAX app's by
    # tests/test_torch_fleet.py.
    assert {f for f, _ in port_fams} == set(types) - {
        *(f for f in types if f.startswith(("imageregion_fleet_",
                                            "imageregion_hotkey_"))),
        # The federation's, which only a federation (or a partition
        # drill) moves, held to the JAX app's by
        # tests/test_torch_federation.py.
        *(f for f in types if f.startswith(("imageregion_federation_",
                                            "imageregion_partition_"))),
        "imageregion_drain_state", "imageregion_drain_transitions_total",
        "imageregion_breaker_state", "imageregion_breaker_opens_total",
        "imageregion_retries_total", "imageregion_retry_attempts",
        "imageregion_slo_burn_rate", "imageregion_slo_breach",
        "imageregion_slo_breaches_total", "imageregion_decision_total",
        "imageregion_pressure_signal", "imageregion_pressure_step_engaged",
        "imageregion_pressure_step_transitions_total",
        *(f for f in types if f.startswith("imageregion_sentinel_")),
        "imageregion_cache_evictions",
        "imageregion_execcache_hits", "imageregion_execcache_misses",
        "imageregion_execcache_loaded_total",
        "imageregion_execcache_saved_total",
        "imageregion_shed_total", "imageregion_watchdog_fires_total",
        "imageregion_prefetch_skipped_total",
        "imageregion_qos_shed_total", "imageregion_qos_dequeued_total",
        "imageregion_workload_requests_total",
        "imageregion_pyramid_jobs_total",
        "imageregion_pyramid_jobs_active",
        "imageregion_pyramid_levels_committed_total",
        "imageregion_animation_streams_total",
        "imageregion_animation_frames_total",
        "imageregion_animation_cancelled_total",
        "imageregion_animation_first_frame_ms"}

    def totals(t):
        return {k: v for k, v in _series(t).items()
                if k[0] == "imageregion_requests_total"}
    assert totals(text) == totals(jax_text)
    assert totals(text)[("imageregion_requests_total",
                         'route="render_image_region",status="200"')] == 5
    lint = _lint()
    assert lint.lint_exposition(text, lint.load_budget()) == []

    spans = REGISTRY.snapshot()
    for name in RENDER_SPANS:
        assert spans.get(name, {}).get("count", 0) >= 1, name
    assert 'imageregion_span_count{span="jfif.encodeBatch"}' in text


def test_a_coalesced_follower_records_its_wait(data_dir):
    """Two identical requests while the first one's group is frozen: the
    follower's await is a ``dedup.coalesced`` span on its own trace."""
    telemetry.reset()
    handler = build_handler(data_dir, device="cpu", jpeg_host_max_px=0)
    params = {"imageId": str(IMG), "theZ": "0", "theT": "0",
              "tile": "0,0,0,48,40", "c": C, "m": "c", "format": "jpeg"}

    async def one(trace_id):
        with telemetry.trace_scope(trace_id, "render_image_region"):
            return await handler.render_image_region(
                ImageRegionCtx.from_params(params))

    async def main():
        try:
            leader = asyncio.ensure_future(one("lead"))
            await asyncio.sleep(0.05)           # the leader is frozen
            return await asyncio.gather(leader, one("follow"))
        finally:
            await handler.s.renderer.close()

    faultinject.install(faultinject.FaultInjectionConfig(
        seed=1, freeze_rate=1.0, freeze_ms=300.0, freeze_max=1))
    try:
        bodies = asyncio.run(main())
    finally:
        faultinject.uninstall()
    assert bodies[0] == bodies[1] and handler.s.single_flight.hits == 1
    spans = {t: [s["name"] for s in telemetry.TRACES.finish(t).spans]
             for t in ("lead", "follow")}
    assert "dedup.coalesced" in spans["follow"]
    assert "dedup.coalesced" not in spans["lead"]


def test_a_lane_span_lands_on_every_member_trace():
    """Two requests, each in its own trace, rendered in one group: the
    group's spans are on both traces, each request's queue wait on its
    own; a request whose budget died in the queue records its wait as
    cancelled."""
    telemetry.reset()
    REGISTRY.reset()
    rng = np.random.default_rng(0)
    raws = [rng.integers(0, 60000, (2, 24, 32)).astype(np.uint16)
            for _ in range(3)]
    rdef = default_rendering_def(Pixels(
        image_id=1, pixels_type="uint16", size_x=32, size_y=24, size_c=2))
    rdef.model = RenderingModel.RGB
    settings = pack_settings(rdef)

    async def one(batcher, raw, trace_id, budget_ms=0.0):
        with telemetry.trace_scope(trace_id, "r"), \
                transient.deadline_scope(budget_ms):
            try:
                return await batcher.render_jpeg(raw, settings, 85, 32, 24)
            except transient.DeadlineExceededError:
                return None

    async def main():
        batcher = BatchingRenderer("cpu", linger_ms=200.0)
        try:
            # A lone request on an idle renderer skips the linger: keep
            # one group running so the three below arrive together.
            first = asyncio.ensure_future(one(batcher, raws[0], "t0"))
            await asyncio.sleep(0)
            return await asyncio.gather(
                first, one(batcher, raws[1], "ta"),
                one(batcher, raws[2], "tb"),
                one(batcher, raws[2], "tc", budget_ms=1e-3))
        finally:
            await batcher.close()

    out = asyncio.run(main())
    assert out[1] and out[2] and out[3] is None
    traces = {tid: telemetry.TRACES.finish(tid)
              for tid in ("ta", "tb", "tc")}
    for tid in ("ta", "tb"):
        names = [s["name"] for s in traces[tid].spans]
        assert names.count("batcher.queueWait") == 1
        assert "Renderer.renderAsPackedInt.batch" in names
        assert "jfif.encodeBatch" in names
    batch = [[s["dur_ms"] for s in traces[t].spans
              if s["name"] == "Renderer.renderAsPackedInt.batch"]
             for t in ("ta", "tb")]
    assert len(batch[0]) == 1 and batch[0] == batch[1]   # one group
    assert [s["name"] for s in traces["tc"].spans] == [
        "batcher.queueWait.cancelled"]
    assert telemetry.RESILIENCE.deadline_cancelled == 1


def test_persistence_and_flight_families_pass_the_lint(data_dir, tmp_path):
    """With persistence on (the disk tier, the build store, the rehydrate)
    the scrape carries the warm-state, build-store and flight-recorder
    families, with JAX's types, and passes the cardinality budget."""
    from omero_ms_image_region_tpu_torch.server import execcache

    raw = {"data-dir": data_dir, "renderer": {"cpu-fallback-max-px": 0},
           "image-region-cache": {"enabled": True},
           "persistence": {"enabled": True, "dir": str(tmp_path / "warm"),
                           "snapshot-interval-s": 0}}
    telemetry.reset()
    config = AppConfig.from_dict(raw)
    config.caches.disk_sync_writes = True
    handler = ImageRegionHandler(build_services(config, "cpu"))
    try:
        _, text = asyncio.run(_drive(create_app(
            AppConfig.from_dict(raw), "cpu", handler=handler)))
    finally:
        execcache.install(None)
    lint = _lint()
    assert lint.lint_exposition(text, lint.load_budget()) == []
    fams = {f for f, _ in _families(text, telemetry.METRIC_TYPES)}
    warm = {f for f in telemetry.METRIC_TYPES
            if f.startswith(("imageregion_diskcache_",
                             "imageregion_warmstate_",
                             "imageregion_rehydrate_",
                             "imageregion_execcache_",
                             "imageregion_flight_"))}
    assert len(warm) == 25 and warm <= fams
    assert {f: telemetry.METRIC_TYPES[f] for f in warm} == {
        f: jax_telemetry.METRIC_TYPES[f] for f in warm}
    series = _series(text)
    assert series[("imageregion_diskcache_writes_total", "")] >= 1
    assert series[("imageregion_flight_events_total", "")] >= 1
