"""The port's forensics plane against the JAX package's.

The same inputs, made from a seed with numpy, go through the JAX object and
the port's:

* ``RankSketch``: quantiles, merges and the wire document are equal;
* the decision ledger: snapshots, status and the JSONL spool are equal
  apart from wall times;
* ``SloEngine``: burn rates, breach flags, breach callbacks, summaries and
  gauges on one virtual clock, tick by tick;
* ``ShapeCostModel``: the observed half (dispatches, ms) is equal (the
  estimates differ by design: XLA's ``cost_analysis()`` against the port's
  kernel count);
* the request histogram's exemplars and the OpenMetrics exposition.

And both default apps, built from one config dict over one small pyramid
(every JPEG region on the device route, the port on the CPU), after the
same GETs: the six ``/debug`` routes answer with the same status and key
sets, ``/debug/explain`` gives the same document for the same URLs (the
admission's EWMA wait apart), ``/readyz`` has the same check keys, an
OpenMetrics scrape declares the same families with the same metadata and
carries exemplars whose trace ids ``/debug/exemplars`` lists, and a second
``/debug/profile`` while one is live answers 409 in both.
"""

import asyncio
import json
import re

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import decisions as jax_decisions
from omero_ms_image_region_tpu.utils import sketch as jax_sketch
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.server.app import (
    build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.utils import decisions, sketch, \
    telemetry

IMG = 7
C = "1|0:60000$FF0000,2|0:60000$00FF00"
BASE = f"/webgateway/render_image_region/{IMG}/0/0"
TILE = {"tile": "0,0,0,48,40", "c": C, "m": "c", "format": "jpeg"}
DEBUG_ROUTES = ("/debug/costs", "/debug/decisions", "/debug/exemplars",
                "/debug/sentinel", "/debug/profile?ms=20",
                f"/debug/explain?path={BASE}/?tile=0,0,0,48,40")


@pytest.fixture(autouse=True)
def _fresh():
    jax_telemetry.reset()
    telemetry.reset()
    yield
    jax_telemetry.reset()
    telemetry.reset()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("forensics")
    planes = np.random.default_rng(14).integers(
        0, 60000, size=(2, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


# ------------------------------------------------------------- units

@pytest.mark.parametrize("seed, lo, hi, b", [
    (0, 0.01, 1e6, 32), (1, 0.5, 5e3, 8), (2, 1.0, 100.0, 3)])
def test_rank_sketch_matches_jax(seed, lo, hi, b):
    rng = np.random.default_rng(seed)
    a = rng.lognormal(2.0, 1.5, 400).tolist() + [0.0, lo, hi, hi * 10]
    c = rng.lognormal(3.0, 0.5, 150).tolist()
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0, -1.0, 2.0]
    docs = []
    for mod in (jax_sketch, sketch):
        s1, s2 = mod.RankSketch(lo, hi, b), mod.RankSketch(lo, hi, b)
        empty = s1.quantile(0.5)
        for v in a:
            s1.add(v)
        for v in c:
            s2.add(v)
        before = s1.quantiles(qs)
        merged = s1.copy().merge(s2)
        with pytest.raises(ValueError):
            s1.merge(mod.RankSketch(lo * 2, hi, b))
        back = mod.RankSketch.from_doc(merged.to_doc())
        docs.append((empty, before, merged.quantiles(qs), merged.n,
                     merged.to_doc(), back.quantiles(qs), s1.bounds,
                     mod.RankSketch.from_doc({"v": 1, "lo": "x"}),
                     mod.RankSketch.from_doc({"v": 2})))
    assert docs[0] == docs[1]


def test_decision_ledger_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    kinds = list(telemetry.DecisionStats.KINDS) + ["bogus"]
    verdicts = list(telemetry.DecisionStats.VERDICTS) + ["maybe"]
    stream = [(kinds[i], verdicts[j], f"m{k}" if k else "",
               {"n": int(k)} if k % 2 else None)
              for i, j, k in zip(rng.integers(0, len(kinds), 40),
                                 rng.integers(0, len(verdicts), 40),
                                 rng.integers(0, 3, 40))]

    def run(mod, spool):
        ledger = mod.DecisionLedger(ring_size=16, spool_dir=str(spool),
                                    outcome_horizon_ticks=2)
        seqs = [ledger.record(*rec) for rec in stream]
        found = [ledger.resolve(s, {"queue_delta": -s})
                 for s in seqs[::7] + [9999]]
        ledger.configure(ring_size=20, outcome_horizon_ticks=4)
        snap = [{k: v for k, v in r.items() if k != "ts"}
                for r in ledger.snapshot()]
        lines = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                 for line in (spool / "decisions.jsonl").read_text()
                 .splitlines()]
        status = dict(ledger.status(), spool_dir=None)
        return seqs, found, snap, ledger.snapshot(limit=3)[-1]["seq"], \
            lines, status

    want = run(jax_decisions, tmp_path / "jax")
    got = run(decisions, tmp_path / "port")
    assert got == want
    assert -1 in got[0] and len(got[2]) == 16
    # The module-level ledger feeds the flight ring and the counter.
    telemetry.DECISIONS.reset()
    decisions.record("sentinel", "drift", member="local")
    assert telemetry.DECISIONS.counts == {("sentinel", "drift"): 1}
    assert telemetry.FLIGHT.snapshot()[-1]["kind"] == "decision.sentinel"


def test_slo_engine_matches_jax():
    rng = np.random.default_rng(5)
    statuses = rng.choice([200, 200, 200, 304, 404, 503, 504], 600)
    durations = rng.lognormal(3.0, 1.0, 600)
    steps = rng.uniform(0.0, 2.5, 600)

    def run(tel):
        clock = [1000.0]
        fired = []
        eng = tel.SloEngine()
        eng.configure(availability_target=0.95, latency_ms=40.0,
                      latency_target=0.9, fast_window_s=20.0,
                      slow_window_s=60.0, breach_burn_rate=2.0,
                      on_breach=lambda o, f, s: fired.append(
                          (len(trail), o, round(f, 6), round(s, 6))),
                      clock=lambda: clock[0])
        trail = []
        for st, d, dt in zip(statuses, durations, steps):
            clock[0] += float(dt)
            eng.record(int(st), float(d))
            trail.append((eng.burn_rates(), dict(eng.breached),
                          eng.summary()))
        return trail, fired, eng.metric_lines(), eng.breaches_total

    want, got = run(jax_telemetry), run(telemetry)
    assert got == want
    assert got[1], "the stream never breached"
    off = telemetry.SloEngine()
    off.record(503, 1.0)
    assert off.metric_lines() == [] and off.summary() == "disabled"


def test_shape_cost_observed_half_matches_jax():
    rng = np.random.default_rng(9)
    shapes = ["B8x4x1024x1024", "jpeg:B3x4x512x512", "B1x2x256x256"]
    stream = [(shapes[i], float(ms)) for i, ms in zip(
        rng.integers(0, 3, 50), rng.uniform(0.1, 30.0, 50))]
    out = []
    for tel in (jax_telemetry, telemetry):
        model = tel.ShapeCostModel()
        for shape, ms in stream:
            model.observe(shape, ms)
        claims = [model.claim_estimate(s) for s in shapes + shapes]
        out.append(({k: (v["dispatches"], round(v["ms_total"], 9))
                     for k, v in model.snapshot().items()}, claims))
    assert out[0] == out[1]
    assert out[1][1] == [True] * 3 + [False] * 3


def test_exemplars_and_openmetrics_match_jax():
    rng = np.random.default_rng(12)
    obs = [(f"r{i}", float(v), (f"t{k:04d}", "render_cold"))
           for i, v, k in zip(rng.integers(0, 2, 60),
                              rng.lognormal(2.0, 2.0, 60), range(60))]
    ts = re.compile(r" [0-9.]+$")
    out = []
    for tel in (jax_telemetry, telemetry):
        vec = tel.HistogramVec("route", exemplars=True)
        for route, v, ex in obs:
            vec.observe(route, v, exemplar=ex)
        vec.observe("r0", 1.0)               # no exemplar: keeps the old
        docs = {r: [{k: v for k, v in d.items() if k != "ts"} for d in ds]
                for r, ds in vec.exemplar_docs().items()}
        lines = vec.series("imageregion_request_duration_ms",
                           exemplars=True)
        plain = vec.series("imageregion_request_duration_ms")
        body = tel.finalize_exposition(
            lines + ["imageregion_flight_events 3",
                     "imageregion_flight_events_total 4",
                     "imageregion_shed_total{reason=\"x\"} 1",
                     "imageregion_batches_dispatched 2", "# a comment"],
            openmetrics=True)
        out.append((docs, [ts.sub("", x) for x in lines], plain,
                    [ts.sub("", x) for x in body.splitlines()]))
    assert out[0] == out[1]
    assert any(" # {trace_id=" in x for x in out[1][1])
    assert not any("#" in x for x in out[1][2])


@pytest.mark.parametrize("path", [
    "/webgateway/render_image_region/7/0/0?tile=0,1,2,64,48&c=1|0:9",
    "/webclient/render_image/7/1/2/tail?region=1,2,3,4&tail=x",
    "/webgateway/render_shape_mask/3/?color=00FF00",
    "/webgateway/render_overlay/7/0/0?shapes=2,3",
    "/webgateway/render_animation/7/0/0?axis=z&frames=2",
    "/webgateway/render_birds_eye_view/7", "relative/path", ""])
def test_render_path_parsing_matches_jax(path):
    from omero_ms_image_region_tpu.server import explain as jax_explain
    from omero_ms_image_region_tpu_torch.server import explain

    def parse(mod, fn):
        try:
            return getattr(mod, fn)(path)
        except Exception as e:
            return type(e).__name__, str(e)
    for fn in ("parse_render_path", "classify_render_path"):
        assert parse(explain, fn) == parse(jax_explain, fn)


# -------------------------------------------------------------- apps

def _raw(data_dir) -> dict:
    # The sentinels tick once an hour: a tick in one app's session and not
    # the other's (a loaded host) would change its view and its families.
    return {"data-dir": data_dir, "renderer": {"cpu-fallback-max-px": 0},
            "watchdog": {"enabled": False},
            "raw-cache": {"prefetch": False},
            "sentinel": {"tick-interval-s": 3600},
            "telemetry": {"profile-dir": data_dir + "/profiles"}}


def _apps(raw):
    """Both default apps from ``raw`` (the port's on the CPU)."""
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(
        dict(raw)), "cpu"))
    return [("jax", lambda: jax_app(JaxConfig.from_dict(dict(raw)))),
            ("port", lambda: create_app(AppConfig.from_dict(dict(raw)),
                                        "cpu", handler=handler))]


EXPLAINED = (
    f"{BASE}?tile=0,0,0,48,40&c={C}&m=c&format=jpeg",
    f"{BASE}/?tile=0,1,1,32,32&format=png",
    f"/webclient/render_image/{IMG}/0/0?p=intmax",
    "/webgateway/render_shape_mask/3?color=00FF00&flip=h",
    f"/webgateway/render_overlay/{IMG}/0/0?shapes=2,3&color=FF0000",
    f"/webgateway/render_animation/{IMG}/0/0?axis=z&frames=1",
    f"/webgateway/render_animation/{IMG}/0/0?axis=q",
    "/webgateway/render_birds_eye_view/1",
    "")


async def _session(app, om_headers):
    from urllib.parse import quote

    from aiohttp.test_utils import TestClient, TestServer

    out = {}
    async with TestClient(TestServer(app)) as client:
        r = await client.get(BASE, params=TILE)
        assert r.status == 200
        await r.read()
        r = await client.get(BASE, params=dict(TILE, tile="0,1,1,16,16"))
        await r.read()
        for route in DEBUG_ROUTES:
            r = await client.get(route)
            out[route] = (r.status, await r.json())
        explained = []
        for url in EXPLAINED:
            r = await client.get("/debug/explain?path=" + quote(url))
            explained.append((r.status, await r.json()))
        out["explain"] = explained
        r = await client.get("/readyz")
        out["readyz"] = (r.status, await r.json())
        r = await client.get("/metrics", headers=om_headers)
        out["om"] = (r.headers["Content-Type"], await r.text())
        r = await client.get("/metrics")
        out["plain"] = await r.text()
        r = await client.get("/debug/profile?ms=banana")
        out["bad_ms"] = r.status
    return out


def _metadata(body: str) -> dict:
    """{family of the series: (HELP/TYPE name, type)} of an exposition."""
    out, meta = {}, None
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            meta = (name, kind)
        elif line and not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            fam = telemetry._family_of(line)
            out.setdefault(fam if fam in telemetry.METRIC_TYPES
                           else name, meta)
    return out


def _keys(doc):
    """The key structure of a JSON document (values dropped)."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    return type(doc).__name__


def test_debug_routes_explain_readyz_and_openmetrics_match_jax(data_dir):
    om = {"Accept": "application/openmetrics-text; version=1.0.0"}
    runs = {}
    for name, build in _apps(_raw(data_dir)):
        (jax_telemetry if name == "jax" else telemetry).reset()
        runs[name] = asyncio.run(_session(build(), om))
    jax, port = runs["jax"], runs["port"]

    for route in DEBUG_ROUTES:
        (js, jd), (ps, pd) = jax[route], port[route]
        assert (ps, sorted(pd)) == (js, sorted(jd)), route
        assert ps == 200
    assert _keys(port["/debug/decisions"][1]) == \
        _keys(jax["/debug/decisions"][1])
    # The sentinel's view: equal but for the watermark, which the port
    # never reads from the repo's TPU records (server.sentinel).
    views = [d["/debug/sentinel"][1] for d in (jax, port)]
    marks = [v["members"]["local"]["summary"].pop("watermark_tiles_per_s")
             for v in views]
    assert views[1] == views[0] and marks[1] is None
    costs = port["/debug/costs"][1]
    assert costs["top"] and costs["observed"] == 2
    assert sorted(costs["shapes"]) == sorted(jax["/debug/costs"][1]["shapes"])
    assert all(v["dispatches"] and v["est_bytes"] > 0
               for v in costs["shapes"].values())
    profile = port["/debug/profile?ms=20"][1]
    assert profile["files"] == ["trace.json"] and profile["bytes"] > 0
    assert sorted(profile) == sorted(jax["/debug/profile?ms=20"][1])
    assert port["bad_ms"] == jax["bad_ms"] == 400

    for (js, jd), (ps, pd) in zip(jax["explain"], port["explain"]):
        for doc in (jd, pd):
            doc.get("admission", {}).pop("estimated_wait_ms", None)
        assert (ps, pd) == (js, jd)
    assert port["explain"][0][1]["residency"]["hbm"] is True

    assert port["readyz"] == jax["readyz"]
    assert sorted(port["readyz"][1]["checks"]) == [
        "prewarm", "queue", "sentinel"]

    (jct, jbody), (pct, pbody) = jax["om"], port["om"]
    assert pct.startswith("application/openmetrics-text") and \
        jct.startswith("application/openmetrics-text")
    assert pbody.endswith("# EOF\n") and jbody.endswith("# EOF\n")
    pmeta, jmeta = _metadata(pbody), _metadata(jbody)
    # The estimates differ by design (the JAX one comes from XLA, 5 s
    # after a shape's first group).
    common = set(telemetry.METRIC_TYPES) - {
        "imageregion_shape_estimated_flops",
        "imageregion_shape_estimated_bytes"}
    assert {f for f in pmeta if f in common} == \
        {f for f in jmeta if f in common}
    for fam in set(pmeta) & set(jmeta):
        assert pmeta[fam] == jmeta[fam], fam
    # The exemplar tails name traces /debug/exemplars lists.
    tails = set(re.findall(r'# \{trace_id="([0-9a-f]+)",tier="(\w+)"\}',
                           pbody))
    listed = {(d["trace"], d["tier"]) for docs in port[
        "/debug/exemplars"][1]["request_duration_ms"].values()
        for d in docs}
    assert tails and tails <= listed
    assert " # {" not in port["plain"] and " # {" not in jax["plain"]


def test_a_second_profile_while_one_is_live_is_409(data_dir):
    async def probe(app):
        from aiohttp.test_utils import TestClient, TestServer
        async with TestClient(TestServer(app)) as client:
            r = await client.get("/debug/profile?ms=5")
            return r.status, sorted(await r.json())

    answers = []
    for name, build in _apps(_raw(data_dir)):
        lock = (jax_telemetry if name == "jax" else telemetry)._PROFILE_LOCK
        assert lock.acquire(blocking=False)
        try:
            answers.append(asyncio.run(probe(build())))
        finally:
            lock.release()
    assert answers[0] == answers[1] == (409, ["error"])


def test_slow_traces_slo_breach_and_pyramid_job_match_jax(tmp_path):
    """A slow-request threshold and a latency objective every request
    misses: each package writes the request's waterfall, breaches the
    objective on the first request and dumps its flight ring, and says so
    on ``/readyz``; ``/debug/explain`` reads the image's pyramid job from
    its job file."""
    from urllib.parse import quote

    data = tmp_path / "data"
    planes = np.random.default_rng(15).integers(
        0, 60000, size=(2, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(data / str(IMG)), chunk=(32, 32), n_levels=1)
    (data / str(IMG) / "pyramid.zarr.job.json").write_text(json.dumps(
        {"jobId": "pj-9", "state": "done", "levelsDone": 2}))

    async def session(app):
        from aiohttp.test_utils import TestClient, TestServer
        async with TestClient(TestServer(app)) as client:
            r = await client.get(BASE, params=TILE)
            assert r.status == 200
            await r.read()
            r = await client.get("/readyz")
            ready = await r.json()
            r = await client.get("/debug/explain?path=" + quote(
                f"{BASE}?tile=0,0,0,48,40"))
            return ready, await r.json()

    out = {}
    for name, _ in _apps(_raw(str(data))):
        raw = dict(_raw(str(data)), slo={"latency-ms": 0.001},
                   telemetry={"slow-request-ms": 0.001,
                              "slow-request-dir": str(tmp_path / name / "s"),
                              "flight-recorder-dir": str(tmp_path / name
                                                         / "f"),
                              "profile-dir": str(tmp_path / "p")})
        build = dict(_apps(raw))[name]
        (jax_telemetry if name == "jax" else telemetry).reset()
        ready, explained = asyncio.run(session(build()))
        (slow,) = (tmp_path / name / "s").iterdir()
        waterfall = json.loads(slow.read_text())
        dumps = sorted(p.name for p in (tmp_path / name / "f").iterdir())
        out[name] = (ready, explained["pyramid_job"], sorted(waterfall),
                     waterfall["route"], waterfall["status"],
                     waterfall["prov"]["tier"], slow.name[:-5] ==
                     waterfall["trace_id"], [d.endswith("-slo-latency.json")
                                             for d in dumps])
    assert out["port"] == out["jax"]
    assert out["port"][0]["checks"]["slo"].startswith("BREACH latency")
    assert out["port"][1] == {"jobId": "pj-9", "state": "done",
                              "levelsDone": 2}
