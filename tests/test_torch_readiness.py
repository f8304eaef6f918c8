"""``/readyz`` and the startup prewarm of the port against the JAX package.

Both default apps are built from one config dict over one small pyramid
and asked ``GET /readyz``; each answers with the same status and the same
checks (``prewarm``, ``queue`` and the perf sentinel's ``sentinel``
annotation):

* by default (200, ``complete``, ``ok``), and past
  ``telemetry.ready-max-queue-depth`` tiles queued (503, ``depth N over
  M``);
* while a ``renderer.prewarm`` is pending (each package's
  ``prewarm_renderer`` held on an event: 503 ``pending``), then done (200
  ``complete``).

``parse_spec`` accepts and refuses the specs JAX's does, with its values
and messages.  The port's own prewarm runs on the CPU (the native builds
and the plain versions of the serving kernels at every batch size), and a
failed launch keeps ``/readyz`` at 503 with the reason and is logged.
"""

import asyncio
import logging
import threading

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server import prewarm as jax_prewarm
from omero_ms_image_region_tpu.server.app import (
    SERVICES_KEY, create_app as jax_app)
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.ops import jpegenc
from omero_ms_image_region_tpu_torch.server import prewarm
from omero_ms_image_region_tpu_torch.server.app import (
    build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.utils import telemetry

IMG = 7


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("readiness")
    planes = np.random.default_rng(11).integers(
        0, 60000, size=(2, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


@pytest.fixture(autouse=True)
def _fresh():
    jax_telemetry.READINESS.reset()
    telemetry.READINESS.reset()
    yield
    jax_telemetry.READINESS.reset()
    telemetry.READINESS.reset()


def _config(data_dir, **sections) -> dict:
    return dict({"data-dir": data_dir, "watchdog": {"enabled": False},
                 "raw-cache": {"prefetch": False}}, **sections)


def _apps(raw: dict):
    """Factories of both default apps from ``raw``, each giving (the app,
    its batching renderer); an app's prewarm starts when it is built."""
    def jax():
        app = jax_app(JaxConfig.from_dict(dict(raw)))
        return app, app[SERVICES_KEY].renderer

    def port():
        handler = ImageRegionHandler(build_services(AppConfig.from_dict(
            dict(raw)), "cpu"))
        return (create_app(AppConfig.from_dict(dict(raw)), "cpu",
                           handler=handler), handler.s.renderer)
    return [jax, port]


def _readyz(app, steps):
    """``GET /readyz`` before each step and once after the last: a list
    of (status, body); a step is a callable run between two probes."""
    from aiohttp.test_utils import TestClient, TestServer

    async def go():
        out = []
        async with TestClient(TestServer(app)) as client:
            for step in list(steps) + [None]:
                r = await client.get("/readyz")
                out.append((r.status, await r.json()))
                if step is not None:
                    await asyncio.to_thread(step)
        return out
    return asyncio.run(go())


def test_readyz_by_default_and_over_the_queue_bound(data_dir):
    raw = _config(data_dir, telemetry={"ready-max-queue-depth": 3})
    answers = []
    for build in _apps(raw):
        app, renderer = build()

        def deepen(renderer=renderer):
            renderer.queue_depth = lambda: 4
        answers.append(_readyz(app, [deepen]))
    jax, port = answers
    assert port == jax
    assert port == [
        (200, {"status": "ready",
               "checks": {"prewarm": "complete", "queue": "ok",
                          "sentinel": "ok"}}),
        (503, {"status": "degraded",
               "checks": {"prewarm": "complete",
                          "queue": "depth 4 over 3", "sentinel": "ok"}})]


def test_readyz_while_the_prewarm_is_pending(data_dir, monkeypatch):
    """Each package's prewarm held on a gate: 503 ``pending`` in both
    until it ends, then 200 ``complete``."""
    raw = _config(data_dir, renderer={"prewarm": ["2x32"]})
    gate, ended = threading.Event(), threading.Event()

    def held(readiness):
        def run(specs, *args, **kwargs):
            assert list(specs) == ["2x32"]
            gate.wait(timeout=60)
            readiness.prewarm_pending = False
            ended.set()
        return run

    monkeypatch.setattr(jax_prewarm, "prewarm_renderer",
                        held(jax_telemetry.READINESS))
    monkeypatch.setattr(prewarm, "prewarm_renderer",
                        held(telemetry.READINESS))
    answers = []
    for build in _apps(raw):
        gate.clear()
        ended.clear()
        app, _ = build()

        def release():
            gate.set()
            assert ended.wait(timeout=60)
        answers.append(_readyz(app, [release]))
    jax, port = answers
    assert port == jax
    assert port == [
        (503, {"status": "degraded",
               "checks": {"prewarm": "pending", "queue": "ok",
                          "sentinel": "ok"}}),
        (200, {"status": "ready",
               "checks": {"prewarm": "complete", "queue": "ok",
                          "sentinel": "ok"}})]


@pytest.mark.parametrize("spec", [
    "4x1024", "3x512@90", "2x1024:uint8", " 4x1024 ", "1x16@100:float64",
    "64x8192@1:int8", "4x1000", "0x1024", "65x1024", "4x8208", "4x0",
    "4x1024@0", "4x1024@101", "4x1024:uint7", "4by1024", "", "4x1024@",
    "4x1024:UINT16",
])
def test_parse_spec_matches_jax(spec):
    try:
        want = jax_prewarm.parse_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            prewarm.parse_spec(spec)
        assert str(got.value) == str(e)
        with pytest.raises(ValueError):
            AppConfig.from_dict({"renderer": {"prewarm": [spec]}})
    else:
        assert prewarm.parse_spec(spec) == want


def _prewarmed(data_dir, monkeypatch, warm=None):
    """The port's app with ``renderer.prewarm: ["2x32"]`` at max-batch 2
    on the CPU, its prewarm run to its end: (its /readyz, the batch
    sizes render_batch_to_jpeg was called at)."""
    calls = []
    real = jpegenc.render_batch_to_jpeg

    def spy(raw, *args, **kwargs):
        calls.append((raw.shape[0], kwargs["engine"], kwargs["tune"]))
        return real(raw, *args, **kwargs)

    monkeypatch.setattr(jpegenc, "render_batch_to_jpeg", spy)
    if warm is not None:
        monkeypatch.setattr(prewarm, "_warm_one", warm)
    ended = threading.Event()
    run = prewarm.prewarm_renderer

    def tracked(*args, **kwargs):
        try:
            run(*args, **kwargs)
        finally:
            ended.set()

    monkeypatch.setattr(prewarm, "prewarm_renderer", tracked)
    raw = _config(data_dir, renderer={"prewarm": ["2x32"],
                                      "cpu-fallback-max-px": 0},
                  batcher={"max-batch": 2})
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(
        dict(raw)), "cpu"))
    assert ended.wait(timeout=120)
    app = create_app(AppConfig.from_dict(dict(raw)), "cpu", handler=handler)
    return _readyz(app, []), calls


def test_the_port_prewarm_launches_every_batch_size(data_dir, monkeypatch):
    answers, calls = _prewarmed(data_dir, monkeypatch)
    assert answers == [(200, {"status": "ready", "checks": {
        "prewarm": "complete", "queue": "ok", "sentinel": "ok"}})]
    assert calls == [(1, "sparse", False), (2, "sparse", False)]


def test_a_failed_prewarm_keeps_readyz_at_503(data_dir, monkeypatch,
                                               caplog):
    def broken(*args, **kwargs):
        raise RuntimeError("jpeg_coefficients launch failed: CUDA error "
                           "700\nmore detail")

    with caplog.at_level(logging.ERROR,
                         logger="omero_ms_image_region_tpu_torch"):
        answers, _ = _prewarmed(data_dir, monkeypatch, warm=broken)
    assert answers == [(503, {"status": "degraded", "checks": {
        "prewarm": "failed: RuntimeError: jpeg_coefficients launch "
                   "failed: CUDA error 700",
        "queue": "ok", "sentinel": "ok"}})]
    failed = [r for r in caplog.records if "prewarm failed" in r.message]
    assert failed and failed[0].exc_info is not None
