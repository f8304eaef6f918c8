"""Admission and the watchdog of the port against the JAX package.

The cases of ``tests/test_faulttolerance.py`` and ``tests/test_watchdog.py``
that apply to a combined app without sessions, run through both default
apps built from one config dict, with one injected schedule (the config's
``fault-injection`` block: a seeded lane freeze).  Each gives the same
statuses, ``Retry-After`` values, shed and watchdog series in both:

* a shed at the admission bound, while a coalesced follower of the
  admitted request claims no slot;
* a deadline shed from the service-time estimate;
* a stuck group requeued and served with the direct route's bytes;
* a second stall escalated to a 503;
* with no injector, no watchdog event.

The controller's own contract (bound, deadline shed, EWMA) is held to the
JAX controller directly.
"""

import asyncio
import time

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server import admission as jax_admission
from omero_ms_image_region_tpu.server import watchdog as jax_watchdog
from omero_ms_image_region_tpu.server.app import (
    SERVICES_KEY, create_app as jax_app)
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.server.errors import (
    OverloadedError as JaxOverloaded)
from omero_ms_image_region_tpu.utils import faultinject as jax_faults
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu.utils import transient as jax_transient
from omero_ms_image_region_tpu_torch.server import admission
from omero_ms_image_region_tpu_torch.server import app as port_app
from omero_ms_image_region_tpu_torch.server.app import (
    build_handler, build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.server.errors import OverloadedError
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.utils import faultinject, telemetry
from omero_ms_image_region_tpu_torch.utils import transient

IMG = 7
FREEZE_MS = 600.0
C = "1|0:60000$FF0000,2|0:60000$00FF00"
URL = f"/webgateway/render_image_region/{IMG}/0/0"


def _query(x: int) -> dict:
    return {"tile": f"0,{x},0,32,32", "c": C, "m": "c", "format": "jpeg"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("front")
    planes = np.random.default_rng(8).integers(
        0, 60000, size=(2, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


@pytest.fixture(autouse=True)
def _fresh():
    yield
    faultinject.uninstall()
    jax_faults.uninstall()


def _config(data_dir, freeze_max=0, **sections) -> dict:
    raw = {"data-dir": data_dir, "renderer": {"cpu-fallback-max-px": 0},
           "watchdog": {"enabled": False}}
    if freeze_max:
        raw["fault-injection"] = {"seed": 1, "freeze-rate": 1.0,
                                  "freeze-ms": FREEZE_MS,
                                  "freeze-max": freeze_max}
    raw.update(sections)
    return raw


async def _until(cond, what: str, timeout_s: float = 30.0) -> None:
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout_s, what
        await asyncio.sleep(0.01)


async def _scenario(client, admission_of, ewma_s):
    """A cold GET whose group freezes (admitted; its identical twin
    coalesces onto it), then, while it holds its slot, a distinct GET."""
    if ewma_s is not None:
        admission_of().ewma_s = ewma_s
    first = [asyncio.ensure_future(client.get(URL, params=_query(0)))
             for _ in range(2)]
    await _until(lambda: admission_of().inflight >= 1, "never admitted")
    other = await client.get(URL, params=_query(1))
    out = [other] + [await f for f in first]
    return [(r.status, r.headers.get("Retry-After"), await r.read())
            for r in out]


def _series(text: str, family: str) -> dict:
    return {line.rsplit(" ", 1)[0]: line.rsplit(" ", 1)[1]
            for line in text.splitlines() if line.startswith(family)}


async def _stalled(client, watchdogs, heals):
    """One GET; the watchdog (whose own cadence never comes) is ticked
    until it has fired ``heals`` times, the first on the frozen group."""
    get = asyncio.ensure_future(client.get(URL, params=_query(0)))
    fired = []
    for n in range(1, heals + 1):
        def fire(n=n):
            fired.extend(watchdogs[-1].tick())
            return len(fired) >= n
        await _until(fire, "the watchdog never fired")
    r = await get
    return [(r.status, r.headers.get("Retry-After"), await r.read())]


def _both(raw: dict, ewma_s=None, heals=None, monkeypatch=None):
    """The scenario (or, with ``heals``, one GET under a ticked watchdog)
    through both apps: their answers, and their shed and watchdog
    series."""
    from aiohttp.test_utils import TestClient, TestServer

    watchdogs = []
    if heals is not None:
        for module in (jax_watchdog, port_app):
            def capture(*args, _build=module.build_watchdog, **kwargs):
                watchdogs.append(_build(*args, **kwargs))
                return watchdogs[-1]
            monkeypatch.setattr(module, "build_watchdog", capture)

    async def run(app, admission_of):
        async with TestClient(TestServer(app)) as client:
            if heals is not None:
                answers = await _stalled(client, watchdogs, heals)
            else:
                answers = await _scenario(client, admission_of, ewma_s)
            text = await (await client.get("/metrics")).text()
        return answers, {f: _series(text, f) for f in (
            "imageregion_shed_total", "imageregion_watchdog_fires_total")}

    out = []
    jax_telemetry.reset()
    app = jax_app(JaxConfig.from_dict(dict(raw)))
    out.append(asyncio.run(run(app, lambda: app[SERVICES_KEY].admission)))
    jax_faults.uninstall()
    telemetry.reset()
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(
        dict(raw)), "cpu"))
    out.append(asyncio.run(run(
        create_app(AppConfig.from_dict(dict(raw)), "cpu", handler=handler),
        lambda: handler.s.admission)))
    return out


def _direct_body(data_dir, x=0) -> bytes:
    handler = build_handler(data_dir, device="cpu", jpeg_host_max_px=0,
                            batcher=False)
    return asyncio.run(handler.render_image_region(
        ImageRegionCtx.from_params(dict(_query(x), imageId=str(IMG),
                                        theZ="0", theT="0"))))


def test_shed_at_the_bound_and_a_follower_claims_no_slot(data_dir):
    raw = _config(data_dir, freeze_max=1, **{"fault-tolerance": {
        "admission-max-queue": 1, "shed-retry-after-s": 2.6}})
    (jax, jax_series), (port, port_series) = _both(raw)
    statuses = [(s, ra) for s, ra, _ in port]
    assert statuses == [(s, ra) for s, ra, _ in jax]
    assert statuses == [(503, "3"), (200, None), (200, None)]
    assert port[1][2] == port[2][2] == jax[1][2]
    assert port_series == jax_series
    assert port_series["imageregion_shed_total"] == {
        'imageregion_shed_total{reason="queue-full"}': "1"}


def test_deadline_shed_from_the_service_time_estimate(data_dir):
    """One render in flight with a taught 40 s service time over 2 lanes:
    a request with a 20 s budget is shed with Retry-After 20."""
    raw = _config(data_dir, freeze_max=1, **{"fault-tolerance": {
        "request-deadline-ms": 20000}})
    (jax, jax_series), (port, port_series) = _both(raw, ewma_s=40.0)
    statuses = [(s, ra) for s, ra, _ in port]
    assert statuses == [(s, ra) for s, ra, _ in jax]
    assert statuses == [(503, "20"), (200, None), (200, None)]
    assert port_series == jax_series
    assert port_series["imageregion_shed_total"] == {
        'imageregion_shed_total{reason="deadline"}': "1"}


@pytest.mark.parametrize("freeze_max, want", [
    (0, (200, {})),
    (1, (200, {'imageregion_watchdog_fires_total{action="requeue-group"}':
               "1"})),
    (2, (503, {'imageregion_watchdog_fires_total{action="escalate"}': "1",
               'imageregion_watchdog_fires_total{action="requeue-group"}':
               "1"})),
])
def test_watchdog_requeues_then_escalates(data_dir, freeze_max, want,
                                          monkeypatch):
    """A frozen group is requeued and served by a healthy dispatch with
    the direct route's bytes; frozen again, it escalates to a 503; with
    no injector nothing fires.  The test ticks the watchdog (its own
    cadence is an hour), so a slow host cannot add a fire."""
    raw = _config(data_dir, freeze_max=freeze_max, watchdog={
        "interval-s": 3600, "stall-min-s": 0.2})
    (jax, jax_series), (port, port_series) = _both(
        raw, heals=freeze_max, monkeypatch=monkeypatch)
    assert (port[0][0], port[0][1]) == (jax[0][0], jax[0][1])
    assert port_series == jax_series
    status, fires = want
    assert port[0][0] == status
    assert port_series["imageregion_watchdog_fires_total"] == fires
    if status == 200:
        assert port[0][2] == jax[0][2] == _direct_body(data_dir)
    else:
        assert port[0][1] == "1"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_admission_controller_contract(pkg):
    """``tests/test_faulttolerance.py::TestAdmission``, on both
    controllers."""
    ctl, err, scope = (
        (jax_admission.AdmissionController, JaxOverloaded,
         jax_transient.deadline_scope) if pkg == "jax" else
        (admission.AdmissionController, OverloadedError,
         transient.deadline_scope))
    adm = ctl(max_queue=2, retry_after_s=1.5)
    t1, t2 = adm.admit(), adm.admit()
    with pytest.raises(err) as ei:
        adm.admit()
    assert ei.value.retry_after_s >= 1.5 and adm.shed_total == 1
    adm.release(t1, completed=False)
    assert adm.ewma_s is None          # a failure teaches nothing
    adm.release(t2)
    assert adm.inflight == 0 and adm.ewma_s is not None
    t = adm.admit()
    adm.ewma_s = 0.1                   # 100 ms service, one in flight
    with scope(5.0):
        with pytest.raises(err):
            adm.admit()
    with scope(5000.0):
        adm.release(adm.admit(), completed=False)
    adm.release(t)
    assert (adm.admitted_total, adm.shed_total) == (4, 2)
