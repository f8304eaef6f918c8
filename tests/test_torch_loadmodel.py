"""The port's open-loop load model against the JAX package's.

``services.loadmodel`` is pure Python arithmetic in both packages, so the
port is held to JAX exactly: the event stream of every seed and config of
the sweep, field for field (each ``Arrival`` compared as the tuple of its
fields), ``schedule`` and ``window`` at target rates, ``from_config`` over
both loaders' ``loadmodel`` block, the validation messages, ``find_knee``
over a table of curves, the ``DiurnalEstimator``'s fit, amplitude, phase
and multiplier on the same arrival times with tolerance 0, and the two
runners' reports and ``imageregion_loadmodel_*`` lines over one scripted
service (sheds raised as each package's ``OverloadedError``).  The wide
sweep of seeds is marked ``slow``.
"""

import asyncio
import dataclasses
import math
import random

import pytest

from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.server.errors import (
    OverloadedError as JaxOverloaded)
from omero_ms_image_region_tpu.services import loadmodel as jax_lm
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.errors import OverloadedError
from omero_ms_image_region_tpu_torch.services import loadmodel
from omero_ms_image_region_tpu_torch.utils import telemetry

PACKAGES = {"jax": (jax_lm, jax_telemetry, JaxOverloaded),
            "port": (loadmodel, telemetry, OverloadedError)}


@pytest.fixture(autouse=True)
def _fresh():
    jax_telemetry.reset()
    telemetry.reset()
    yield
    jax_telemetry.reset()
    telemetry.reset()


def _tuples(arrivals):
    return [dataclasses.astuple(a) for a in arrivals]


CONFIGS = {
    "default": {},
    "flat": {"diurnal_amplitude": 0.0},
    "mix": {"bulk_fraction": 0.05, "mask_fraction": 0.03,
            "pyramid_fraction": 0.02, "animation_fraction": 0.04},
    "zoom": {"zoom_fraction": 0.4, "max_level": 3},
    "skew": {"skew": 1.7, "image_population": 50},
    "uniform-images": {"skew": 0.0, "image_population": 9},
    "tails": {"think_time_median_ms": 90.0, "think_time_sigma": 1.6,
              "session_length_median": 6.0, "session_length_sigma": 0.3},
    "small-grid": {"grid": 1, "duration_s": 7.5},
}


def _pair(seed, **kw):
    args = dict(viewers=60, seed=seed, duration_s=30.0, grid=8)
    args.update(kw)
    return jax_lm.LoadModel(**args), loadmodel.LoadModel(**args)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1234])
def test_event_streams_equal_jax(name, seed):
    jax, port = _pair(seed, **CONFIGS[name])
    events = _tuples(jax.events())
    assert len(events) > 100
    assert _tuples(port.events()) == events
    assert port.natural_rate_tps() == jax.natural_rate_tps()
    # Rescaled replays of the same stream.
    for tps in (3.0, 250.0):
        assert _tuples(port.schedule(tps)) == _tuples(jax.schedule(tps))
    n = len(events)
    for tps, window_s in ((0.3 * n / 2.0, 2.0), (0.9 * n / 10.0, 10.0),
                          (1.0, 0.5)):
        assert (_tuples(port.window(tps, window_s))
                == _tuples(jax.window(tps, window_s)))


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(40))
def test_event_streams_equal_jax_over_many_seeds(seed):
    rng = random.Random(seed)
    kw = {"bulk_fraction": rng.choice((0.0, 0.1)),
          "mask_fraction": rng.choice((0.0, 0.05)),
          "zoom_fraction": rng.random() * 0.5, "max_level": rng.randrange(4),
          "skew": rng.random() * 2.5,
          "image_population": rng.choice((1, 3, 200)),
          "diurnal_amplitude": rng.random() * 0.95,
          "grid": rng.randrange(1, 20)}
    jax, port = _pair(seed, viewers=rng.randrange(1, 400), **kw)
    assert _tuples(port.events()) == _tuples(jax.events())


def test_the_autoscale_drill_stream_equals_jax():
    """The arrivals ``chip_smoke.py``'s ``autoscale:`` phase replays."""
    args = dict(seed=1234, viewers=200, grid=8, max_level=0,
                bulk_fraction=0.0)
    jax, port = jax_lm.LoadModel(**args), loadmodel.LoadModel(**args)
    natural = jax.events()
    assert _tuples(port.events()) == _tuples(natural)
    for tps, window_s in ((63.54, 10.0), (6.354, 10.0)):
        assert (_tuples(port.window(tps, window_s))
                == _tuples(jax.window(tps, window_s, natural)))


@pytest.mark.parametrize("block", [
    {},
    {"seed": 99, "viewers": 500, "skew": 2.0, "image-population": 30,
     "bulk-fraction": 0.1, "mask-fraction": 0.1, "zoom-fraction": 0.2,
     "think-time-median-ms": 120, "diurnal-amplitude": 0.0},
])
def test_from_config_equals_jax(block):
    jax = jax_lm.LoadModel.from_config(
        JaxConfig.from_dict({"loadmodel": block}).loadmodel,
        duration_s=20.0, grid=6, max_level=2)
    port = loadmodel.LoadModel.from_config(
        AppConfig.from_dict({"loadmodel": block}).loadmodel,
        duration_s=20.0, grid=6, max_level=2)
    for name in vars(jax):
        assert getattr(port, name) == getattr(jax, name), name
    jax.viewers = port.viewers = 80         # a short stream to compare
    assert _tuples(port.events()) == _tuples(jax.events())


@pytest.mark.parametrize("kw", [
    {"viewers": 0}, {"duration_s": 0}, {"grid": 0},
    {"think_time_median_ms": 0}, {"session_length_sigma": -1},
    {"diurnal_amplitude": 1.0}, {"zoom_fraction": 1.5},
    {"bulk_fraction": 0.7, "mask_fraction": 0.7}, {"skew": -0.1},
    {"image_population": 0},
])
def test_validation_equals_jax(kw):
    errors = []
    for mod in (jax_lm, loadmodel):
        with pytest.raises(ValueError) as e:
            mod.LoadModel(**kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    jax, port = _pair(1)
    for call in (lambda m: m.schedule(0), lambda m: m.window(5.0, 0),
                 lambda m: m.window(1e6, 10.0)):
        messages = []
        for model in (jax, port):
            with pytest.raises(ValueError) as e:
                call(model)
            messages.append(str(e.value))
        assert messages[0] == messages[1]


CURVES = [
    [],
    [{"offered_tps": 10, "p99_ms": 20, "shed_rate": 0.0},
     {"offered_tps": 20, "p99_ms": 40, "shed_rate": 0.0},
     {"offered_tps": 40, "p99_ms": 90, "shed_rate": 0.01},
     {"offered_tps": 80, "p99_ms": 400, "shed_rate": 0.2}],
    [{"offered_tps": 10, "p99_ms": 20}, {"offered_tps": 20, "p99_ms": 30}],
    [{"offered_tps": 5, "p99_ms": 500, "shed_rate": 0.0},
     {"offered_tps": 6, "p99_ms": 10, "shed_rate": 0.0}],
    [{"offered_tps": 5, "p99_ms": 10, "shed_rate": 0.2},
     {"offered_tps": 10, "p99_ms": 10, "shed_rate": 0.0}],
    [{"offered_tps": 5, "p99_ms": None, "shed_rate": 0.0}],
    [{"offered_tps": 5.5, "p99_ms": 99.9, "shed_rate": 0.05},
     {"offered_tps": 7, "p99_ms": 100.0, "shed_rate": 0.0},
     {"offered_tps": 9, "p99_ms": 100.1, "shed_rate": 0.0},
     {"offered_tps": 11, "p99_ms": 20, "shed_rate": 0.0}],
]


@pytest.mark.parametrize("curve", range(len(CURVES)))
@pytest.mark.parametrize("slo_ms, max_shed", [(100.0, 0.05), (50.0, 0.0)])
def test_find_knee_equals_jax(curve, slo_ms, max_shed):
    points = CURVES[curve]
    assert (loadmodel.find_knee(points, slo_ms, max_shed)
            == jax_lm.find_knee(points, slo_ms, max_shed))


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _arrival_times(seed, period, n, amplitude):
    """Arrival times of a half-sine day repeated, thinned by a seeded
    draw."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        t = rng.random() * 2 * period
        if rng.random() < (1 + amplitude * math.sin(
                2 * math.pi * t / period)) / (1 + amplitude):
            out.append(t)
    return sorted(out)


@pytest.mark.parametrize("seed, amplitude", [(3, 0.6), (4, 0.0),
                                             (5, 0.95)])
def test_diurnal_fit_and_multiplier_equal_jax(seed, amplitude):
    period = 600.0
    estimators = []
    for mod in (jax_lm, loadmodel):
        clock = _Clock()
        est = mod.DiurnalEstimator(period_s=period, clock=clock)
        estimators.append((est, clock))
    times = _arrival_times(seed, period, 6000, amplitude)
    readings = [[], []]
    for i, t in enumerate(times):
        for k, (est, clock) in enumerate(estimators):
            clock.t = t
            est.observe()
            if i % 250 == 0:
                readings[k].append((est.multiplier(horizon_s=30.0),
                                    est.multiplier(at=t + 77.0)))
    for k, (est, clock) in enumerate(estimators):
        clock.t = times[-1] + period / 10
        readings[k] += [est.fit(), est.amplitude, est.phase_s,
                        est.multiplier(), len(est._bins)]
    assert readings[1] == readings[0]
    assert readings[0][-5] is not None          # the day was fitted


def test_diurnal_unfit_and_bounds_equal_jax():
    out = []
    for mod in (jax_lm, loadmodel):
        clock = _Clock(10.0)
        est = mod.DiurnalEstimator(period_s=100.0, bin_s=5.0, clock=clock)
        row = [est.multiplier(), est.fit(), est.max_bins]
        for t in (11.0, 12.0, 90.0, 91.0, 250.0, 410.0, 415.0):
            est.observe(t)
        clock.t = 420.0
        row += [est.fit(), est.multiplier(), sorted(est._bins.items())]
        est.reset()
        row += [est.multiplier(), est._bins]
        for bad in ({"period_s": 0}, {"period_s": 10, "bin_s": -1}):
            with pytest.raises(ValueError) as e:
                mod.DiurnalEstimator(**bad)
            row.append(str(e.value))
        out.append(row)
    assert out[1] == out[0]


def _run(pkg, closed):
    """Each package's runner over one scripted service: every 7th
    arrival shed, every 11th a bare failure, the rest served after
    yielding to the loop."""
    mod, tel, overloaded = PACKAGES[pkg]
    model = mod.LoadModel(viewers=40, seed=9, duration_s=5.0, grid=4,
                          bulk_fraction=0.1, mask_fraction=0.1)
    arrivals = model.window(400.0, 0.2)

    async def submit(arrival):
        k = arrival.step + int(arrival.session.rsplit("-", 1)[1])
        await asyncio.sleep(0)
        if k % 7 == 0:
            raise overloaded("shed")
        if k % 11 == 0:
            raise RuntimeError(f"boom {k}")
        return b"ok"

    runner = (mod.run_closed_loop(submit, arrivals, concurrency=4)
              if closed else mod.run_open_loop(submit, arrivals))
    report = asyncio.run(runner)
    lines = [line for line in tel.LOADMODEL.metric_lines()
             if "late_fires" not in line]
    return ({cls: len(v) for cls, v in report.latencies_ms.items()},
            report.served, report.sheds, sorted(report.errors),
            report.shed_rate(), lines)


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_runners_report_and_count_alike(closed):
    jax, port = _run("jax", closed), _run("port", closed)
    assert port == jax
    served, sheds, errors = port[1], port[2], port[3]
    assert served and sheds and errors
    assert any("imageregion_loadmodel_shed_total" in line
               for line in port[5])


def test_open_loop_fires_on_schedule_past_a_slow_service():
    """A service slower than the schedule changes nothing about when the
    next arrival fires (the port's runner alone: the timing is the
    host's)."""
    arrivals = [loadmodel.Arrival(t=0.02 * i, session=f"s-{i}",
                                  cls="interactive", step=0)
                for i in range(20)]
    fired = []

    async def submit(arrival):
        fired.append(asyncio.get_running_loop().time())
        await asyncio.sleep(0.3)

    async def main():
        t0 = asyncio.get_running_loop().time()
        report = await loadmodel.run_open_loop(submit, arrivals)
        return report, [t - t0 for t in fired]

    report, offsets = asyncio.run(main())
    assert report.served == 20 and report.errors == []
    # All 20 fired inside the first ~0.4 s although each takes 0.3 s.
    assert offsets[-1] < 0.38 + 0.1
    assert report.window_s >= 0.3
