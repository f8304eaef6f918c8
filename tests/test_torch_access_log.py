"""The JSON access log, the cost ledger and provenance of the port against
the JAX package.

Both default apps, built from one config dict with the image-region cache
on (every JPEG region on the device route), take the same GETs: a JPEG
miss, its repeat (a byte-cache hit), a revalidation (304), an unknown
image (404) and a PNG miss.  Each request writes one JSON line to its
package's access logger (``omero_ms_image_region_tpu.access``,
``omero_ms_image_region_tpu_torch.access``); the lines' key sets and their
``route``, ``status``, ``bytes``, ``cache`` and provenance ``tier`` are
equal, and so is the key set of the PNG miss's cost ledger
(``telemetry.assemble_ledger``: its group renders before the request
answers, so every writer has written).  The provenance header echoes the
tier, and the cost histograms and provenance counters reach ``/metrics``.
"""

import asyncio
import json
import logging

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.server.app import (
    build_services, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.utils import telemetry

IMG = 7
C = "1|0:60000$FF0000,2|0:60000$00FF00"
URL = f"/webgateway/render_image_region/{IMG}/0/0"
JPEG = {"tile": "0,0,0,32,32", "c": C, "m": "c", "format": "jpeg"}
PNG = dict(JPEG, tile="0,1,0,32,32", format="png")
LOGGERS = ("omero_ms_image_region_tpu.access",
           "omero_ms_image_region_tpu_torch.access")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("access")
    planes = np.random.default_rng(12).integers(
        0, 60000, size=(2, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(json.loads(record.getMessage()))


async def _gets(client):
    """The GETs: (status, headers) each, in order."""
    r = await client.get(URL, params=JPEG)
    await r.read()
    out = [(r.status, dict(r.headers))]
    unknown = URL.replace(f"/{IMG}/", "/99/")
    for url, params, headers in (
            (URL, JPEG, {}), (URL, JPEG, {"If-None-Match": r.headers["ETag"]}),
            (unknown, JPEG, {}), (URL, PNG, {})):
        r = await client.get(url, params=params, headers=headers)
        await r.read()
        out.append((r.status, dict(r.headers)))
    return out


@pytest.fixture(scope="module")
def served(data_dir):
    """{package: (answers, access lines, /metrics text, the cost top-K,
    the provenance totals)}."""
    from aiohttp.test_utils import TestClient, TestServer

    raw = {"data-dir": data_dir, "renderer": {"cpu-fallback-max-px": 0},
           "watchdog": {"enabled": False}, "raw-cache": {"prefetch": False},
           "image-region-cache": {"enabled": True},
           "telemetry": {"provenance-header": True}}

    async def go(app):
        async with TestClient(TestServer(app)) as client:
            answers = await _gets(client)
            text = await (await client.get("/metrics")).text()
        return answers, text

    out = {}
    for name, build, module in (
            ("jax", lambda: jax_app(JaxConfig.from_dict(dict(raw))),
             jax_telemetry),
            ("port", lambda: create_app(
                AppConfig.from_dict(dict(raw)), "cpu",
                handler=ImageRegionHandler(build_services(
                    AppConfig.from_dict(dict(raw)), "cpu"))), telemetry)):
        module.reset()
        logger = logging.getLogger(LOGGERS[name == "port"])
        sink, level = _Lines(), logger.level
        logger.addHandler(sink)
        logger.setLevel(logging.INFO)
        try:
            answers, text = asyncio.run(go(build()))
        finally:
            logger.removeHandler(sink)
            logger.setLevel(level)
        out[name] = (answers, sink.lines, text, module.COST_TOPK.snapshot(),
                     module.PROVENANCE.totals())
    return out


def test_one_line_per_request_with_the_jax_keys(served):
    jax_answers, jax_lines = served["jax"][:2]
    answers, lines = served["port"][:2]
    assert [a[0] for a in answers] == [a[0] for a in jax_answers] == [
        200, 200, 304, 404, 200]
    assert len(lines) == len(jax_lines) == 5
    for mine, theirs in zip(lines, jax_lines):
        assert set(mine) == set(theirs)
        for key in ("route", "status", "bytes", "cache"):
            assert mine[key] == theirs[key], key
    assert set(lines[0]) == {"ts", "trace", "route", "status", "bytes",
                             "ms", "queue_ms", "render_ms", "encode_ms",
                             "cache", "cost", "prov"}
    assert [line["cache"] for line in lines] == [
        "render", "byte-cache", "render", "render", "render"]
    assert lines[0]["bytes"] == lines[1]["bytes"] > 0
    assert lines[2]["bytes"] == lines[3]["bytes"] == 0


def test_provenance_tiers_match_jax(served):
    tiers = {name: [line.get("prov", {}).get("tier") for line in got[1]]
             for name, got in served.items()}
    assert tiers["port"] == tiers["jax"] == [
        "render_cold", "byte_cache", "304", None, "render_cold"]
    answers, lines = served["port"][:2]
    for (status, headers), line in zip(answers, lines):
        value = headers.get("X-Image-Region-Provenance")
        if status >= 400:
            assert value is None
        else:
            assert value.startswith(f"tier={line['prov']['tier']}; ")
            assert f"trace={line['trace']}" in value


def test_a_miss_ledger_has_the_jax_keys(served):
    jax_lines, lines = served["jax"][1], served["port"][1]
    assert set(lines[4]["cost"]) == set(jax_lines[4]["cost"])
    assert {"device_ms", "stage_ms", "staged_bytes", "read_ms",
            "queue_ms", "encode_ms", "wire_bytes",
            "total_ms"} <= set(lines[4]["cost"])
    assert lines[4]["cost"]["wire_bytes"] == lines[4]["bytes"]


def test_top_k_and_provenance_totals_match_jax(served):
    """The cost top-K holds every traced request, most expensive first,
    in the JAX shape; the provenance counters count the successes by
    tier."""
    tops = served["jax"][3], served["port"][3]
    for top in tops:
        assert [d["total_ms"] for d in top] == sorted(
            (d["total_ms"] for d in top), reverse=True)
    assert [sorted(d) for d in tops[1]] == [sorted(d) for d in tops[0]]
    assert sorted(d["trace"] for d in tops[1]) == sorted(
        line["trace"] for line in served["port"][1])
    assert served["port"][4] == served["jax"][4] == {
        "render_cold": 2, "byte_cache": 1, "304": 1}


def test_cost_and_provenance_families_reach_metrics(served):
    def families(text):
        return {line.split("{")[0].split(" ")[0]
                for line in text.splitlines()
                if line.startswith(("imageregion_request_cost_",
                                    "imageregion_provenance_"))}
    mine, theirs = families(served["port"][2]), families(served["jax"][2])
    assert mine == theirs
    assert "imageregion_provenance_total" in mine
    assert "imageregion_request_cost_device_ms_bucket" in mine

