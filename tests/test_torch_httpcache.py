"""Conditional HTTP of the port against the JAX package.

Each ported ``server/httpcache.py`` function is held to the JAX one on the
same inputs, and both default apps, built from one config dict over one
pyramid the test writes, answer the same requests with the same status,
body, ``ETag``, ``Cache-Control``, ``Vary`` and ``Last-Modified``: a
matching ``If-None-Match`` and an ``If-Modified-Since`` alone are 304s with
no body (and no render in the port), a HEAD is the 200's headers with no
body, and no error carries cache headers.  The JAX app streams its 200s in
chunks and the port sends one body; the bytes are the same.
"""

import asyncio
import json

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server import httpcache as jax_hc
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.server import httpcache as hc
from omero_ms_image_region_tpu_torch.server.app import (
    build_services, conditional_answer, create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)
from omero_ms_image_region_tpu_torch.utils import telemetry

IMG, PRIVATE = 7, 8
QUERY = ("tile=0,0,0,32,32&format=png&c=1|0:60000$FF0000,"
         "2|0:60000$00FF00&m=c")
URL = f"/webgateway/render_image_region/{IMG}/0/0/?{QUERY}"
CACHE_HEADERS = ("ETag", "Cache-Control", "Vary", "Last-Modified")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("httpcache")
    planes = np.random.default_rng(5).integers(
        0, 60000, size=(2, 1, 64, 64)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32),
                  n_levels=1)
    build_pyramid(planes, str(root / str(PRIVATE)), chunk=(32, 32),
                  n_levels=1)
    (root / str(PRIVATE) / "acl.json").write_text(
        json.dumps({"sessions": ["someone"]}))
    return str(root)


@pytest.mark.parametrize("name, args", [
    ("etag_for", ("abc123", "0")),
    ("etag_for", ("abc123", "m1700000000")),
    ("if_none_match_matches", ('"ir1-0-x", W/"ir1-0-y"', '"ir1-0-y"')),
    ("if_none_match_matches", ("*", '"ir1-0-y"')),
    ("if_none_match_matches", ('"other"', '"ir1-0-y"')),
    ("if_none_match_matches", (None, '"ir1-0-y"')),
    ("cache_headers", (0, False)),
    ("cache_headers", (0, True)),
    ("cache_headers", (600, True, "Authorization")),
    ("last_modified_basis", (1700000000.5, "0")),
    ("last_modified_basis", (1700000000.5, "m1800000000")),
    ("last_modified_basis", (1700000000.5, "release-7")),
    ("last_modified_basis", (None, "0")),
    ("http_date", (1700000000.0,)),
    ("parse_http_date", ("Tue, 14 Nov 2023 22:13:20 GMT",)),
    ("parse_http_date", ("not a date",)),
    ("not_modified_since", ("Tue, 14 Nov 2023 22:13:20 GMT",
                            1700000000.9)),
    ("not_modified_since", ("Tue, 14 Nov 2023 22:13:19 GMT",
                            1700000000.0)),
])
def test_httpcache_functions_match_jax(name, args):
    assert getattr(hc, name)(*args) == getattr(jax_hc, name)(*args)


def test_derive_epoch_matches_jax(data_dir, tmp_path):
    assert hc.derive_epoch(data_dir) == jax_hc.derive_epoch(data_dir)
    assert hc.derive_epoch(str(tmp_path / "none")) == "0"


def _exchange(raw: dict, requests):
    """Each ``(method, url, headers)`` through the JAX default app and the
    port's, both built from ``raw``.  Returns both apps' answers as
    ``(status, headers, body)`` and the port batcher's (groups, tiles)
    before and after each request."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run_through(app, probe=None):
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, url, headers in requests:
                before = probe() if probe else None
                r = await client.request(method, url, headers=headers)
                out.append((r.status, r.headers, await r.read(), before,
                            probe() if probe else None))
        return out

    jax_telemetry.reset()
    telemetry.reset()
    jax = asyncio.run(run_through(jax_app(JaxConfig.from_dict(dict(raw)))))
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(
        dict(raw)), "cpu"))
    b = handler.s.renderer

    def counters():
        return b.batches_dispatched, b.tiles_rendered
    port = asyncio.run(run_through(
        create_app(AppConfig.from_dict(dict(raw)), "cpu", handler=handler),
        counters))
    return jax, port


def _cache_headers(headers) -> dict:
    return {k: headers.get(k) for k in CACHE_HEADERS}


def test_default_apps_answer_alike(data_dir):
    raw = {"data-dir": data_dir, "session-store": {"type": "static"}}
    first = _exchange(raw, [("GET", URL, {})])
    etag = first[0][0][1]["ETag"]
    lm = first[0][0][1]["Last-Modified"]
    assert etag.startswith('"ir1-0-') and lm
    private = (f"/webgateway/render_image/{PRIVATE}/0/0?{QUERY}")
    requests = [
        ("GET", URL, {}),
        ("GET", URL, {"If-None-Match": etag}),
        ("GET", URL, {"If-Modified-Since": lm}),
        ("GET", URL, {"If-None-Match": '"stale"'}),
        ("HEAD", URL, {}),
        ("GET", private, {"Cookie": "sessionid=someone"}),
        ("GET", private, {}),                           # 404
        ("GET", f"/webgateway/render_image/99/0/0?{QUERY}", {}),  # 404
        ("GET", f"/webgateway/render_image/{IMG}/9/0?{QUERY}", {}),  # 400
    ]
    jax, port = _exchange(raw, requests)
    for (method, url, headers), j, p in zip(requests, jax, port):
        what = f"{method} {url} {headers}"
        assert p[0] == j[0], what
        assert p[2] == j[2], what
        assert _cache_headers(p[1]) == _cache_headers(j[1]), what
    statuses = [p[0] for p in port]
    assert statuses == [200, 304, 304, 200, 200, 200, 404, 404, 400]
    # The 304s and the HEAD have no body and cost the port no render.
    for i in (1, 2, 4):
        assert port[i][2] == b""
        assert port[i][3] == port[i][4], requests[i]
    assert port[0][3] != port[0][4]            # the first GET rendered
    assert port[5][1]["Cache-Control"] == "private, no-cache"
    assert port[5][1]["Vary"] == "Cookie"
    for p in port[6:]:
        assert all(k not in p[1] for k in CACHE_HEADERS)


@pytest.mark.parametrize("raw", [
    {"http-cache": {"epoch": "auto"}},
    {"http-cache": {"epoch": "release-7", "max-age-s": 60}},
    {"cache-control-header": "private, max-age=3600"},
    {"http-cache": {"enabled": False},
     "cache-control-header": "public, max-age=60"},
])
def test_cache_settings_give_the_jax_headers(data_dir, raw):
    raw = dict(raw, **{"data-dir": data_dir})
    jax, port = _exchange(raw, [("GET", URL, {}), ("HEAD", URL, {})])
    for j, p in zip(jax, port):
        assert (p[0], p[2]) == (j[0], j[2])
        assert _cache_headers(p[1]) == _cache_headers(j[1])
    if raw.get("http-cache", {}).get("epoch") == "auto":
        assert port[0][1]["ETag"].startswith(
            f'"ir1-{hc.derive_epoch(data_dir)}-')


def test_conditional_answer_is_a_plain_decision():
    etag = hc.etag_for("k")
    lm = hc.http_date(1700000000)
    assert conditional_answer({"If-None-Match": etag}, "GET", etag,
                              1700000000.0) == 304
    # The ETag wins over If-Modified-Since when both are sent.
    assert conditional_answer({"If-None-Match": '"x"',
                               "If-Modified-Since": lm}, "GET", etag,
                              1700000000.0) is None
    assert conditional_answer({"If-Modified-Since": lm}, "GET", etag,
                              1700000000.0) == 304
    assert conditional_answer({"If-Modified-Since": lm}, "GET", etag,
                              1700000001.0) is None
    assert conditional_answer({}, "HEAD", etag, None) == 200
    assert conditional_answer({}, "GET", etag, None) is None
