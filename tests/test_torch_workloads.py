"""The overlay and animation routes of the port against the JAX package.

Both default apps, built once from one config dict over the tree of
``torch_workload_apps``, answer the same ``render_overlay`` and
``render_animation`` requests with the same status, body (byte-equal:
every stage is integer or the same f32 render), ``ETag``,
``Cache-Control``, ``Vary`` and ``Content-Type``; an animation's frames
come in order, each the plain route's bytes for its plane.  A disabled
route answers 404 in both, ``OPTIONS`` lists the same features, and the
port's ``/metrics`` carries the JAX workload families with the same label
keys, within the repo's cardinality budget.  Closing an animation stream
cancels the frames not yet settled.
"""

import asyncio
import importlib.util
import os
import re

import pytest

from omero_ms_image_region_tpu_torch.server.handler import (
    WorkloadsHandler, frame_record)
from omero_ms_image_region_tpu_torch.utils import telemetry

from torch_workload_apps import (CH, IMG, cache_headers, exchange,
                                 frames_of, write_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERLAY = f"/webgateway/render_overlay/{IMG}/0/0?{CH}"
ANIMATION = f"/webgateway/render_animation/{IMG}/1/0?{CH}&format=jpeg"
REGION = f"/webgateway/render_image_region/{IMG}/{{z}}/0?{CH}&format=jpeg"
REQUESTS = [
    ("GET", OVERLAY + "&shapes=1,2", {}),
    ("GET", OVERLAY + "&shapes=2,1&color=FF00FF80", {}),
    ("GET", OVERLAY + "&shapes=1&flip=h&tile=0,0,0,256,256", {}),
    ("GET", OVERLAY + "&shapes=5", {"Cookie": "sessionid=someone"}),
    ("HEAD", OVERLAY + "&shapes=1,2", {}),
    ("GET", OVERLAY + "&shapes=1,3", {}),                     # 400 size
    ("GET", OVERLAY + "&shapes=1,99", {}),                    # 404
    ("GET", OVERLAY + "&shapes=5", {}),                       # 404 ACL
    ("GET", OVERLAY + "&shapes=", {}),                        # 400
    ("GET", OVERLAY + "&shapes=1,x", {}),                     # 400
    ("GET", OVERLAY + "&shapes=1&color=zz", {}),              # 400
    ("GET", ANIMATION + "&axis=z&frames=3", {}),
    ("GET", ANIMATION + "&axis=t&frames=1", {}),
    ("GET", ANIMATION + "&axis=z&frames=0", {}),              # 400
    ("GET", ANIMATION + "&axis=z&frames=5", {}),              # 400 cap
    ("GET", ANIMATION + "&axis=q", {}),                       # 400
    ("GET", ANIMATION + "&frames=two", {}),                   # 400
    ("GET", ANIMATION.replace(f"{IMG}/1/0", f"{IMG}/9/0")
     + "&axis=z&frames=2", {}),                               # 400 theZ
    ("OPTIONS", "/", {}),
] + [("GET", REGION.format(z=z), {}) for z in (1, 2, 3)] + [
    ("GET", "/metrics", {})]
STATUSES = [200, 200, 200, 200, 200, 400, 404, 404, 400, 400, 400,
            200, 200, 400, 400, 400, 400, 400, 200, 200, 200, 200, 200]
WORKLOAD_FAMILIES = ("imageregion_workload_requests_total",
                     "imageregion_animation_streams_total",
                     "imageregion_animation_frames_total",
                     "imageregion_animation_cancelled_total",
                     "imageregion_animation_first_frame_ms")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("workloads")))


@pytest.fixture(scope="module")
def answers(data_dir):
    raw = {"data-dir": data_dir, "session-store": {"type": "static"},
           "workloads": {"animation-max-frames": 4}}
    return exchange(raw, REQUESTS)


@pytest.mark.parametrize("i", range(len(REQUESTS) - 1))
def test_routes_answer_as_jax(answers, i):
    jax, port = answers
    what = REQUESTS[i]
    assert port[i][0] == jax[i][0] == STATUSES[i], what
    assert port[i][2] == jax[i][2], what
    assert cache_headers(port[i][1]) == cache_headers(jax[i][1]), what


def test_animation_frames_are_the_plain_route_in_order(answers):
    """``axis=z&frames=3`` from theZ 1: three ``FRME`` records, planes 1,
    2 and 3, each the bytes the plain route gives that plane."""
    _, port = answers
    frames = frames_of(port[11][2])
    plain = [port[REQUESTS.index(("GET", REGION.format(z=z), {}))][2]
             for z in (1, 2, 3)]
    assert frames == plain
    assert all(f[:2] == b"\xff\xd8" for f in frames)
    assert port[11][1]["Content-Type"] == \
        "application/x-image-region-animation"
    assert port[11][1]["Cache-Control"] == "no-store"
    assert "ETag" not in port[11][1]
    assert frame_record(b"ab") == b"FRME\x00\x00\x00\x02ab"


def test_overlay_has_no_last_modified_and_answers_304(answers, data_dir):
    _, port = answers
    assert "Last-Modified" not in port[0][1]
    etag = port[0][1]["ETag"]
    raw = {"data-dir": data_dir}
    jax, port = exchange(raw, [("GET", OVERLAY + "&shapes=1,2",
                                {"If-None-Match": etag})])
    assert port[0][0] == jax[0][0] == 304 and port[0][2] == b""


def test_options_features_match_jax(answers):
    jax, port = answers
    i = REQUESTS.index(("OPTIONS", "/", {}))
    import json
    assert json.loads(port[i][2])["features"] == \
        json.loads(jax[i][2])["features"] == ["flip", "mask-color",
                                              "png-tiles"]


def test_disabled_routes_answer_404(data_dir):
    raw = {"data-dir": data_dir,
           "workloads": {"overlay-enabled": False,
                         "animation-enabled": False}}
    requests = [("GET", OVERLAY + "&shapes=1", {}),
                ("GET", ANIMATION + "&axis=z&frames=2", {})]
    jax, port = exchange(raw, requests)
    assert [p[0] for p in port] == [j[0] for j in jax] == [404, 404]


_SERIES = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})? (\S+)$")


def _workload_series(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, labels, value = _SERIES.match(line).groups()
            if name in WORKLOAD_FAMILIES:
                keys = tuple(sorted(kv.split("=")[0] for kv in
                                    (labels or "").split(",") if kv))
                out[(name, keys, labels or "")] = float(value)
    return out


def test_metrics_carry_the_workload_families(answers):
    """After the sequence above, the port's scrape has the JAX workload
    families with the same label keys and the same counts (the mask
    kinds, overlays, streams and frames), and the repo's budget lint
    passes."""
    jax, port = answers
    mine = _workload_series(port[-1][2].decode())
    theirs = _workload_series(jax[-1][2].decode())
    first = ("imageregion_animation_first_frame_ms", (), "")
    assert mine.pop(first) > 0 and theirs.pop(first) > 0
    assert mine == theirs
    assert mine[("imageregion_workload_requests_total", ("kind",),
                 'kind="overlay"')] == 4
    assert mine[("imageregion_animation_frames_total", (), "")] == 4
    assert telemetry.METRIC_TYPES["imageregion_workload_requests_total"] \
        == "counter"
    spec = importlib.util.spec_from_file_location(
        "metrics_lint", os.path.join(REPO, "scripts", "metrics_lint.py"))
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                     delete=False) as f:
        f.write(port[-1][2].decode())
    try:
        assert lint.main([f.name]) == 0
    finally:
        os.unlink(f.name)


def test_closing_a_stream_cancels_the_unsettled_frames():
    """A client that leaves after frame 0: the frames still rendering are
    cancelled and the stream counts as cancelled."""
    started, cancelled = [], []

    class Images:
        s = None

        async def render_image_region(self, ctx):
            started.append(ctx)
            if ctx == 0:
                return b"zero"
            try:
                await asyncio.sleep(30)
            except asyncio.CancelledError:
                cancelled.append(ctx)
                raise

    async def run():
        handler = WorkloadsHandler.__new__(WorkloadsHandler)
        handler.image_handler, handler.max_frames = Images(), 8
        stream = handler.render_animation_stream([0, 1, 2])
        first = await stream.__anext__()
        await stream.aclose()
        return first

    telemetry.reset()
    assert asyncio.run(run()) == frame_record(b"zero")
    assert started == [0, 1, 2] and sorted(cancelled) == [1, 2]
    assert telemetry.WORKLOADS.stream_cancels == 1
    assert telemetry.WORKLOADS.frames == 1
