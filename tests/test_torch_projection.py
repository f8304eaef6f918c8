"""Z-projection of the port against the JAX package.

``ops.projection``'s streamed projections, host and device placement (the
device fold is K7's plain version on the CPU), and ``project_stack`` are
held to the JAX host fold (``project_planes``, ``project_region_banded``
with ``placement="host"``, numpy) exactly (``array_equal``, NaN equal to
NaN): the device fold adds in z order one plane at a time, as the JAX
host fold of ``project_planes`` does, so the f32 results are equal for
every pixel type.  Against the JAX device fold (``project_stack``, XLA's
order) and ``refimpl.project_ref`` (float64) they are held on uint16
planes, where every partial sum is exact: exactly for max and sum, and
within one f32 ulp (``rtol=1.2e-7``) of the float64 mean.  Both default
apps answer ``p=`` requests alike, PNG and JPEG, also on the banded
branch and on a bounds error.  On a card, K7 equals its plain version.
"""

import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu import refimpl
from omero_ms_image_region_tpu.ops import projection as jax_projection
from omero_ms_image_region_tpu_torch.models.rendering import Projection
from omero_ms_image_region_tpu_torch.ops import projection

from torch_workload_apps import CH, IMG, cache_headers, exchange, write_tree

ALGS = [Projection.MAXIMUM_INTENSITY, Projection.MEAN_INTENSITY,
        Projection.SUM_INTENSITY]
# (start, end, stepping): the whole stack, a stepped window, a window of
# one plane (an empty mean/sum window), an odd window.
WINDOWS = [(0, 11, 1), (2, 9, 3), (4, 4, 1), (1, 10, 2)]
Z, H, W = 12, 20, 24


def _stack(dtype) -> np.ndarray:
    rng = np.random.default_rng(np.dtype(dtype).num)
    if dtype == np.float32:
        x = rng.normal(0, 1000, size=(Z, H, W)).astype(np.float32)
        x[3, 2, :] = np.nan                 # a NaN row in one plane
        return x
    if dtype == np.int32:
        return rng.integers(-1000, 100000, size=(Z, H, W)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=(Z, H, W),
                        endpoint=True).astype(dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    return t.numpy()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32,
                                   np.float32])
@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("window", WINDOWS)
def test_streamed_projection_matches_jax_host_fold(dtype, alg, window):
    stack = _stack(dtype)
    start, end, step = window
    tmax = 65535.0

    def get_plane(z):
        return stack[z]

    def get_band(z, y0, h):
        return stack[z, y0:y0 + h]

    want = np.asarray(jax_projection.project_planes(
        get_plane, alg, Z, start, end, step, tmax, shape=(H, W),
        placement="host"))
    for placement in ("host", "device"):
        got = _np(projection.project_planes(
            get_plane, alg, Z, start, end, step, tmax, shape=(H, W),
            placement=placement, z_chunk=5, device="cpu"))
        assert np.array_equal(got, want, equal_nan=True), placement
    # Banded, device placement: K7 into 7-row bands (the last one
    # aligned to H - 7), 3 planes a chunk.
    banded = _np(projection.project_region_banded(
        get_band, alg, Z, start, end, step, tmax, plane_shape=(H, W),
        band_rows=7, z_chunk=3, placement="device", device="cpu"))
    assert np.array_equal(banded, want, equal_nan=True)
    # Banded, host placement: the JAX banded host fold verbatim.
    want_banded = np.asarray(jax_projection.project_region_banded(
        get_band, alg, Z, start, end, step, tmax, plane_shape=(H, W),
        band_rows=7, z_chunk=3, placement="host"))
    assert np.array_equal(_np(projection.project_region_banded(
        get_band, alg, Z, start, end, step, tmax, plane_shape=(H, W),
        band_rows=7, z_chunk=3, placement="host", device="cpu")),
        want_banded, equal_nan=True)
    assert np.array_equal(_np(projection.project_stack(
        stack, alg, start, end, step, tmax, device="cpu")), want,
        equal_nan=True)


@pytest.mark.parametrize("alg", ALGS)
def test_projection_matches_jax_device_fold_and_refimpl(alg):
    """uint16 planes: the port equals the JAX ``project_stack`` and the
    JAX banded device fold (XLA's order) exactly, and ``refimpl
    .project_ref`` exactly for max and sum and within one f32 ulp for the
    mean."""
    stack = _stack(np.uint16)
    got = _np(projection.project_stack(stack, alg, 1, 10, 2, 65535.0,
                                       device="cpu"))
    np.testing.assert_array_equal(got, np.asarray(
        jax_projection.project_stack(stack, alg, 1, 10, 2, 65535.0)))
    np.testing.assert_array_equal(got, np.asarray(
        jax_projection.project_region_banded(
            lambda z, y0, h: stack[z, y0:y0 + h], alg, Z, 1, 10, 2,
            65535.0, plane_shape=(H, W), band_rows=8, z_chunk=4,
            placement="device")))
    ref = refimpl.project_ref(stack, alg, 1, 10, 2, 65535.0)
    if alg == Projection.MEAN_INTENSITY:
        np.testing.assert_allclose(got, ref, rtol=1.2e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, ref)


def test_bounds_checks_match_jax():
    for args in [(-1, 3, 1, 0, 0, 8, 3, 1), (0, 8, 1, 0, 0, 8, 3, 1),
                 (0, 3, 0, 0, 0, 8, 3, 1), (0, 3, 1, 0, 5, 8, 3, 1),
                 (0, 3, 1, 7, 0, 8, 3, 1)]:
        with pytest.raises(ValueError) as jax_err:
            jax_projection.check_projection_bounds(*args)
        with pytest.raises(ValueError, match=str(jax_err.value)):
            projection.check_projection_bounds(*args)
    stack = _stack(np.uint8)
    for bad in [(-1, 2, 1), (0, Z, 1), (0, 2, 0)]:
        with pytest.raises(ValueError) as jax_err:
            jax_projection.project_stack(stack, 0, *bad)
        with pytest.raises(ValueError, match=str(jax_err.value)):
            projection.project_stack(stack, 0, *bad, device="cpu")


def test_device_sources_fold_on_the_device():
    """``auto`` folds where the data lives: tensor planes take the device
    placement (K7's plain version here), with the host fold's result."""
    stack = _stack(np.uint16)
    planes = torch.from_numpy(stack.astype(np.int32)).to(torch.int32)
    got = _np(projection.project_planes(
        lambda z: planes[z], Projection.SUM_INTENSITY, Z, 0, 11,
        device="cpu", type_max=65535.0))
    np.testing.assert_array_equal(got, np.asarray(
        jax_projection.project_planes(lambda z: stack[z], 2, Z, 0, 11,
                                      type_max=65535.0, placement="host")))


PROJ = f"/webgateway/render_image_region/{IMG}/0/0?{CH}"
PROJECTION_REQUESTS = [
    ("GET", PROJ + "&format=png&p=intmax|0:3", {}),
    ("GET", PROJ + "&format=jpeg&p=intmax|0:3", {}),
    ("GET", PROJ + "&format=png&p=intmean|1:3&flip=h", {}),
    ("GET", PROJ + "&format=png&p=intsum", {}),
    ("GET", PROJ + "&format=png&p=intmax|0:3&tile=0,0,0,64,64", {}),
    ("GET", PROJ + "&format=png&p=intmax|0:9", {}),                # 500
    ("GET", PROJ + "&format=png&p=intmax|2:1", {}),
]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("projection")))


@pytest.fixture(scope="module")
def projection_answers(data_dir):
    return exchange({"data-dir": data_dir}, PROJECTION_REQUESTS)


@pytest.mark.parametrize("i", range(len(PROJECTION_REQUESTS)))
def test_projection_route_answers_as_jax(projection_answers, i):
    jax, port = projection_answers
    what = PROJECTION_REQUESTS[i]
    assert port[i][0] == jax[i][0], what
    assert port[i][2] == jax[i][2], what
    assert cache_headers(port[i][1]) == cache_headers(jax[i][1]), what


def test_projection_statuses(projection_answers):
    _, port = projection_answers
    assert [p[0] for p in port] == [200, 200, 200, 200, 200, 500, 200]
    assert port[1][2][:2] == b"\xff\xd8"


def test_projected_planes_are_cached_on_the_device(data_dir):
    """A repeat of a projection is a raw-cache hit on its ``proj`` keys
    (one per active channel)."""
    from omero_ms_image_region_tpu_torch.server.app import build_handler
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
    import asyncio

    handler = build_handler(data_dir, device="cpu")
    params = {"imageId": str(IMG), "theZ": "0", "theT": "0",
              "c": "1|0:60000$FF0000,2|0:60000$00FF00", "m": "c",
              "format": "png", "p": "intmean|0:3"}

    async def twice():
        ctx = ImageRegionCtx.from_params(params)
        first = await handler.render_image_region(ctx)
        hits = handler.s.raw_cache.hits
        second = await handler.render_image_region(
            ImageRegionCtx.from_params(dict(params, q="0.5")))
        await handler.s.renderer.close()
        return first, second, hits

    first, second, hits = asyncio.run(twice())
    assert first == second
    cache = handler.s.raw_cache
    assert cache.hits == hits + 2
    assert {k for k in cache._entries if k[0] == "proj"} == {
        ("proj", IMG, 0, c, 1, 0, 3) for c in (0, 1)}


def test_banded_branch_answers_as_jax(data_dir, monkeypatch):
    """Past the banding threshold both handlers project in row bands
    (forced low here, as ``tests/test_flip_projection.py`` does): the
    same bodies."""
    import omero_ms_image_region_tpu.server.handler as jax_handler
    import omero_ms_image_region_tpu_torch.server.handler as port_handler
    for mod in (jax_handler, port_handler):
        monkeypatch.setattr(mod, "_PROJECTION_BAND_THRESHOLD_BYTES", 1024)
        monkeypatch.setattr(mod, "_PROJECTION_BAND_BYTES", 32 * 256 * 4)
    requests = [("GET", PROJ + "&format=png&p=intmax|0:3", {}),
                ("GET", PROJ + "&format=png&p=intsum|1:3", {})]
    jax, port = exchange({"data-dir": data_dir}, requests)
    for j, p in zip(jax, port):
        assert (p[0], p[2]) == (j[0], j[2]) and p[0] == 200
    unbanded = exchange({"data-dir": data_dir}, requests[:1])[1]
    assert unbanded[0][2] == port[0][2]


@pytest.mark.cuda
def test_fold_kernel_matches_plain_on_the_card():
    """On a CUDA card: K7 equals its plain version for every pixel type,
    algorithm, a chunk folded onto earlier rows, a band at an offset and
    a ragged size (exact, NaN equal to NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from omero_ms_image_region_tpu_torch.kernels import workloads
    dev = torch.device("cuda")
    for dtype in (np.int8, np.uint8, np.int16, np.uint16, np.int32,
                  np.uint32, np.float32):
        for h, w, y0 in ((16, 64, 8), (7, 13, 3)):
            chunk = projection.stage_planes(_stack(dtype)[:6, :h, :w], dev)
            for alg in (0, 1, 2):
                got = torch.full((h + y0, w), 3.0, device=dev)
                want = got.clone()
                for out, fold in ((got, workloads.project_fold),
                                  (want, projection.fold_chunk_plain)):
                    fold(chunk[:4].contiguous(), out, y0, alg, True, False,
                         6, 65535.0)
                    fold(chunk[4:].contiguous(), out, y0, alg, False, True,
                         6, 65535.0)
                assert np.array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                      equal_nan=True), (dtype, h, alg)
