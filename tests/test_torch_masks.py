"""Shape masks of the port against the JAX package.

The port's ``ops.maskops`` device functions (their plain versions on the
CPU) are held to the JAX ``rasterize_packed_batch``, ``rasterize_mask``,
``overlay_masks_batch`` and ``_overlay_batch_jit`` on the same seeded
payloads, exactly (``array_equal``: every stage is integer).  A mask the
JAX ``write_mask`` wrote is read back equal by the port's ``get_mask``.
Both default apps, built once from one config dict, answer the same
``render_shape_mask`` requests with the same status, body, ``ETag``,
``Cache-Control``, ``Vary`` and ``Content-Type``; the port's batcher
groups same-shape masks into one launch.  On a card, K8a and K8b equal
their plain versions byte for byte.
"""

import asyncio

import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu.ops import maskops as jax_maskops
from omero_ms_image_region_tpu.models.mask import Mask as JaxMask
from omero_ms_image_region_tpu_torch.models.mask import Mask
from omero_ms_image_region_tpu_torch.ops import maskops
from omero_ms_image_region_tpu_torch.server.batcher import BatchingRenderer
from omero_ms_image_region_tpu_torch.services.metadata import (
    LocalMetadataService, write_mask)
from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

from torch_workload_apps import (MASKS, cache_headers, exchange,
                                 write_tree)

FLIPS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("masks")))


# 1023^2 (a payload that ends mid-byte), 1000x999 (a row stride of
# 124,875 bytes, no multiple of 4), 31x7 and 33x5 (rows shorter and just
# longer than K8a's 32-byte groups): the shapes of K8a's row-crossing,
# head and tail groups.
@pytest.mark.parametrize("w, h", [(64, 64), (37, 45), (1, 9), (1023, 1023),
                                  (1000, 999), (31, 7), (33, 5)])
@pytest.mark.parametrize("flip_h, flip_v", FLIPS)
def test_rasterize_packed_batch_matches_jax(w, h, flip_h, flip_v):
    """B=3: the port's device function (its plain version here) equals
    the JAX device function and the JAX host rasterizer, member for
    member (exact)."""
    rng = np.random.default_rng(w * 100 + h)
    packed = rng.integers(0, 256, size=(3, maskops.packed_nbytes(w, h)),
                          dtype=np.uint8)
    got = maskops.rasterize_packed_batch(packed, w, h, flip_h, flip_v,
                                         device="cpu")
    np.testing.assert_array_equal(got, jax_maskops.rasterize_packed_batch(
        packed, w, h, flip_h, flip_v))
    for i in range(3):
        grid, _ = jax_maskops.rasterize_mask(
            JaxMask(i, w, h, packed[i].tobytes()), None, flip_h, flip_v)
        np.testing.assert_array_equal(got[i], grid)


def test_payload_checks_match_jax():
    """A long payload is cut to ``packed_nbytes`` (the same grid), a short
    one raises, a flip of a 0-size mask raises, in both packages."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
    cut = maskops.pack_mask_payload(data, 37, 5)
    np.testing.assert_array_equal(
        cut, jax_maskops.pack_mask_payload(data, 37, 5))
    assert cut.size == maskops.packed_nbytes(37, 5) == 24
    np.testing.assert_array_equal(
        maskops.rasterize_packed_batch(cut[None], 37, 5, device="cpu")[0],
        maskops.unpack_mask_bits(data, 37, 5))
    for mod in (maskops, jax_maskops):
        with pytest.raises(ValueError, match="too small"):
            mod.pack_mask_payload(data[:3], 37, 5)
        with pytest.raises(ValueError, match="too small"):
            mod.unpack_mask_bits(data[:3], 37, 5)
        with pytest.raises(ValueError, match="0 size"):
            mod.rasterize_packed_batch(np.zeros((1, 0), np.uint8), 0, 5,
                                       True, False)
        with pytest.raises(ValueError, match="0 size"):
            mod.flip_mask(np.zeros((0, 5), np.uint8), False, True)


@pytest.mark.parametrize("alpha, h, w", [
    pytest.param(0, 13, 11, id="0"), pytest.param(128, 13, 11, id="128"),
    pytest.param(255, 13, 11, id="255"),
    # A pixel count that is no multiple of 4: K8b's ragged tail, and the
    # second tile's head.
    pytest.param(128, 1021, 1023, id="1023x1021-128")])
def test_overlay_matches_jax(alpha, h, w):
    """The blend with grid bytes above 1 and fill alpha 0, 128 and 255:
    the port's device function (plain version here) and host formula
    equal the JAX host blend and its jitted twin (exact)."""
    rng = np.random.default_rng(alpha)
    base = rng.integers(0, 256, size=(2, h, w, 4), dtype=np.uint8)
    grids = rng.integers(0, 4, size=(2, h, w), dtype=np.uint8)
    fills = np.array([[10, 200, 30, alpha], [255, 0, 7, alpha]], np.uint8)
    want = jax_maskops.overlay_masks_batch(base, grids, fills)
    np.testing.assert_array_equal(
        want, np.asarray(jax_maskops._overlay_batch_jit(base, grids, fills)))
    np.testing.assert_array_equal(
        maskops.overlay_masks_device(base, grids, fills, device="cpu"), want)
    np.testing.assert_array_equal(
        maskops.overlay_masks_batch(base, grids, fills), want)


def test_a_jax_written_mask_reads_back(data_dir, tmp_path):
    """The on-disk layout is shared: what the JAX ``write_mask`` wrote the
    port's ``get_mask`` reads equal, and the other way round."""
    meta = LocalMetadataService(data_dir)
    for sid, (w, h, fill) in MASKS.items():
        mask = asyncio.run(meta.get_mask(sid, None))
        with open(f"{data_dir}/masks/{sid}.bin", "rb") as f:
            assert mask.bytes_ == f.read()
        assert (mask.width, mask.height, mask.fill_color) == (w, h, fill)
    assert asyncio.run(meta.get_mask(99, None)) is None
    write_mask(str(tmp_path), Mask(6, 3, 2, b"\xa0", (1, 2, 3, 4)))
    from omero_ms_image_region_tpu.services.metadata import (
        LocalMetadataService as JaxMetadata)
    back = asyncio.run(JaxMetadata(str(tmp_path)).get_mask(6, None))
    assert (back.width, back.height, back.bytes_, back.fill_color) == (
        3, 2, b"\xa0", (1, 2, 3, 4))


MASK_REQUESTS = [
    ("GET", "/webgateway/render_shape_mask/1", {}),
    ("GET", "/webgateway/render_shape_mask/2", {}),
    ("GET", "/webgateway/render_shape_mask/1?color=00FF0080", {}),
    ("GET", "/webgateway/render_shape_mask/1?color=F0F", {}),
    ("GET", "/webgateway/render_shape_mask/3?flip=h", {}),
    ("GET", "/webgateway/render_shape_mask/3?flip=v", {}),
    ("GET", "/webgateway/render_shape_mask/3?flip=hv&color=123456", {}),
    ("GET", "/webgateway/render_shape_mask/4", {}),
    ("GET", "/webgateway/render_shape_mask/4/trailing/segment", {}),
    ("HEAD", "/webgateway/render_shape_mask/2", {}),
    ("GET", "/webgateway/render_shape_mask/5", {}),                # 404
    ("GET", "/webgateway/render_shape_mask/5",
     {"Cookie": "sessionid=someone"}),
    ("GET", "/webgateway/render_shape_mask/99", {}),               # 404
    ("GET", "/webgateway/render_shape_mask/1?color=zz", {}),       # 400
    ("GET", "/webgateway/render_shape_mask/x1", {}),               # 400
]


@pytest.fixture(scope="module")
def mask_answers(data_dir):
    raw = {"data-dir": data_dir, "session-store": {"type": "static"}}
    jax, port = exchange(raw, MASK_REQUESTS)
    # The ETag of mask 1, then its conditional repeat.
    etag = jax[0][1]["ETag"]
    again = [("GET", "/webgateway/render_shape_mask/1",
              {"If-None-Match": etag})]
    jax2, port2 = exchange(raw, again)
    return jax + jax2, port + port2


@pytest.mark.parametrize("i", range(len(MASK_REQUESTS) + 1))
def test_mask_route_answers_as_jax(mask_answers, i):
    jax, port = mask_answers
    what = (MASK_REQUESTS + [("GET", "If-None-Match", {})])[i]
    assert port[i][0] == jax[i][0], what
    assert port[i][2] == jax[i][2], what
    assert cache_headers(port[i][1]) == cache_headers(jax[i][1]), what


def test_mask_statuses(mask_answers):
    """The statuses the requests above stand for, and a 304 with no
    body."""
    _, port = mask_answers
    assert [p[0] for p in port] == [200] * 10 + [404, 200, 404, 400, 400,
                                                 304]
    assert port[9][2] == b"" and port[-1][2] == b""
    assert "Last-Modified" not in port[0][1]
    assert port[11][1]["Cache-Control"] == "private, no-cache"


def test_same_shape_masks_form_one_group():
    """Four masks of one shape and flips, awaited together, are one group
    of the mask lane: one ``Renderer.rasterizeMask.batch`` span, a group
    of 4, each grid the host rasterizer's."""
    rng = np.random.default_rng(8)
    packed = rng.integers(0, 256, size=(4, maskops.packed_nbytes(37, 45)),
                          dtype=np.uint8)

    async def run():
        b = BatchingRenderer("cpu", linger_ms=20.0)
        try:
            return b, await asyncio.gather(*[
                b.rasterize_mask(p, 37, 45, True, False) for p in packed])
        finally:
            await b.close()

    REGISTRY.reset()
    b, grids = asyncio.run(run())
    assert REGISTRY.snapshot()["Renderer.rasterizeMask.batch"]["count"] == 1
    assert dict(b.group_sizes) == {4: 1}
    for p, grid in zip(packed, grids):
        np.testing.assert_array_equal(grid, maskops.flip_mask(
            maskops.unpack_mask_bits(p.tobytes(), 37, 45), True, False))


@pytest.mark.cuda
def test_mask_kernels_match_plain_on_the_card():
    """On a CUDA card: K8a (four flips, W*H % 8 != 0, a 16-byte aligned
    and a ragged size, a row stride no multiple of 4, rows shorter and
    just longer than its 32-byte groups) and K8b (fill alpha 0, 128, 255,
    grid bytes above 1, a ragged tail, a base 4 bytes past a 16-byte
    boundary, B=3) equal their plain versions byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from omero_ms_image_region_tpu_torch.kernels import workloads
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    for w, h in ((64, 64), (37, 45), (1, 9), (1023, 1023), (1000, 999),
                 (31, 7), (33, 5)):
        packed = torch.from_numpy(rng.integers(
            0, 256, size=(3, maskops.packed_nbytes(w, h)),
            dtype=np.uint8)).to(dev)
        for fh, fv in FLIPS:
            assert torch.equal(
                workloads.mask_rasterize(packed, w, h, fh, fv),
                maskops.mask_rasterize_plain(packed, w, h, fh, fv))
    for w, h, B, off in ((64, 64, 2, 0), (37, 45, 2, 0), (1023, 1021, 1, 0),
                         (1024, 1024, 1, 4), (256, 256, 3, 0)):
        n = B * h * w * 4
        flat = torch.from_numpy(rng.integers(
            0, 256, size=n + 16, dtype=np.uint8)).to(dev)
        base = flat[off:off + n].view(B, h, w, 4)
        grids = torch.from_numpy(rng.integers(
            0, 4, size=(B, h, w), dtype=np.uint8)).to(dev)
        for alpha in (0, 128, 255):
            fills = torch.tensor([[9, 99, 199, alpha]] * B,
                                 dtype=torch.uint8, device=dev)
            assert torch.equal(workloads.mask_overlay(base, grids, fills),
                               maskops.mask_overlay_plain(base, grids, fills))
