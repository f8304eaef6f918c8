"""The packed staging of the port against the JAX package's, on the CPU.

* ``native.wirepack_pack16`` gives the JAX packer's words and widths, byte
  for byte, on seeded arrays: smooth, noise, all-zero, full range, W = 1000
  (a partial block) and W = 1024, and a band of 256 rows;
* ``io.staging.unpack16_plain`` (K10's plain version) equals the JAX
  ``unpack16_device`` run on the CPU and the source, exactly;
* ``io.staging.stage`` packs exactly the arrays the JAX ``stage`` packs:
  the JAX decode is spied on with ``monkeypatch`` (nothing in the JAX
  package changes) beside the port's dispatcher;
* the handler's banded cold read of a 1024^2 region of a tiled pyramid
  (four bands, decoded into their rows of one tensor) gives the raw planes
  the JAX handler's ``load_staged`` gives, also at an offset that snaps
  the band bounds to tile rows;
* the layout K10's one-launch design relies on: at the shapes of
  ``chip_smoke.py``'s K10 cases and on one row of 32 samples, both
  packers agree and ``len(words) == widths.sum()`` (every block of 32
  samples is ``w`` whole words, so every block starts on a word);
* K10's wrapper's host side: the tile count, the status scratch's size,
  the refusal of 2**32 words, and one scratch per device and stream with a
  new epoch a call (zeroed again when the epochs run out).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu import native as jax_native
from omero_ms_image_region_tpu.flagship import synthetic_wsi_tiles
from omero_ms_image_region_tpu.io import staging as jax_staging
from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server.app import \
    build_services as jax_build_services
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.server.ctx import ImageRegionCtx as JaxCtx
from omero_ms_image_region_tpu.server.handler import \
    ImageRegionHandler as JaxHandler
from omero_ms_image_region_tpu.server.region import RegionDef as JaxRegion
from omero_ms_image_region_tpu_torch import native
from omero_ms_image_region_tpu_torch.io import staging
from omero_ms_image_region_tpu_torch.io.devicecache import DeviceRawCache
from omero_ms_image_region_tpu_torch.kernels import jpeg as k6
from omero_ms_image_region_tpu_torch.kernels import scratch
from omero_ms_image_region_tpu_torch.kernels import staging as k10
from omero_ms_image_region_tpu_torch.server.app import build_services
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler, _Plan)
from omero_ms_image_region_tpu_torch.server.region import RegionDef

IMG = 5


def _smooth(rng, shape):
    walk = np.cumsum(rng.integers(-6, 7, size=shape), axis=-1)
    return (walk + 30000).astype(np.uint16)


ARRAYS = {
    "smooth": lambda rng: _smooth(rng, (4, 64, 1024)),
    "noise": lambda rng: rng.integers(0, 4096, (3, 64, 512)).astype(
        np.uint16),
    "zeros": lambda rng: np.zeros((2, 64, 256), np.uint16),
    "full_range": lambda rng: rng.integers(0, 65536, (2, 32, 1024)).astype(
        np.uint16),
    "w1000": lambda rng: _smooth(rng, (2, 40, 1000)),
    "w1024": lambda rng: synthetic_wsi_tiles(rng, 1, 2, 64, 1024)[0],
    "band256": lambda rng: synthetic_wsi_tiles(rng, 1, 4, 1024, 1024)[
        0, :, 256:512],
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_the_packer_is_the_jax_packers(name):
    arr = ARRAYS[name](np.random.default_rng(len(name)))
    words, widths = native.wirepack_pack16(arr)
    jax_words, jax_widths = jax_native.wirepack_pack16(arr)
    assert words.dtype == np.uint32 and widths.dtype == np.uint8
    assert np.array_equal(words, jax_words)
    assert np.array_equal(widths, jax_widths)


@pytest.mark.parametrize("name", ["smooth", "w1000", "full_range", "zeros"])
def test_unpack16_plain_is_the_jax_decode(name):
    arr = ARRAYS[name](np.random.default_rng(len(name)))
    words, widths = native.wirepack_pack16(arr)
    got = staging.unpack16_plain(torch.from_numpy(words.view(np.int32)),
                                 torch.from_numpy(widths), arr.shape)
    padded = np.zeros(jax_staging._pad_words(len(words)), np.uint32)
    padded[:len(words)] = words
    want = np.asarray(jax_staging.unpack16_device(
        jax.device_put(padded), jax.device_put(widths), arr.shape))
    got = got.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, want)
    assert np.array_equal(got, arr)


def test_stage_packs_what_jax_packs(monkeypatch):
    """Every decision of the JAX ``stage``, on one array each: packed
    (a flagship tile, a band, smooth content) or plain (small, not uint16,
    incompressible noise, off the tile lattice, too many planes)."""
    rng = np.random.default_rng(3)
    cases = {
        "flagship": synthetic_wsi_tiles(rng, 1, 4, 1024, 1024)[0],
        "band": synthetic_wsi_tiles(rng, 1, 4, 256, 1024)[0],
        "smooth": _smooth(rng, (2, 512, 1024)),
        "small": _smooth(rng, (1, 64, 256)),
        "uint8": rng.integers(0, 255, (4, 512, 1024)).astype(np.uint8),
        "noise": rng.integers(0, 65536, (4, 256, 1024)).astype(np.uint16),
        "w1000": _smooth(rng, (4, 256, 1000)),
        "rows100": _smooth(rng, (4, 100, 1024)),
        "lead65": _smooth(rng, (65, 64, 256)),
    }
    jax_packed, port_packed = [], []

    def jax_spy(words, widths, shape):
        jax_packed.append(tuple(shape))
        return jnp.zeros((), jnp.uint16)

    def port_spy(words, widths, out):
        port_packed.append(tuple(out.shape))
        return out

    monkeypatch.setattr(jax_staging, "unpack16_device", jax_spy)
    monkeypatch.setattr(staging, "unpack16", port_spy)
    for arr in cases.values():
        jax_staging.stage(arr)
        staging.stage(arr, "cpu")
    assert port_packed == jax_packed
    assert port_packed == [cases[k].shape for k in ("flagship", "band",
                                                    "smooth")]


@pytest.fixture(scope="module")
def tiled_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("staging")
    planes = synthetic_wsi_tiles(np.random.default_rng(9), 1, 2, 1280,
                                 1280)[0][:, None]
    build_pyramid(planes, str(root / str(IMG)), chunk=(256, 256),
                  n_levels=1)
    return str(root)


@pytest.mark.parametrize("region", [(0, 0, 1024, 1024),
                                    (128, 100, 1024, 1000)])
def test_banded_cold_read_is_the_jax_one(tiled_dir, region):
    raw = {"data-dir": tiled_dir, "watchdog": {"enabled": False},
           "raw-cache": {"prefetch": False}}
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(raw),
                                                "cpu"))
    jax_handler = JaxHandler(jax_build_services(JaxConfig.from_dict(raw)))
    src = handler.s.pixels_service.get_pixel_source(IMG)
    bounds = ImageRegionHandler._band_bounds(RegionDef(*region),
                                             src.tile_size()[1])
    assert len(bounds) >= 3                # banded: two bands or more
    plan = _Plan(src, RegionDef(*region), 0, [0, 1], {}, [])
    got = handler._load(plan, ImageRegionCtx(image_id=IMG))
    jax_src = jax_handler.s.pixels_service.get_pixel_source(IMG)
    want = np.asarray(jax_handler._read_region(
        jax_src, JaxCtx(image_id=IMG), JaxRegion(*region), 0, [0, 1]))
    assert got.shape == want.shape
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          want)
    # A second read of the region is a raw-cache hit.
    assert handler._load(plan, ImageRegionCtx(image_id=IMG)) is got
    asyncio.run(handler.s.renderer.close())


# chip_smoke.py's K10 shapes (their content classes: flagship tiles, a
# band, all zero, full-range noise, rows of 1000) and one row of 32.
K10_SHAPES = {
    "tile": lambda rng: synthetic_wsi_tiles(rng, 1, 4, 1024, 1024)[0],
    "band": lambda rng: synthetic_wsi_tiles(rng, 1, 4, 256, 1024)[0],
    "zeros": lambda rng: np.zeros((4, 1024, 1024), np.uint16),
    "full_range": lambda rng: rng.integers(
        0, 65536, (4, 1024, 1024)).astype(np.uint16),
    "w1000": lambda rng: synthetic_wsi_tiles(rng, 1, 4, 256, 1000)[0],
    "row32": lambda rng: rng.integers(0, 65536, (1, 1, 32)).astype(
        np.uint16),
}


@pytest.mark.parametrize("name", sorted(K10_SHAPES))
def test_every_block_is_whole_words(name):
    arr = K10_SHAPES[name](np.random.default_rng(10))
    words, widths = native.wirepack_pack16(arr)
    jax_words, jax_widths = jax_native.wirepack_pack16(arr)
    assert np.array_equal(words, jax_words)
    assert np.array_equal(widths, jax_widths)
    assert len(words) == int(widths.astype(np.int64).sum())
    assert int(widths.max()) <= 17


def test_k10_host_plan():
    assert k10.tile_count(100, 4096, 8) == 512      # a 4x1024^2 tile
    assert k10.tile_count(100, 300, 8) == 38         # 300 rows
    assert k10.tile_count(0, 1, 8) == 1
    assert k10.tile_count(k10.MAX_WORDS - 1, 16384, 8) == 2048
    with pytest.raises(ValueError, match="32-bit"):
        k10.tile_count(k10.MAX_WORDS, 16384, 8)
    assert [scratch.scratch_entries(t)
            for t in (1, 256, 257, 512, 2048, 2049)] \
        == [256, 256, 512, 512, 2048, 4096]


def test_k10_status_scratch_per_stream(monkeypatch):
    """The look-back scratch of K10 and K6: one per device and stream,
    shared by both wrappers, a new epoch a call."""
    assert k10.status_scratch is scratch.status_scratch
    assert k6.status_scratch is scratch.status_scratch
    monkeypatch.setattr(scratch, "_scratch", {})
    cpu = torch.device("cpu")
    a, e1 = k10.status_scratch(cpu, 7, 512)
    assert a.dtype == torch.int64 and a.numel() == 512 and e1 == 1
    assert not a.any()
    b, e2 = k6.status_scratch(cpu, 7, 100)
    assert b is a and e2 == 2                        # same stream: reused
    c, e3 = k10.status_scratch(cpu, 8, 100)
    assert c is not a and e3 == 1                    # another stream
    a.fill_(5)
    d, e4 = k6.status_scratch(cpu, 7, 513)           # grown: a new, zeroed
    assert d.numel() == 1024 and e4 == 1 and not d.any()
    monkeypatch.setattr(scratch, "EPOCH_LIMIT", 3)
    k10.status_scratch(cpu, 7, 1)
    d.fill_(9)
    e, e6 = k6.status_scratch(cpu, 7, 1)             # epochs ran out
    assert e is d and e6 == 1 and not e.any()
