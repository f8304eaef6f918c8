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
  the band bounds to tile rows.
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
