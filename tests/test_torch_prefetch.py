"""The port's viewport model, prefetcher and session buckets against the
JAX package's.

``ViewportTracker.predict`` gives the JAX predictions on scripted pan,
diagonal, stale, zoom-in, zoom-out, z/t scrub and image-switch
trajectories (a fake clock).  A sequence of tile GETs (pans, a lattice-only
session, a zoom in, a scrub, a flipped pan and a re-visit) through each
package's handler on the CPU (the JAX ``DeviceRawCache`` and the port's
with CPU tensors, each with its prefetcher and viewport model) leaves the
same staged raw-cache keys, the same predicted, staged and hit counts, and
every staged plane equal to the source.  Both default apps with
``sessions.enabled`` shed the same requests (tiles and masks) with 503,
reason ``fairness`` and a ``Retry-After`` of the refill time, while
another session is served.
"""

import asyncio
import os

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.services import viewport as jax_viewport
from omero_ms_image_region_tpu_torch.services import viewport

from torch_workload_apps import exchange, write_tree


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# (session, image, z, t, resolution, x, y, seconds since the last step)
TRAJECTORIES = {
    "pan": [("a", 1, 0, 0, 0, x, 2, 0.3) for x in range(5)],
    "diagonal_back": [("a", 1, 0, 0, 0, 9 - x, 9 - x, 0.2)
                      for x in range(4)],
    "stale": [("a", 1, 0, 0, 0, 0, 0, 0.1), ("a", 1, 0, 0, 0, 1, 0, 0.1),
              ("a", 1, 0, 0, 0, 2, 0, 30.0)],
    "resume_after_pause": [("a", 1, 0, 0, 0, x, 0, 0.2) for x in range(3)]
    + [("a", 1, 0, 0, 0, 40, 0, 12.0), ("a", 1, 0, 0, 0, 41, 0, 0.2)],
    "zoom_in": [("a", 1, 0, 0, 2, 1, 1, 0.2), ("a", 1, 0, 0, 1, 2, 3, 0.2)],
    "zoom_out": [("a", 1, 0, 0, 0, 4, 6, 0.2), ("a", 1, 0, 0, 1, 2, 3, 0.2)],
    "scrub": [("a", 1, z, 0, 0, 3, 3, 0.1) for z in range(4)],
    "time_scrub": [("a", 1, 0, t, 0, 3, 3, 0.1) for t in (6, 4, 2)],
    "image_switch": [("a", 1, 0, 0, 0, 0, 0, 0.1),
                     ("a", 2, 0, 0, 0, 1, 0, 0.1)],
    "two_sessions": [("a", 1, 0, 0, 0, 0, 0, 0.1),
                     ("b", 1, 0, 0, 0, 5, 5, 0.1),
                     ("a", 1, 0, 0, 0, 1, 0, 0.1),
                     ("b", 1, 0, 0, 0, 5, 6, 0.1),
                     (None, 1, 0, 0, 0, 0, 0, 0)],
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_viewport_predictions_equal_jax(name):
    def replay(mod):
        clock = Clock()
        tracker = mod.ViewportTracker(max_sessions=2, history=4,
                                      clock=clock)
        out = []
        for session, image, z, t, res, x, y, dt in TRAJECTORIES[name]:
            clock.t += dt
            tracker.observe(session, image, z, t, res, x, y)
            for key in ("a", "b", None):
                out.append((tracker.velocity(key),
                            tracker.scrub_velocity(key),
                            tracker.zoom_direction(key),
                            [(p.image_id, p.z, p.t, p.resolution, p.x, p.y,
                              p.step) for p in tracker.predict(
                                  key, lookahead=3, max_level=2)]))
        return out, len(tracker), tracker.evictions

    assert replay(viewport) == replay(jax_viewport)


# --------------------------------------------------- staged key parity

IMAGE = 1
CH = {"c": "1|0:60000$FF0000,2|0:60000$00FF00", "m": "c", "format": "png"}
# (session, z, resolution, tile x, tile y, flip)
GETS = ([("pan", 0, 0, x, 1, None) for x in range(4)]
        + [("lattice", 0, 0, 5, 5, None)]
        + [("zoom", 0, 2, 1, 1, None), ("zoom", 0, 1, 2, 2, None)]
        + [("scrub", z, 0, 3, 3, None) for z in range(3)]
        + [("flip", 0, 0, x, 0, "h") for x in range(3)]
        + [("pan", 0, 0, 4, 1, None), ("pan", 0, 0, 5, 1, None)])


class _StubRenderer:
    """The JAX handler's renderer for this test: the staged keys do not
    depend on what the render makes, and no XLA program is compiled."""

    async def render(self, raw, settings):
        return np.zeros(raw.shape[-2:], np.uint32)

    async def close(self):
        pass


def _jax_handler(data_dir):
    from omero_ms_image_region_tpu.io.devicecache import DeviceRawCache
    from omero_ms_image_region_tpu.io.service import PixelsService
    from omero_ms_image_region_tpu.ops.lut import LutProvider
    from omero_ms_image_region_tpu.server.handler import (
        ImageRegionHandler, ImageRegionServices)
    from omero_ms_image_region_tpu.services.cache import CacheConfig, Caches
    from omero_ms_image_region_tpu.services.metadata import (
        CanReadMemo, LocalMetadataService)
    from omero_ms_image_region_tpu.services.prefetch import TilePrefetcher

    cache = DeviceRawCache()
    return ImageRegionHandler(ImageRegionServices(
        pixels_service=PixelsService(data_dir),
        metadata=LocalMetadataService(data_dir),
        caches=Caches.from_config(CacheConfig()),
        can_read_memo=CanReadMemo(), renderer=_StubRenderer(),
        lut_provider=LutProvider(), raw_cache=cache,
        cpu_fallback_max_px=0,
        prefetcher=TilePrefetcher(
            cache, max_workers=1,
            viewport=jax_viewport.ViewportTracker())))


def _port_handler(data_dir):
    from omero_ms_image_region_tpu_torch.io.devicecache import DeviceRawCache
    from omero_ms_image_region_tpu_torch.io.service import PixelsService
    from omero_ms_image_region_tpu_torch.ops.lut import LutProvider
    from omero_ms_image_region_tpu_torch.server.handler import (
        ImageRegionHandler, ImageRegionServices, Renderer)
    from omero_ms_image_region_tpu_torch.services.metadata import (
        LocalMetadataService)
    from omero_ms_image_region_tpu_torch.services.prefetch import (
        TilePrefetcher)

    cache = DeviceRawCache(device="cpu")
    return ImageRegionHandler(ImageRegionServices(
        pixels_service=PixelsService(data_dir),
        metadata=LocalMetadataService(data_dir), renderer=Renderer("cpu"),
        lut_provider=LutProvider(), raw_cache=cache, jpeg_host_max_px=0,
        prefetcher=TilePrefetcher(
            cache, max_workers=1,
            viewport=viewport.ViewportTracker())))


def test_staged_keys_equal_jax(tmp_path):
    from omero_ms_image_region_tpu.server.ctx import (
        ImageRegionCtx as JaxCtx)
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx

    planes = np.random.default_rng(8).integers(
        0, 60000, (2, 3, 256, 256)).astype(np.uint16)
    build_pyramid(planes, os.path.join(tmp_path, str(IMAGE)),
                  chunk=(64, 64), n_levels=3)

    def drive(handler, ctx_cls):
        prefetcher = handler.s.prefetcher
        for session, z, res, x, y, flip in GETS:
            params = dict(CH, imageId=str(IMAGE), theZ=str(z), theT="0",
                          tile=f"{res},{x},{y},32,32")
            if flip:
                params["flip"] = flip
            asyncio.run(handler.render_image_region(
                ctx_cls.from_params(params, session)))
            prefetcher.flush()
        staged = set(prefetcher._staged_keys)
        return handler, staged, (prefetcher.predicted, prefetcher.staged,
                                 prefetcher.hits)

    jax, jax_staged, jax_counts = drive(_jax_handler(str(tmp_path)),
                                        JaxCtx)
    port, staged, counts = drive(_port_handler(str(tmp_path)),
                                 ImageRegionCtx)
    assert staged == jax_staged and counts == jax_counts
    predicted, n_staged, hits = counts
    assert predicted > 0 and hits > 0 and n_staged > len(staged)
    # The zoom in (resolution 2 -> 1) staged the children at 0 that were
    # not resident (the lattice session had read tile 5,5).
    children = {(k[4][0], k[4][1]) for k in staged if k[3] == 0}
    assert {(128, 128), (160, 128), (128, 160)} <= children
    assert (160, 160) not in children
    # A staged plane is the source's region.
    levels = [[256, 256], [128, 128], [64, 64]]
    for key in staged:
        image, z, t, level, (x0, y0, w, h), channels = key
        got = port.s.raw_cache.get(key).numpy().view(np.uint16)
        src = port.s.pixels_service.get_pixel_source(image)
        from omero_ms_image_region_tpu_torch.server.region import RegionDef
        for i, c in enumerate(channels):
            want = src.get_region(z, c, t, RegionDef(x0, y0, w, h), level)
            assert np.array_equal(got[i], want)
        assert x0 + w <= levels[level][0] and y0 + h <= levels[level][1]
    jax.s.prefetcher.close()
    port.s.prefetcher.close()


# --------------------------------------------------- fairness buckets

def test_session_buckets_shed_alike(tmp_path):
    """A burst of 3 tokens that hardly refills: a session's 4th and 5th
    tile GETs and its mask GET get 503 with reason ``fairness``; another
    session's GET is served; a conditional revalidation costs no token
    in either app."""
    root = write_tree(str(tmp_path))
    raw = {"data-dir": root, "session-store": {"type": "static"},
           "sessions": {"enabled": True, "bucket-refill-per-s": 0.001,
                        "bucket-burst": 3}}
    tile = ("/webgateway/render_image_region/7/0/0?tile=0,{x},0,32,32"
            "&c=1|0:60000$FF0000&m=c&format=png")
    hog = {"Cookie": "sessionid=hog"}
    requests = ([("GET", tile.format(x=x), hog) for x in range(5)]
                + [("GET", tile.format(x=0), {"Cookie": "sessionid=ok"}),
                   ("GET", "/webgateway/render_shape_mask/1",
                    {"Cookie": "sessionid=ok"}),
                   ("GET", "/webgateway/render_shape_mask/1", hog),
                   ("GET", "/metrics", {})])
    jax, port = exchange(raw, requests)
    statuses = []
    for (method, url, _), want, got in zip(requests[:-1], jax, port):
        assert (got[0], got[2]) == (want[0], want[2]), url
        statuses.append(got[0])
        if got[0] == 503:
            # The deficit over the refill rate, less what refilled while
            # the requests ran: the same whole seconds, give or take one.
            retry = [int(r[1]["Retry-After"]) for r in (want, got)]
            assert min(retry) >= 999 and abs(retry[0] - retry[1]) <= 1
    assert statuses == [200, 200, 200, 503, 503, 200, 200, 503]
    for _, _, body in (jax[-1], port[-1]):
        assert b'imageregion_shed_total{reason="fairness"} 3' in body
