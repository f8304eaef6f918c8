"""Port ``server.batcher.BatchingRenderer`` (on the CPU, so every kernel
runs its plain version) against the JAX ``BatchingRenderer`` and the port's
direct ``Renderer``, on the same seeded numpy raws and settings.

JPEG bytes and packed u32 must be identical.  The concurrency contracts
mirror ``tests/test_batcher.py``; lingers are short and no test waits
more than a few hundred ms.
"""

import asyncio
import threading

import numpy as np
import pytest

from omero_ms_image_region_tpu.server.batcher import (
    BatchingRenderer as JaxBatcher,
)
from omero_ms_image_region_tpu_torch import native
from omero_ms_image_region_tpu_torch.models.pixels import Pixels
from omero_ms_image_region_tpu_torch.models.rendering import (
    RenderingModel, default_rendering_def,
)
from omero_ms_image_region_tpu_torch.ops import jpegenc
from omero_ms_image_region_tpu_torch.ops.lut import LutProvider
from omero_ms_image_region_tpu_torch.ops.render import pack_settings
from omero_ms_image_region_tpu_torch.server.batcher import (
    BatchingRenderer, pick_bucket,
)
from omero_ms_image_region_tpu_torch.server.handler import Renderer
from omero_ms_image_region_tpu_torch.utils import transient

LUTS = LutProvider()
LUTS.add("t.lut", np.random.default_rng(9).integers(
    0, 256, (256, 3)).astype(np.uint8))


def _settings(C=2, shift=0.0, reverse=(), lut=None):
    pixels = Pixels(image_id=1, pixels_type="uint16", size_x=64, size_y=64,
                    size_c=C)
    rdef = default_rendering_def(pixels)
    rdef.model = RenderingModel.RGB
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]
    for c, cb in enumerate(rdef.channel_bindings):
        cb.red, cb.green, cb.blue = colors[c % 4]
        cb.input_start, cb.input_end = 100.0 + shift, 50000.0 - shift
        cb.reverse_intensity = c in reverse
    if lut is not None:
        rdef.channel_bindings[lut].lut = "t.lut"
    return pack_settings(rdef, LUTS)


def _raw(seed, C, h, w):
    """Smooth content (a JPEG tile that fits the sparse wire) plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 20000 + 15000 * np.sin(x / 37.0 + seed) * np.cos(y / 29.0)
    return np.stack([base + 3000 * c + rng.normal(0, 300, (h, w))
                     for c in range(C)]).clip(0, 60000).astype(np.uint16)


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _batched(make, calls):
    """Run ``calls(batcher)`` concurrently on one new batcher; return the
    results and the batcher (closed)."""
    batcher = make()

    async def main():
        try:
            return await asyncio.gather(*calls(batcher))
        finally:
            await batcher.close()
    return run(main()), batcher


def test_pick_bucket():
    assert pick_bucket(100, 200) == (256, 256)
    assert pick_bucket(256, 257) == (512, 512)
    assert pick_bucket(5000, 100) == (5000, 100)


def test_jpeg_bucket_group_matches_jax_and_direct():
    """1024^2, 1000x1000 and 600x700 tiles share the 1024 bucket in one
    group, with mixed windows and a reversed channel; each tile's JFIF is
    the JAX batcher's and the direct renderer's."""
    raws = [_raw(1, 2, 1024, 1024), _raw(2, 2, 1000, 1000),
            _raw(3, 2, 600, 700)]
    settings = [_settings(), _settings(shift=2000.0),
                _settings(reverse=(1,))]

    def calls(b):
        return [b.render_jpeg(r, s, 85, r.shape[2], r.shape[1])
                for r, s in zip(raws, settings)]

    jpegenc._CAP_MEMO.clear()
    got, port = _batched(lambda: BatchingRenderer("cpu", linger_ms=50.0),
                         calls)
    want, _ = _batched(lambda: JaxBatcher(linger_ms=50.0), calls)
    assert (port.batches_dispatched, port.tiles_rendered) == (1, 3)
    assert port.group_sizes == {3: 1}
    direct = Renderer("cpu")
    for g, w, r, s in zip(got, want, raws, settings):
        assert g[:2] == b"\xff\xd8" and g == w
        assert g == direct.render_jpeg_sync(r, s, 85, r.shape[2],
                                            r.shape[1])


def test_lut_ramp_and_quality_do_not_cobatch():
    raw = _raw(4, 2, 32, 40)
    reqs = [(_settings(), 85), (_settings(shift=500.0), 85),
            (_settings(), 90), (_settings(lut=1), 85)]

    def calls(b):
        return [b.render_jpeg(raw, s, q, 40, 32) for s, q in reqs]

    got, port = _batched(lambda: BatchingRenderer("cpu", linger_ms=20.0),
                         calls)
    want, _ = _batched(lambda: JaxBatcher(linger_ms=20.0), calls)
    assert got == want
    # ramp q85 x2, ramp q90, LUT q85
    assert port.group_sizes == {2: 1, 1: 2}


def test_packed_render_matches_jax_exactly_with_mixed_settings():
    raws = [_raw(5, 3, 40, 56), _raw(6, 3, 16, 16), _raw(7, 3, 40, 56)]
    settings = [_settings(3), _settings(3, shift=1000.0, reverse=(0,)),
                _settings(3, lut=2)]

    def calls(b):
        return [b.render(r, s) for r, s in zip(raws, settings)]

    got, port = _batched(lambda: BatchingRenderer("cpu", linger_ms=20.0),
                         calls)
    want, _ = _batched(lambda: JaxBatcher(linger_ms=20.0), calls)
    for g, w, r in zip(got, want, raws):
        assert g.dtype == np.uint32 and g.shape == r.shape[1:]
        np.testing.assert_array_equal(g, w)
    # The two ramp tiles share a group; the LUT tile has its own.
    assert port.group_sizes == {2: 1, 1: 1}


def test_concurrent_requests_coalesce():
    raws = [_raw(10 + i, 2, 32, 32) for i in range(8)]
    s = _settings()
    outs, port = _batched(
        lambda: BatchingRenderer("cpu", max_batch=8, linger_ms=20.0),
        lambda b: [b.render(r, s) for r in raws])
    assert port.batches_dispatched < len(raws)
    direct = Renderer("cpu")
    for raw, out in zip(raws, outs):
        np.testing.assert_array_equal(out, direct.render_sync(raw, s))


def test_flips_fold_into_the_raw_before_the_pad():
    """Ragged tiles with mixed flips in one group equal the direct
    renderer, whose flips go into K3's reads or the packed tile."""
    raw = _raw(20, 2, 37, 45)
    flips = [(True, False), (False, True), (True, True), (False, False)]
    s = _settings()
    jpegs, port = _batched(
        lambda: BatchingRenderer("cpu", linger_ms=20.0),
        lambda b: [b.render_jpeg(raw, s, 85, 45, 37, fh, fv)
                   for fh, fv in flips])
    packed, _ = _batched(
        lambda: BatchingRenderer("cpu", linger_ms=20.0),
        lambda b: [b.render(raw, s, fh, fv) for fh, fv in flips])
    assert port.group_sizes == {4: 1}
    direct = Renderer("cpu")
    for (fh, fv), j, p in zip(flips, jpegs, packed):
        assert j == direct.render_jpeg_sync(raw, s, 85, 45, 37, fh, fv)
        np.testing.assert_array_equal(p, direct.render_sync(raw, s, fh, fv))


def test_different_channel_counts_do_not_mix():
    outs, port = _batched(
        lambda: BatchingRenderer("cpu", linger_ms=5.0),
        lambda b: [b.render(_raw(30, 3, 16, 16), _settings(3)),
                   b.render(_raw(31, 4, 16, 16), _settings(4))])
    assert [o.shape for o in outs] == [(16, 16), (16, 16)]
    assert port.group_sizes == {1: 2}


def test_group_error_reaches_every_waiter():
    bad = _raw(32, 2, 16, 16)
    s3 = _settings(3)                     # C mismatch against the raw

    async def main():
        b = BatchingRenderer("cpu", linger_ms=20.0)
        try:
            return await asyncio.gather(b.render(bad, s3), b.render(bad, s3),
                                        return_exceptions=True)
        finally:
            await b.close()
    outs = run(main())
    assert all(isinstance(o, Exception) for o in outs)


class _Probe(BatchingRenderer):
    """Counts group renders in flight; with a ``gate``, each group waits
    until two are in flight (so overlap is contested)."""

    def __init__(self, *args, gate=False, **kw):
        super().__init__(*args, **kw)
        self.lock = threading.Lock()
        self.now = self.peak = 0
        self.both = threading.Event() if gate else None

    def _render_group(self, group):
        with self.lock:
            self.now += 1
            self.peak = max(self.peak, self.now)
            if self.now >= 2 and self.both is not None:
                self.both.set()
        try:
            if self.both is not None:
                self.both.wait(timeout=30)
            return super()._render_group(group)
        finally:
            with self.lock:
                self.now -= 1


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_depth_bounds_groups(depth):
    s = _settings(1)
    _, probe = _batched(
        lambda: _Probe("cpu", max_batch=1, linger_ms=0.0,
                       pipeline_depth=depth, gate=depth > 1),
        lambda b: [b.render(_raw(40 + i, 1, 16, 16), s) for i in range(4)])
    assert probe.peak == depth


def test_backlog_pops_groups_of_at_most_max_batch():
    """A backlog drains in groups of max_batch, in arrival order, and the
    batch size never grows past it."""
    s = _settings(1)
    raws = [_raw(80 + i, 1, 16, 16) for i in range(8)]
    outs, b = _batched(
        lambda: BatchingRenderer("cpu", max_batch=3, linger_ms=0.0,
                                 pipeline_depth=1),
        lambda b: [b.render(r, s) for r in raws])
    assert b.group_sizes == {3: 2, 2: 1} and b.max_batch == 3
    direct = Renderer("cpu")
    for raw, out in zip(raws, outs):
        np.testing.assert_array_equal(out, direct.render_sync(raw, s))


def test_device_lanes_bound_execute():
    """With one lane and depth 2, two groups overlap in their host half
    but never in execute."""
    staged = threading.Barrier(2, timeout=30)

    class Probe(BatchingRenderer):
        def _stage_host(self, group):
            out = super()._stage_host(group)
            staged.wait()              # both groups staged at once
            return out

    s = _settings(1)
    outs, probe = _batched(
        lambda: Probe("cpu", max_batch=1, linger_ms=0.0, pipeline_depth=2,
                      device_lanes=1),
        lambda b: [b.render(_raw(50 + i, 1, 16, 16), s) for i in range(2)])
    assert probe.max_executing == 1
    assert [o.shape for o in outs] == [(16, 16), (16, 16)]


def test_lane_and_depth_validation():
    with pytest.raises(ValueError):
        BatchingRenderer("cpu", device_lanes=0)
    with pytest.raises(ValueError):
        BatchingRenderer("cpu", pipeline_depth=0)


def test_deadline_expired_in_queue_is_dropped_at_pop():
    s = _settings(1)

    async def main():
        b = BatchingRenderer("cpu", linger_ms=100.0)
        try:
            keep = asyncio.ensure_future(b.render(_raw(60, 1, 16, 16), s))
            with transient.deadline_scope(1.0):
                late = asyncio.ensure_future(
                    b.render(_raw(61, 1, 16, 16), s))
            return await asyncio.gather(keep, late,
                                        return_exceptions=True), b
        finally:
            await b.close()
    (kept, dropped), b = run(main())
    assert kept.shape == (16, 16)
    assert isinstance(dropped, transient.DeadlineExceededError)
    assert b.tiles_rendered == 1


def test_first_tile_out_settlement(monkeypatch):
    """A JPEG request resolves when its own tile is coded, while the
    group's next tile is still held in the coder."""
    release = threading.Event()
    encode = native.jpeg_encode
    calls = []

    def held_encode(*args):
        calls.append(1)
        if len(calls) == 2:
            release.wait(timeout=30)
        return encode(*args)

    monkeypatch.setattr(native, "jpeg_encode", held_encode)
    s = _settings()

    async def main():
        b = BatchingRenderer("cpu", linger_ms=20.0)
        try:
            t0 = asyncio.ensure_future(
                b.render_jpeg(_raw(70, 2, 32, 32), s, 85, 32, 32))
            t1 = asyncio.ensure_future(
                b.render_jpeg(_raw(71, 2, 32, 32), s, 85, 32, 32))
            first = await asyncio.wait_for(t0, 20)
            held = not t1.done()
            release.set()
            return held, first, await t1, b
        finally:
            release.set()
            await b.close()
    held, a, z, b = run(main())
    assert held and len(calls) == 2
    assert b.group_sizes == {2: 1}
    assert a[:2] == z[:2] == b"\xff\xd8" and a != z


def test_serves_one_event_loop_after_another():
    """State left by a closed loop is dropped: a renderer serves (and
    closes) across successive ``asyncio.run`` calls."""
    b = BatchingRenderer("cpu", linger_ms=1.0)
    s = _settings(1)
    for seed in (90, 91):
        out = asyncio.run(b.render(_raw(seed, 1, 16, 16), s))
        assert out.shape == (16, 16)
        asyncio.run(b.close())
    assert b.batches_dispatched == 2
