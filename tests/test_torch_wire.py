"""The port's sidecar wire v3 against the JAX package's.

* the golden frame corpus (``tests/data/wire/*.bin``, 14 v2 and v3 frames)
  decodes with the port's ``_read_frame`` and encodes again with its
  ``_pack`` to the same bytes, with the semantics ``tests/test_wire_v3.py``
  checks;
* ``ShmRing``: one script of allocations, a wrap, an exhaustion and
  hostile descriptors gives the same outcomes on the port's ring and the
  JAX one, and each attaches the other's segment;
* ``FrameWriter`` coalesces frames queued in one tick into one flush, with
  the JAX writer's bytes;
* the JAX ``SidecarClient`` against the port's ``run_sidecar`` on a unix
  socket (on the CPU): the ring negotiated, an image op's bytes equal the
  port handler's (unary and streamed), and the plane ops: a probe misses,
  a put stages (packed: K10's plain version on the CPU) and the plane is
  on the sidecar's raw cache byte for byte, the next push finds it
  resident.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server import shmring as jax_shmring
from omero_ms_image_region_tpu.server import sidecar as jax_sidecar
from omero_ms_image_region_tpu.server.config import WireConfig as JaxWire
from omero_ms_image_region_tpu.server.ctx import \
    ImageRegionCtx as JaxCtx
from omero_ms_image_region_tpu_torch.io import devicecache
from omero_ms_image_region_tpu_torch.server import shmring, sidecar
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
from omero_ms_image_region_tpu_torch.server.handler import (
    ImageRegionHandler)

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "data", "wire")
IMG = 3
PARAMS = {"imageId": str(IMG), "theZ": "0", "theT": "0",
          "c": "1|0:60000$FF0000,2|100:50000$00FF00", "m": "c",
          "format": "png"}


async def _parse_frames(data: bytes):
    reader = asyncio.StreamReader()
    reader.feed_data(data)
    reader.feed_eof()
    frames = []
    while True:
        try:
            frames.append(await sidecar._read_frame(reader))
        except asyncio.IncompleteReadError:
            break
    return frames


def _corpus(name):
    with open(os.path.join(CORPUS_DIR, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(CORPUS_DIR) if n.endswith(".bin")))
def test_golden_corpus_roundtrips_through_the_port(name):
    blob = _corpus(name)
    frames = asyncio.run(_parse_frames(blob))
    assert frames
    assert b"".join(sidecar._pack(h, b) for h, b in frames) == blob
    assert b"".join(jax_sidecar._pack(h, b) for h, b in frames) == blob


def test_golden_corpus_semantics():
    def load(name):
        return asyncio.run(_parse_frames(_corpus(name)))

    assert len([n for n in os.listdir(CORPUS_DIR)
                if n.endswith(".bin")]) == 14
    [(h, b)] = load("v2_request_image.bin")
    assert (h["op"], h["v"], h["id"]) == ("image", 2, 1)
    assert "stream" not in h and "ring" not in h
    [(h, b)] = load("v2_request_plane_put.bin")
    assert h["digest"] == "aa" * 16 and len(b) == 32
    [(h, b)] = load("v3_hello.bin")
    assert h["op"] == "hello" and h["v"] == 3
    assert h["rings"]["c2s"]["size"] == 33554432
    [(h, b)] = load("v3_ring_descriptor.bin")
    assert h["ring"] == [0, 512] and b == b""
    frames = load("v3_coalesced_flush.bin")
    assert [f[0].get("seq") for f in frames] == [None, 0, 1, None]
    assert frames[-1][0]["status"] == 200 and frames[-1][0]["fin"]
    assert frames[1][1] + frames[2][1] == b"CHUNK-0-CHUNK-1"


def _ring_script(mod):
    """Allocations, a wrap, an exhaustion and hostile descriptors on one
    4 KiB ring; the outcome of each step."""
    ring = mod.ShmRing.create(4096)
    out = []

    def step(fn):
        try:
            out.append(fn())
        except mod.RingError as e:
            out.append(("RingError", type(e).__name__))

    try:
        off = ring.alloc_write(b"x" * 100)
        step(lambda: (off, ring.read_release(off, 100), ring.tail))
        off2 = ring.alloc_write(b"y" * 3000)
        step(lambda: (off2, ring.read_release(off2, 3000)))
        off3 = ring.alloc_write(b"z" * 1500)          # wraps to a new lap
        step(lambda: (off3, ring.read_release(off3, 1500)))
        a = ring.alloc_write(b"a" * 2000)
        step(lambda: ring.alloc_write(b"b" * 2200))   # exhausted: None
        step(lambda: ring.read_release(a, 2000))
        step(lambda: ring.alloc_write(b"b" * 2200) is not None)
        step(lambda: (ring.alloc_write(b""), ring.alloc_write(b"c" * 5000)))
        d = ring.alloc_write(b"d" * 256)
        for args in ((d + 1, 256), (d, 10 ** 9), ("junk", 16),
                     (d - 5000, 16)):
            step(lambda args=args: ring.read_release(*args))
        step(lambda: ring.read_release(d, 256))
        step(lambda: ring.read_release(d, 256))       # released already
        return out
    finally:
        ring.close()


def test_shmring_behaves_as_jax():
    assert _ring_script(shmring) == _ring_script(jax_shmring)


@pytest.mark.parametrize("creator, attacher", [(shmring, jax_shmring),
                                               (jax_shmring, shmring)])
def test_shmring_segments_interoperate(creator, attacher):
    ring = creator.ShmRing.create(8192)
    try:
        peer = attacher.ShmRing.attach(ring.name, 8192)
        off = ring.alloc_write(b"cross" * 10)
        assert peer.read_release(off, 50) == b"cross" * 10
        assert ring.tail == 50
        peer.close()
        with pytest.raises(attacher.RingError):
            attacher.ShmRing.attach(ring.name, 4096)    # size mismatch
    finally:
        ring.close()


class _FakeWriter:
    """A StreamWriter stand-in that records each ``writelines``."""

    def __init__(self):
        self.flushes = []
        self.drains = 0

    def writelines(self, bufs):
        self.flushes.append([bytes(b) for b in bufs])

    async def drain(self):
        self.drains += 1

    def close(self):
        pass


def test_framewriter_coalesces_as_jax():
    async def scenario(mod):
        w = _FakeWriter()
        fw = mod.FrameWriter(w)
        try:
            await asyncio.gather(*(fw.send({"id": i, "status": 200},
                                           b"B" * i) for i in range(5)))
        finally:
            fw.close()
        return w

    port, jax = asyncio.run(scenario(sidecar)), asyncio.run(
        scenario(jax_sidecar))
    assert len(port.flushes) == 1 and port.drains == 1
    assert port.flushes == jax.flushes
    assert b"".join(port.flushes[0]) == b"".join(
        sidecar._pack({"id": i, "status": 200}, b"B" * i) for i in range(5))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("wire")
    planes = np.random.default_rng(21).integers(
        0, 60000, size=(2, 1, 96, 80)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


def _config(data_dir) -> AppConfig:
    return AppConfig.from_dict({
        "data-dir": data_dir, "watchdog": {"enabled": False},
        "sentinel": {"enabled": False},
        "raw-cache": {"prefetch": False, "digest-dedup": True}})


async def _with_port_sidecar(config, sock, body):
    holder: dict = {}
    task = asyncio.create_task(sidecar.run_sidecar(
        config, sock, services_out=holder, device="cpu"))
    try:
        for _ in range(400):
            if task.done():
                raise AssertionError(f"sidecar died: {task.exception()!r}")
            if os.path.exists(sock):
                break
            await asyncio.sleep(0.05)
        return await body(holder["services"])
    finally:
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass


def test_jax_client_against_the_port_sidecar(data_dir, tmp_path):
    """The JAX frontend's client talks to the port's sidecar: hello with
    the ring, an image op unary and streamed (the same bytes as the port's
    handler), and the digest-first plane push."""
    sock = str(tmp_path / "port.sock")
    planes = (np.cumsum(np.random.default_rng(5).integers(
        -40, 41, size=(4, 256, 1024)), axis=-1) + 20000).astype(np.uint16)

    async def body(services):
        client = jax_sidecar.SidecarClient(sock, wire=JaxWire())
        try:
            ctx = JaxCtx.from_params(dict(PARAMS), None)
            status, unary = await client.call("image", ctx.to_json())
            chunks = [c async for c in client.call_stream(
                "image", ctx.to_json())]
            ring = client._conn.recv_ring is not None
            first = await client.stage_plane(planes)
            again = await client.stage_plane(planes)
            staged = services.raw_cache.get_by_digest(first[0])
            want = await ImageRegionHandler(services).render_image_region(
                ImageRegionCtx.from_params(dict(PARAMS), None))
            return status, unary, chunks, ring, first, again, staged, want
        finally:
            await client.close()

    status, unary, chunks, ring, first, again, staged, want = asyncio.run(
        _with_port_sidecar(_config(data_dir), sock, body))
    assert status == 200 and ring
    assert bytes(unary) == want and b"".join(chunks) == want
    digest = devicecache.plane_digest(planes)
    assert first == (digest, False) and again == (digest, True)
    assert np.array_equal(staged.view(torch.int16).numpy().view(np.uint16),
                          planes)


def test_port_sidecar_refuses_unknown_and_fleet_ops(data_dir, tmp_path):
    """The federation's five ops are served: with no manifest installed a
    sidecar answers them as a JAX one does (``enabled: false``, and the
    empty partition table); an op it does not know and a malformed
    plane_put answer 400."""
    sock = str(tmp_path / "ops.sock")

    async def body(services):
        client = sidecar.SidecarClient(sock)
        try:
            out = []
            for op in ("manifest_hello", "member_gossip", "epoch_propose",
                       "epoch_commit", "partition", "nonsense"):
                status, resp = await client.call(op, {})
                out.append((status, json.loads(bytes(resp))
                            if status == 200 else None))
            status, err = await client.call(
                "plane_put", {}, body=b"\0" * 10,
                extra={"digest": "", "dtype": "uint16", "shape": [4, 4]})
            out.append((status, None))
            ping = json.loads(bytes((await client.call("ping", {}))[1]))
            return out, ping
        finally:
            await client.close()

    answers, ping = asyncio.run(_with_port_sidecar(_config(data_dir), sock,
                                                   body))
    assert answers == [
        (200, {"enabled": False}), (200, {"enabled": False, "view": {}}),
        (200, {"enabled": False}), (200, {"enabled": False}),
        (200, {"rules": [], "quorum": None, "epoch": None}),
        (400, None), (400, None)]
    assert ping["ok"] and ping["prewarm_pending"] is False
