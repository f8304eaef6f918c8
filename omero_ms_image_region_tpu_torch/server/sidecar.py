"""The render sidecar: the frontend/device process boundary, wire v3.

Counterpart of the JAX package's ``server/sidecar.py``, byte-compatible
with it: a JAX frontend talks to a port sidecar and a port frontend to a
JAX one.  The reference isolates HTTP handling from rendering across the
Vert.x event bus (``ImageRegionVerticle.java:128-136``,
``ImageRegionMicroserviceVerticle.java:294-352``); here the bus is a unix
socket, or TCP for a ``host:port`` address, carrying length-prefixed JSON
and binary frames.  N frontend processes (HTTP parsing, sessions, status
mapping) share one sidecar process that owns the card, the batcher, the
pixel stores and the caches.  A frontend never touches the card: it builds
no device services, calls no ``torch.cuda`` function and holds no device
tensor, so it restarts in moments and a crash of it costs the card
nothing.

Wire format, little-endian (the ctx payloads are ``ImageRegionCtx
.to_json``, the reference's Jackson bus encoding)::

  frame:    u32 frame_len | payload
  request:  u32 header_len | header JSON {id, op, ctx, v} | body
  response: u32 header_len | header JSON {id, status, error?} | body

Responses are multiplexed by ``id`` and may arrive out of order.

Ops served: ``hello`` (the v3 negotiation; a fleet frontend's carries the
``member`` name, which stamps this process's flight events), ``image``
(with ``adopt: 0``, a fleet steal: rendered without inserting into the raw
cache) and ``mask`` (renders), ``plane_probe`` and ``plane_put`` (protocol
v2's digest-first plane push: ``plane_put`` stages through
``io.staging.stage_deduped``, packed and decoded by K10 where it pays),
``metrics``, ``ping``, ``explain``, ``flightrecorder``, ``decisions``,
``warmstate``, ``sentinel`` and ``profile``, and the fleet's
(``parallel.fleet.RemoteMember``): ``byte_probe``, ``byte_fetch`` (after
this process's ACL for the caller's session) and ``byte_put``
(digest-checked) on the byte tier a ``tier`` names (``region`` or
``mask``), ``shard_manifest`` (the raw cache's entries), ``prestage``
(entries re-read from this process's pixel store into its raw cache) and
``shard_transfer`` (a plane's bytes, digest-checked, staged under its
region key and route; the reply carries ``t_anchor``, ``ms`` and ``host``,
which the shipping host grafts as a clock-anchored span).  The
federation's ops (``parallel.federation``): ``manifest_hello`` (the
joiner's manifest against this process's, and this process's own ring
owners of the probe keys), ``member_gossip`` (the versioned member views,
this host's clock anchor, SLO buckets and sentinel summary),
``epoch_propose`` and ``epoch_commit`` (the two phases of a roll) and
``partition`` (this process's outbound link-partition rules, the netsplit
drill's; exempt from the partitions itself).  A fenced minority host
(quorum lost) refuses write authority (``byte_put`` answers ``stored:
false, fenced: true``) and inbound staging (``prestage`` and
``shard_transfer`` answer ``fenced: true``).  Any other op answers 400.

Fault-tolerance fields (optional): a request may carry ``deadline_ms``,
the requester's remaining budget, re-anchored on the sidecar's clock (a
spent budget answers 504 without rendering); a response may be a 503
(admission shed) with ``retry_after`` seconds, or a 504.  The client's
policy, an op-aware retry with capped backoff and jitter and a
consecutive-failure breaker (``utils.transient``), is
:class:`SidecarClient`'s; ``plane_put`` is never retried.

Protocol v3, three legs, each falling back to v2 against an older peer:

* **frame coalescing**: each connection's outbound frames queue in a
  :class:`FrameWriter` and leave as one vectored ``writelines`` and one
  ``drain()``;
* **chunk streaming**: a request with ``stream: 1`` may be answered as
  ordered chunk frames ``{id, seq}`` and a final ``{id, status, fin}``
  frame; the chunks concatenate to the v2 body;
* **a same-host shared-memory ring** (``server.shmring``), negotiated by
  ``hello``: bodies of at least ``wire.ring-min-body-bytes`` ride the ring
  with a ``ring: [offset, length]`` descriptor on the socket.

Sidecar units (:class:`SidecarUnit`, :class:`SidecarUnitLifecycle`): with
``autoscaler.unit-config`` a fleet frontend spawns each ``fleet.sockets``
member's sidecar itself, and the autoscaler stops a parked member's
process after its drain and restarts it, waiting for its socket, before
the undrain.

With ``federation.enabled`` :func:`run_sidecar` installs the manifest
(and the quorum tracker with ``federation.quorum``) and gossips with one
member of every other host on ``federation.gossip-interval-s``, so its own
quorum verdict, and its fence, are local knowledge.  The client
(:class:`SidecarClient`) of a member on another host carries that host
(``peer_host``), and a partition rule from this host to it fails its calls
as a dead wire.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import os
import struct
import time
from typing import Deque, Dict, List, Optional, Tuple

from ..utils import telemetry
from . import sentinel as sentinel_mod
from .ctx import ImageRegionCtx, ShapeMaskCtx
from .errors import BadRequestError, NotFoundError
from .shmring import RingError, ShmRing

logger = logging.getLogger("omero_ms_image_region_tpu_torch.sidecar")

_MAX_FRAME = 256 * 1024 * 1024
# Sent in every request header: 2 = the digest-first plane ops, 3 = the
# streaming wire (hello, chunked answers, ring descriptors).
WIRE_VERSION = 3


def parse_address(addr: str):
    """``host:port`` or ``[v6]:port`` -> ("tcp", host, port); anything else
    is a unix socket path -> ("unix", path, None)."""
    if addr.startswith("["):
        host, sep, port = addr.partition("]:")
        if sep and port.isdigit():
            return ("tcp", host[1:], int(port))
        return ("unix", addr, None)
    if "/" not in addr and addr.count(":") == 1:
        host, _, port = addr.partition(":")
        if port.isdigit():
            return ("tcp", host or "127.0.0.1", int(port))
    return ("unix", addr, None)


def _set_nodelay(writer: asyncio.StreamWriter) -> None:
    """Small frames must not wait behind Nagle's algorithm on TCP."""
    import socket as pysocket

    sock = writer.get_extra_info("socket")
    if sock is not None and sock.family in (pysocket.AF_INET,
                                            pysocket.AF_INET6):
        try:
            sock.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        except OSError:
            pass


async def open_sidecar_connection(addr: str):
    kind, host, port = parse_address(addr)
    if kind == "tcp":
        reader, writer = await asyncio.open_connection(host, port)
        _set_nodelay(writer)
        return reader, writer
    return await asyncio.open_unix_connection(host)


def _pack(header: dict, body: bytes = b"") -> bytes:
    h = json.dumps(header).encode()
    return (struct.pack("<II", 4 + len(h) + len(body), len(h))
            + h + bytes(body))


def _pack_prefix(header: dict, body_len: int) -> bytes:
    """A frame's lengths and header without its body (a large body is
    written as its own buffer, not copied into one frame)."""
    h = json.dumps(header).encode()
    return struct.pack("<II", 4 + len(h) + body_len, len(h)) + h


async def _read_frame(reader: asyncio.StreamReader):
    raw_len = await reader.readexactly(4)
    (frame_len,) = struct.unpack("<I", raw_len)
    if frame_len > _MAX_FRAME:
        raise ValueError(f"frame of {frame_len} bytes exceeds limit")
    payload = await reader.readexactly(frame_len)
    (header_len,) = struct.unpack("<I", payload[:4])
    header = json.loads(payload[4:4 + header_len])
    return header, payload[4 + header_len:]


def _ring_body(ring: Optional[ShmRing], header: dict, body: bytes):
    """A frame's body: a ``ring: [off, len]`` descriptor reads (and
    releases) the ring; anything else is the socket body.  A descriptor on
    a connection with no ring, or outside the live window, raises
    :class:`RingError` (a clean protocol error, never a stray read)."""
    rd = header.get("ring")
    if rd is None:
        return body
    if ring is None:
        raise RingError("ring descriptor on a connection with no "
                        "negotiated ring")
    if not isinstance(rd, (list, tuple)) or len(rd) != 2:
        raise RingError(f"malformed ring descriptor {rd!r}")
    return ring.read_release(rd[0], rd[1])


class FrameWriter:
    """A connection's scatter-gather frame writer (v3 leg 1).

    Frames queue here and one flusher task hands the backlog to
    ``writer.writelines`` with one ``drain()`` per flush, so N small frames
    cost one syscall.  No lock is held across ``drain()``: a slow reader
    holds back the flusher only, and the frames queued meanwhile coalesce
    into the next flush.  With a negotiated ring (:attr:`ring`) a body of
    at least :attr:`ring_min_bytes` rides it and the frame shrinks to a
    descriptor; a full ring falls back to a socket body for that frame.
    Ring allocations happen when a frame is queued, on the event loop, so
    descriptors reach the socket in allocation order, which the reader's
    in-order release needs."""

    def __init__(self, writer: asyncio.StreamWriter, max_frames: int = 64,
                 max_bytes: int = 1 << 20):
        self.writer = writer
        self.max_frames = max(1, int(max_frames))
        self.max_bytes = max(4096, int(max_bytes))
        self.ring: Optional[ShmRing] = None
        self.ring_min_bytes = 4096
        self._pending: Deque[tuple] = collections.deque()
        self._wake = asyncio.Event()
        self._dead: Optional[BaseException] = None
        self._task: Optional[asyncio.Task] = \
            asyncio.create_task(self._flush_loop())

    def _buffers(self, header: dict, body) -> list:
        n = len(body) if body else 0
        if self.ring is not None and n >= self.ring_min_bytes:
            off = self.ring.alloc_write(body)
            if off is not None:
                header = dict(header)
                header["ring"] = [off, n]
                telemetry.WIRE.count_ring(n, hit=True)
                return [_pack_prefix(header, 0)]
            telemetry.WIRE.count_ring(n, hit=False)
        prefix = _pack_prefix(header, n)
        if not n:
            return [prefix]
        return [prefix, body if isinstance(body, (bytes, memoryview))
                else memoryview(body)]

    async def send(self, header: dict, body=b"") -> None:
        """Queue one frame and wait until its flush drained."""
        if self._dead is not None:
            raise ConnectionError(str(self._dead) or "wire writer closed")
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((self._buffers(header, body), fut))
        self._wake.set()
        await fut

    async def _flush_loop(self) -> None:
        try:
            while True:
                await self._wake.wait()
                self._wake.clear()
                while self._pending:
                    batch = []
                    nbytes = 0
                    while (self._pending and len(batch) < self.max_frames
                           and nbytes < self.max_bytes):
                        bufs, fut = self._pending.popleft()
                        batch.append((bufs, fut))
                        nbytes += sum(len(b) for b in bufs)
                    try:
                        self.writer.writelines(
                            [b for bufs, _ in batch for b in bufs])
                        await self.writer.drain()
                    except asyncio.CancelledError:
                        self._fail(ConnectionError("wire writer closed"),
                                   batch)
                        raise
                    except Exception as e:
                        # Any failure must fail the parked senders.
                        self._fail(e, batch)
                        return
                    telemetry.WIRE.observe_flush(len(batch), nbytes)
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_result(None)
        except asyncio.CancelledError:
            self._fail(ConnectionError("wire writer closed"), ())
            raise

    def _fail(self, exc: BaseException, batch) -> None:
        self._dead = exc
        for _, fut in list(batch) + list(self._pending):
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    def close(self) -> None:
        """Stop the flusher and fail the queued senders; idempotent."""
        if self._dead is None:
            self._dead = ConnectionError("wire writer closed")
        task, self._task = self._task, None
        if task is not None:
            task.cancel()


# ---------------------------------------------------------------- server

async def _plane_put(image_handler, header: dict, req_body: bytes) -> bytes:
    """Stage a pushed plane into the raw cache (protocol v2).  The claimed
    digest is checked against the bytes before anything is cached (the
    socket is unauthenticated): a mismatch is a 400, never an entry."""
    import numpy as np

    cache = getattr(getattr(image_handler, "s", None), "raw_cache", None)
    if cache is None or not getattr(cache, "digest_index", False):
        raise BadRequestError(
            "device plane cache is disabled on this sidecar "
            "(raw-cache.enabled / raw-cache.digest-dedup)")
    digest = str(header.get("digest") or "")
    try:
        dtype = np.dtype(str(header["dtype"]))
        shape = tuple(int(s) for s in header["shape"])
        if dtype.kind not in "uif":
            raise ValueError(f"non-numeric dtype {dtype}")
    except (KeyError, TypeError, ValueError) as e:
        raise BadRequestError(f"malformed plane_put header: {e}")
    if not shape or any(s <= 0 for s in shape):
        raise BadRequestError(f"plane_put shape {list(shape)} must be "
                              f"all-positive")
    expected = int(np.prod(shape)) * dtype.itemsize
    if expected != len(req_body):
        raise BadRequestError(
            f"plane_put body is {len(req_body)} bytes, shape/dtype say "
            f"{expected}")
    arr = np.frombuffer(req_body, dtype).reshape(shape)

    def stage_verified():
        from ..io.devicecache import plane_digest
        from ..io.staging import stage_deduped
        actual = plane_digest(arr)
        if digest and digest != actual:
            raise BadRequestError(
                f"plane_put digest mismatch: claimed {digest}, content is "
                f"{actual}")
        _, _, was_resident = stage_deduped(arr, cache, digest=actual)
        return actual, was_resident

    # Digest, pack and copy are host and link work: off the event loop.
    actual, was_resident = await asyncio.to_thread(stage_verified)
    return json.dumps({"digest": actual,
                       "resident": was_resident}).encode()


def _byte_stack(image_handler, header: dict):
    """(services, the byte-cache chain a byte op names): ``tier: "mask"``
    the shape-mask chain, else the rendered tiles'."""
    services = getattr(image_handler, "s", None)
    caches = getattr(services, "caches", None)
    name = ("shape_mask" if str(header.get("tier") or "region") == "mask"
            else "image_region")
    return services, getattr(caches, name, None)


async def _byte_op(image_handler, op: str, header: dict,
                   req_body: bytes) -> bytes:
    """The fleet's byte-tier ops (JAX ``:730-816``): ``byte_probe``
    (presence of N keys, no ACL: a key derives from request parameters,
    never pixels), ``byte_fetch`` (the bytes, after this process's ACL for
    the caller's session; a miss is a 404) and ``byte_put`` (a thief's
    write-back, its body checked against the claimed digest)."""
    import hashlib

    from .handler import check_can_read

    services, stack = _byte_stack(image_handler, header)
    enabled = bool(stack is not None and getattr(stack, "enabled", False))
    if op == "byte_probe":
        keys = header.get("keys")
        if not isinstance(keys, list):
            keys = [header.get("key")]
        present = [bool(enabled and k
                        and await stack.get(str(k)) is not None)
                   for k in keys]
        return json.dumps({"enabled": enabled,
                           "present": present}).encode()
    key = str(header.get("key") or "")
    if op == "byte_fetch":
        data = await stack.get(key) if stack is not None and key else None
        if data is None:
            raise NotFoundError(f"byte tier miss for {key!r}")
        image_id = header.get("image_id")
        if image_id is not None and services is not None:
            obj = str(header.get("obj") or "Image")
            if obj not in ("Image", "Mask"):
                raise BadRequestError(f"byte_fetch obj {obj!r} unsupported")
            if not await check_can_read(services, obj, int(image_id),
                                        header.get("session")):
                raise NotFoundError(f"Cannot find {obj}:{image_id}")
        return bytes(data)
    if not key:
        raise BadRequestError("byte_put requires a key")
    value = bytes(req_body)
    claimed = str(header.get("digest") or "")
    if claimed:
        actual = hashlib.blake2b(value, digest_size=16).hexdigest()
        if actual != claimed:
            raise BadRequestError(f"byte_put digest mismatch: claimed "
                                  f"{claimed}, body is {actual}")
    from ..parallel import federation
    fenced = not federation.quorum_allow("write_authority")
    stored = False
    if enabled and not fenced:
        await stack.set(key, value)
        stored = True
    # A fenced minority refuses write authority (counted) and answers: the
    # put is fire and forget.
    doc = {"stored": stored}
    if fenced:
        doc["fenced"] = True
    return json.dumps(doc).encode()


async def _prestage(image_handler, header: dict) -> bytes:
    """``prestage``: the handed entries re-read from this process's pixel
    store into its raw cache (``services.warmstate.restage_plane_entry``),
    best effort an entry, off the loop."""
    from ..services.warmstate import restage_plane_entry

    services = getattr(image_handler, "s", None)
    cache = getattr(services, "raw_cache", None)
    pixels = getattr(services, "pixels_service", None)
    entries = header.get("entries") or []
    if not isinstance(entries, list):
        raise BadRequestError("prestage entries must be a list")

    def stage_all() -> int:
        staged = 0
        for entry in entries:
            try:
                if restage_plane_entry(cache, pixels, entry):
                    staged += 1
            except Exception:
                continue        # a bad entry is a cold miss later
        return staged

    from ..parallel import federation
    if not federation.quorum_allow("transfer"):
        # Fenced: inbound staging is shard adoption by another name.
        return json.dumps({"staged": 0, "fenced": True}).encode()
    staged = (await asyncio.to_thread(stage_all)
              if cache is not None and pixels is not None else 0)
    return json.dumps({"staged": staged}).encode()


async def _shard_transfer(image_handler, header: dict,
                          req_body: bytes) -> bytes:
    """``shard_transfer``: one plane's bytes staged into the raw cache
    under its region key and route, as if read from this process's store.
    The claimed digest is checked before anything is cached (the socket is
    unauthenticated)."""
    import numpy as np

    from ..io.devicecache import plane_digest, region_key

    cache = getattr(getattr(image_handler, "s", None), "raw_cache", None)
    if cache is None:
        raise BadRequestError("device plane cache is disabled on this "
                              "sidecar (raw-cache.enabled)")
    entry = header.get("entry")
    if not isinstance(entry, dict):
        raise BadRequestError("shard_transfer requires an entry doc")
    digest = str(entry.get("digest") or "")
    try:
        image_id, z, t, level, region, channels = entry["key"]
        key = region_key(int(image_id), int(z), int(t), int(level),
                         tuple(int(v) for v in region),
                         tuple(int(c) for c in channels))
        dtype = np.dtype(str(entry["dtype"]))
        shape = tuple(int(s) for s in entry["shape"])
        if dtype.kind not in "uif":
            raise ValueError(f"non-numeric dtype {dtype}")
    except (KeyError, TypeError, ValueError) as e:
        raise BadRequestError(f"malformed shard_transfer entry: {e}")
    if not shape or any(s <= 0 for s in shape):
        raise BadRequestError(f"shard_transfer shape {list(shape)} must be "
                              f"all-positive")
    expected = int(np.prod(shape)) * dtype.itemsize
    if expected != len(req_body):
        raise BadRequestError(
            f"shard_transfer body is {len(req_body)} bytes, shape/dtype "
            f"say {expected}")
    arr = np.frombuffer(req_body, dtype).reshape(shape)
    route = entry.get("route")

    def stage_verified() -> str:
        actual = plane_digest(arr)
        if digest and digest != actual:
            raise BadRequestError(f"shard_transfer digest mismatch: "
                                  f"claimed {digest}, content is {actual}")
        cache.get_or_load(key, lambda: arr, digest=actual,
                          route_key=str(route) if route else None)
        return actual

    from ..parallel import federation
    t_anchor = time.perf_counter()
    actual = await asyncio.to_thread(stage_verified)
    stage_ms = (time.perf_counter() - t_anchor) * 1000.0
    telemetry.FEDERATION.count_transfer(len(req_body))
    # The anchor: this process's perf-clock instant the stage started, its
    # length and this host, which the shipping host grafts into its trace
    # (``federation.anchor_remote_time``).
    return json.dumps({"staged": True, "digest": actual,
                       "t_anchor": t_anchor,
                       "ms": round(stage_ms, 3),
                       "host": federation.self_host()}).encode()


_FEDERATION_OPS = ("manifest_hello", "member_gossip", "epoch_propose",
                   "epoch_commit", "partition")


def _federation_op(op: str, header: dict) -> dict:
    """The federation's ops (JAX ``:867-945``), answered from this
    process's installed manifest (``{"enabled": false}`` with none).
    ``partition`` edits this process's outbound link rules
    (``utils.faultinject.PARTITIONS``): ``action`` add, remove, clear or
    show; its answer carries the rules, the quorum and the active epoch,
    so a drill can watch a healed host converge."""
    from ..parallel import federation
    from ..utils import faultinject

    if op == "manifest_hello":
        return federation.handle_manifest_hello(header)
    if op == "member_gossip":
        return federation.handle_member_gossip(header)
    if op == "epoch_propose":
        return federation.handle_epoch_propose(header)
    if op == "epoch_commit":
        return federation.handle_epoch_commit(header)
    action = str(header.get("action") or "show")
    src = str(header.get("src") or "")
    dst = str(header.get("dst") or "")
    both = bool(header.get("bidirectional"))
    try:
        if action == "add":
            faultinject.PARTITIONS.add(
                src, dst, mode=str(header.get("mode") or "drop"),
                bidirectional=both)
        elif action == "remove":
            faultinject.PARTITIONS.remove(src, dst, bidirectional=both)
        elif action == "clear":
            faultinject.PARTITIONS.clear()
        elif action != "show":
            raise BadRequestError(f"partition action {action!r} must be "
                                  f"add/remove/clear/show")
    except ValueError as e:
        raise BadRequestError(str(e))
    active = federation.current()
    return {"rules": faultinject.PARTITIONS.snapshot(),
            "quorum": federation.quorum_status(),
            "epoch": active.version if active is not None else None}


def _server_hello(header: dict, frames: FrameWriter, wire) -> tuple:
    """The sidecar's side of ``hello``: attach the client's ring segments
    when offered (and ``wire.ring-bytes`` is not 0), answer the feature
    document.  Returns ``(body, recv_ring, attached)``.  Any attach
    failure (a TCP peer on another host, no ``/dev/shm``, a size that
    disagrees) answers ``ring: false``: socket bodies, never an error."""
    ring_ok = False
    recv_ring = None
    attached: list = []
    rings = header.get("rings")
    ring_enabled = wire is None or wire.ring_bytes > 0
    if isinstance(rings, dict) and ring_enabled:
        try:
            c2s_spec, s2c_spec = rings["c2s"], rings["s2c"]
            c2s = ShmRing.attach(str(c2s_spec["name"]),
                                 int(c2s_spec["size"]))
            attached.append(c2s)
            s2c = ShmRing.attach(str(s2c_spec["name"]),
                                 int(s2c_spec["size"]))
            attached.append(s2c)
            recv_ring = c2s
            frames.ring = s2c
            if wire is not None:
                frames.ring_min_bytes = wire.ring_min_body_bytes
            ring_ok = True
        except Exception as e:
            for r in attached:
                r.close()
            attached = []
            recv_ring = None
            frames.ring = None
            logger.info("shm ring negotiation failed (%s); socket bodies",
                        e)
    member = header.get("member")
    if isinstance(member, str) and member:
        # The frontend's fleet name for this sidecar: its flight events
        # carry it from here on (re-stamped at each hello).
        telemetry.FLIGHT.set_member(member[:32])
    telemetry.WIRE.count_negotiation(ring=ring_ok)
    # ``clock``: this process's perf_counter, from which the client derives
    # the offset that maps exported span anchors onto its timeline.
    body = json.dumps({"v": WIRE_VERSION, "ring": ring_ok,
                       "clock": time.perf_counter()}).encode()
    return body, recv_ring, attached


def _metrics_body(image_handler) -> bytes:
    """The ``metrics`` op: this process's series (spans, caches, batcher,
    resilience, wire, pressure, watchdog, sentinel), each labelled
    ``process="sidecar"``; the frontend merges them into its scrape."""
    from ..utils.stopwatch import span_lines
    lines = span_lines() + telemetry.resilience_metric_lines()
    services = getattr(image_handler, "s", None)
    if services is not None:
        lines += telemetry.device_metric_lines(services)
    lines += telemetry.SENTINEL.metric_lines()
    lines = telemetry.with_label(lines, 'process="sidecar"')
    return ("\n".join(lines) + "\n").encode()


async def _serve_connection(image_handler, mask_handler, reader, writer,
                            status_fn=None, profile_fn=None,
                            warmstate_fn=None, wire=None):
    """One frontend connection: read frames, run each request as a task.

    ``status_fn`` answers ``ping`` (the frontend's ``/readyz`` folds it in),
    ``profile_fn(ms)`` serves ``profile`` (a capture in this process, which
    owns the card), ``warmstate_fn(snapshot)`` serves ``warmstate``; None
    refuses the op.  ``wire`` is the ``WireConfig`` (None: defaults)."""
    frames = FrameWriter(
        writer,
        max_frames=wire.coalesce_max_frames if wire is not None else 64,
        max_bytes=wire.coalesce_max_bytes if wire is not None else 1 << 20)
    chunk_max = wire.chunk_max_bytes if wire is not None else 256 * 1024
    tasks = set()
    # The client's c2s ring (attached at hello): request-body descriptors.
    ring_state: dict = {"recv": None, "attached": []}

    async def respond(header: dict, body=b"") -> None:
        await frames.send(header, body)

    async def handle(header: dict, req_body: bytes = b"") -> None:
        from ..utils import faultinject, transient
        from .errors import OverloadedError

        rid = header.get("id")
        spans = costs = anchor = prov = None
        quality_capped = False
        inj = faultinject.active()
        if inj is not None and inj.sidecar_should_die():
            # The supervision drill: die mid-call, as a crash does.
            logger.error("fault injection: sidecar self-kill "
                         "(die-after-requests)")
            os._exit(23)
        budget = header.get("deadline_ms")
        try:
            budget = float(budget) if budget is not None else None
        except (TypeError, ValueError):
            budget = None
        # The task's own context: set, never reset (it dies with the task).
        transient.set_task_deadline(budget)
        op = header.get("op")
        try:
            transient.check_deadline(f"sidecar {op}")
            if op == "image" or op == "mask":
                # The requester's trace id rides the wire: the spans
                # recorded here are sent back with the answer.  A sidecar
                # in the frontend's own process (tests) shares the live
                # trace and neither exports nor finishes it.
                trace_id = header.get("trace")
                shared = bool(trace_id
                              and telemetry.TRACES.is_active(trace_id))
                ctx = None
                try:
                    with telemetry.adopt_trace(trace_id):
                        t0 = time.perf_counter()
                        if op == "image":
                            ctx = ImageRegionCtx.from_json(header["ctx"])
                            if header.get("adopt") in (0, False):
                                # A fleet steal: the plane's shard stays
                                # with its ring owner.
                                body = await \
                                    image_handler.render_image_region(
                                        ctx, adopt_cache=False)
                            else:
                                body = await \
                                    image_handler.render_image_region(ctx)
                        else:
                            ctx = ShapeMaskCtx.from_json(header["ctx"])
                            body = await mask_handler.render_shape_mask(ctx)
                        elapsed_ms = (time.perf_counter() - t0) * 1000.0
                        telemetry.record_span("sidecar.render", t0,
                                              elapsed_ms)
                        engine = sentinel_mod.active()
                        if engine is not None:
                            engine.observe(
                                "render_image_region" if op == "image"
                                else "shape_mask", len(body), elapsed_ms,
                                trace_id)
                        # The brownout cap rides the reply: the frontend
                        # strips the cache headers of capped bytes.
                        quality_capped = bool(getattr(
                            ctx, "_pressure_quality_capped", False))
                finally:
                    if trace_id and not shared:
                        trace = telemetry.TRACES.finish(trace_id)
                        if trace is not None:
                            spans = trace.export_spans()
                            costs = trace.export_costs()
                            anchor = trace.t0
                    if ctx is not None:
                        from ..utils import provenance
                        prov = provenance.marks(ctx) or None
            elif op == "metrics":
                body = _metrics_body(image_handler)
            elif op == "plane_probe":
                cache = getattr(getattr(image_handler, "s", None),
                                "raw_cache", None)
                enabled = bool(cache is not None
                               and getattr(cache, "digest_index", False))
                # enabled=false tells the client to skip the put.
                doc = {"enabled": enabled}
                digests = header.get("digests")
                if isinstance(digests, list):
                    doc["resident"] = [
                        bool(enabled and d
                             and cache.resident_digest(str(d)))
                        for d in digests]
                else:
                    digest = str(header.get("digest") or "")
                    doc["resident"] = bool(
                        enabled and digest
                        and cache.resident_digest(digest))
                body = json.dumps(doc).encode()
            elif op == "plane_put":
                body = await _plane_put(image_handler, header, req_body)
            elif op in ("byte_probe", "byte_fetch", "byte_put"):
                body = await _byte_op(image_handler, op, header, req_body)
            elif op == "shard_manifest":
                cache = getattr(getattr(image_handler, "s", None),
                                "raw_cache", None)
                entries = (cache.snapshot_entries(
                    int(header.get("limit", 0) or 0))
                    if cache is not None else [])
                body = json.dumps({"entries": entries}).encode()
            elif op == "prestage":
                body = await _prestage(image_handler, header)
            elif op == "shard_transfer":
                from ..parallel import federation
                if not federation.quorum_allow("transfer"):
                    # Fenced: taking another host's shard bytes is the
                    # adoption a partition forbids.
                    body = json.dumps({"staged": False,
                                       "fenced": True}).encode()
                else:
                    body = await _shard_transfer(image_handler, header,
                                                 req_body)
            elif op in _FEDERATION_OPS:
                body = json.dumps(_federation_op(op, header)).encode()
            elif op == "explain":
                # Read-only residency probe of the /debug/explain plane.
                from .explain import residency_doc
                services = getattr(image_handler, "s", None)
                doc = await residency_doc(
                    getattr(getattr(services, "caches", None),
                            "image_region", None),
                    getattr(services, "raw_cache", None),
                    str(header.get("key") or ""),
                    str(header.get("route") or ""))
                doc["prewarm_pending"] = telemetry.READINESS.prewarm_pending
                body = json.dumps(doc).encode()
            elif op == "ping":
                doc = status_fn() if status_fn is not None else {"ok": True}
                body = json.dumps(doc).encode()
            elif op == "flightrecorder":
                body = json.dumps({
                    "events": telemetry.FLIGHT.snapshot(),
                    "events_total": telemetry.FLIGHT.events_total,
                    "dumps_written": telemetry.FLIGHT.dumps_written,
                }).encode()
            elif op == "decisions":
                from ..utils import decisions
                body = json.dumps({
                    "ring": decisions.LEDGER.snapshot(
                        int(header.get("limit", 0) or 0)),
                    "status": decisions.LEDGER.status(),
                }).encode()
            elif op == "warmstate":
                if warmstate_fn is None:
                    raise BadRequestError(
                        "warm-state persistence is not enabled on this "
                        "sidecar")
                doc = await asyncio.to_thread(
                    warmstate_fn, bool(header.get("snapshot")))
                body = json.dumps(doc).encode()
            elif op == "sentinel":
                engine = sentinel_mod.active()
                doc = dict(telemetry.SENTINEL.merged())
                doc["local"] = (engine.summary() if engine is not None
                                else None)
                body = json.dumps(doc).encode()
            elif op == "profile":
                if profile_fn is None:
                    raise BadRequestError(
                        "profiling is not available on this sidecar")
                try:
                    ms = float(header.get("ms", 500.0))
                except (TypeError, ValueError):
                    raise BadRequestError("profile ms must be a number")
                doc = await asyncio.to_thread(profile_fn, ms)
                body = json.dumps(doc).encode()
            else:
                raise BadRequestError(f"unknown op {op!r}")
        except telemetry.ProfileInProgressError as e:
            body, out = b"", {"id": rid, "status": 409, "error": str(e)}
        except transient.DeadlineExceededError as e:
            # 504, and the client does not retry it.
            body, out = b"", {"id": rid, "status": 504, "error": str(e)}
        except OverloadedError as e:
            body, out = b"", {"id": rid, "status": 503, "error": str(e),
                              "retry_after": e.retry_after_s}
        except BadRequestError as e:
            body, out = b"", {"id": rid, "status": 400, "error": str(e)}
        except (NotFoundError, FileNotFoundError):
            body, out = b"", {"id": rid, "status": 404}
        except Exception:
            logger.exception("sidecar render failed")
            body, out = b"", {"id": rid, "status": 500}
        else:
            out = {"id": rid, "status": 200}
        if spans:
            out["spans"] = spans
            if anchor is not None:
                out["t_anchor"] = anchor
        if costs:
            out["costs"] = costs
        if prov:
            out["prov"] = prov
        if quality_capped:
            out["quality_capped"] = 1
        if out["status"] >= 400:
            telemetry.FLIGHT.record("sidecar.op-error", op=op,
                                    status=out["status"])
        try:
            if (header.get("stream") and out["status"] == 200 and body
                    and op in ("image", "mask")):
                # v3 leg 2: ordered chunk frames, then the fin frame with
                # the status and the exports.
                mv = memoryview(body)
                seq = 0
                for off in range(0, len(mv), chunk_max):
                    await respond({"id": rid, "seq": seq},
                                  mv[off:off + chunk_max])
                    seq += 1
                out["fin"] = True
                out["chunks"] = seq
                telemetry.WIRE.count_stream(seq)
                await respond(out)
            else:
                await respond(out, body)
        except (ConnectionError, OSError):
            # The frontend went away; the render itself finished.
            logger.debug("frontend went away before response %s", rid)

    try:
        while True:
            try:
                header, req_body = await _read_frame(reader)
            except (asyncio.IncompleteReadError, ConnectionResetError):
                break
            except ValueError as e:
                # Oversize, bad lengths or broken JSON: a clean protocol
                # error, then the connection closes.
                telemetry.FLIGHT.record("wire.frame-error",
                                        error=str(e)[:120])
                try:
                    await respond({"id": None, "status": 400,
                                   "error": f"malformed frame: {e}"})
                except (ConnectionError, OSError):
                    pass
                break
            try:
                req_body = _ring_body(ring_state["recv"], header, req_body)
            except RingError as e:
                # A descriptor outside the window breaks the ring's
                # release order: answer the op, then drop the connection.
                telemetry.FLIGHT.record("wire.ring-error",
                                        error=str(e)[:120])
                try:
                    await respond({"id": header.get("id"), "status": 400,
                                   "error": f"bad ring descriptor: {e}"})
                except (ConnectionError, OSError):
                    pass
                break
            if header.get("op") == "hello":
                # Inline, not a task: the ring must be live before a later
                # frame's descriptor is read.
                body, recv_ring, attached = _server_hello(header, frames,
                                                          wire)
                ring_state["recv"] = recv_ring
                ring_state["attached"] += attached
                try:
                    await respond({"id": header.get("id"), "status": 200},
                                  body)
                except (ConnectionError, OSError):
                    break
                continue
            t = asyncio.create_task(handle(header, req_body))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
    finally:
        # Cancel and await the request tasks: the teardown must not close
        # services under a render still unwinding.
        for t in list(tasks):
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        frames.close()
        for r in ring_state["attached"]:
            r.close()          # the client created the segments
        writer.close()


async def run_sidecar(config, socket_path: Optional[str] = None,
                      services_out: Optional[dict] = None,
                      device="cuda") -> None:
    """Serve renders on the socket until cancelled, owning the card's
    whole stack (``server.app.build_services``): the batcher, the raw
    cache, the byte caches, and, as the config says, the watchdog over the
    batcher's lanes, the pressure governor and the perf sentinel.
    ``services_out`` receives the services under ``"services"`` (the
    process entry's shutdown chain snapshots them on SIGTERM)."""
    from .app import build_services
    from .handler import ImageRegionHandler, ShapeMaskHandler

    socket_path = socket_path or config.sidecar.socket
    kind, host, port = parse_address(socket_path)
    # A stale socket from a crashed run is cleared; a live one is not
    # taken over (a second sidecar would split the serving state).  The
    # probe runs before the card's stack is built.
    if kind == "unix" and os.path.exists(socket_path):
        probe_ok = False
        try:
            _r, _w = await asyncio.wait_for(
                asyncio.open_unix_connection(socket_path), timeout=2.0)
            _w.close()
            probe_ok = True
        except (OSError, asyncio.TimeoutError):
            pass
        if probe_ok:
            raise RuntimeError(f"another render sidecar is already "
                               f"serving on {socket_path}")
        os.unlink(socket_path)

    services = build_services(config, device)
    if services_out is not None:
        services_out["services"] = services
    from ..parallel import federation
    fed = config.federation
    fed_manifest = None
    if fed.enabled:
        # The federation's ops answer from this process's own copy of the
        # agreed membership.
        fed_manifest = federation.FleetManifest.from_config(fed)
        federation.install(fed_manifest, self_host=fed.host)
        if fed.quorum:
            federation.install_quorum(federation.QuorumTracker(
                fed_manifest, self_host=fed.host,
                suspect_after_s=fed.suspect_after_s))
    db_metadata = None
    if config.metadata_backend == "postgres":
        from ..services.db_metadata import PostgresMetadataService
        try:
            services.metadata = db_metadata = \
                await PostgresMetadataService.connect(config.metadata_dsn)
        except ImportError:
            logger.warning("metadata-service.type is 'postgres' but "
                           "asyncpg is unavailable; using the local "
                           "backend")
    image_handler = ImageRegionHandler(services)
    mask_handler = ShapeMaskHandler(services, config.workloads.device_masks)

    from . import pressure as pressure_mod
    from .watchdog import build_watchdog
    background: list = []
    governor = None
    if config.pressure.enabled:
        pressure_mod.apply_cgroup_rss_defaults(config.pressure)
        gov_ref: list = []
        governor = pressure_mod.PressureGovernor(
            config.pressure,
            pressure_mod.build_actuators(config.pressure, services=services),
            pressure_mod.build_sources(services=services,
                                       governor_ref=gov_ref))
        gov_ref.append(governor)
        pressure_mod.install(governor)
        background.append(asyncio.create_task(governor.run(),
                                              name="pressure-governor"))
    if config.watchdog.enabled:
        def escalate(event: dict) -> None:
            telemetry.FLIGHT.record("watchdog.escalate", **{
                k: v for k, v in event.items() if k != "escalate"})
            logger.error("watchdog escalation: %s on %s",
                         event.get("action"), event.get("target"))

        wd = build_watchdog(config.watchdog, renderer=services.renderer,
                            escalate_cb=escalate)
        if wd._targets:
            background.append(asyncio.create_task(wd.run(),
                                                  name="watchdog"))
    if fed_manifest is not None and fed.gossip_interval_s > 0:
        # The host-level gossip: this process runs its own failure
        # detector against one member of every other host, so its quorum
        # verdict is its own knowledge.  No router: it gossips and answers
        # rolls.
        from ..parallel.fleet import RemoteMember
        handles = []
        seen_hosts: set = set()
        for spec in fed_manifest.remote_members(fed.host):
            if spec.host in seen_hosts or not spec.address:
                continue
            seen_hosts.add(spec.host)
            peer = SidecarClient(spec.address, wire=config.wire)
            peer.peer_host = spec.host
            handles.append(RemoteMember(spec.name, peer))
        if handles:
            coordinator = federation.FederationCoordinator(
                fed_manifest, self_host=fed.host,
                gossip_interval_s=fed.gossip_interval_s, handles=handles)
            background.append(asyncio.create_task(
                coordinator.run(), name="federation-gossip"))
    # The sidecar sketches its own render latency; the frontend folds its
    # summary into /debug/sentinel over the ``sentinel`` op (and a
    # federated host's rides its gossip answers).
    sentinel_engine = None
    if config.sentinel.enabled:
        sentinel_engine = sentinel_mod.engine_from_config(
            config.sentinel, member=fed.host if fed.enabled else "sidecar")
        sentinel_mod.install(sentinel_engine)
        background.append(asyncio.create_task(sentinel_engine.run(),
                                              name="perf-sentinel"))

    def status_fn() -> dict:
        """The ``ping`` answer, which the frontend's /readyz folds in."""
        renderer = services.renderer
        doc = {"ok": True,
               "prewarm_pending": telemetry.READINESS.prewarm_pending,
               "queue_depth": (renderer.queue_depth()
                               if hasattr(renderer, "queue_depth") else 0)}
        if telemetry.READINESS.prewarm_failed:
            doc["prewarm_failed"] = telemetry.READINESS.prewarm_failed
        if services.warmstate is not None:
            doc["rehydrate"] = telemetry.PERSIST.rehydrate_summary()
        quorum = federation.quorum_status()
        if quorum is not None:
            # An annotation, not unreadiness: a fenced host keeps serving
            # its own shards.
            doc["quorum"] = quorum
        return doc

    def profile_fn(ms: float) -> dict:
        return telemetry.capture_profile(
            config.telemetry.profile_dir,
            max(1.0, min(ms, config.telemetry.profile_max_ms)))

    warmstate_fn = None
    if services.warmstate is not None:
        def warmstate_fn(snapshot: bool) -> dict:
            doc = {"enabled": True,
                   "rehydrate": telemetry.PERSIST.rehydrate_summary(),
                   "snapshots": telemetry.PERSIST.snapshots,
                   "snapshot_errors": telemetry.PERSIST.snapshot_errors}
            if snapshot:
                doc["snapshot_path"] = services.warmstate.snapshot_now()
            return doc

    # Server.close() stops the listener only: the connections are tracked
    # and cancelled at teardown, so none serves from closing services.
    conn_tasks: set = set()

    async def on_conn(reader, writer):
        _set_nodelay(writer)
        task = asyncio.current_task()
        conn_tasks.add(task)
        try:
            await _serve_connection(image_handler, mask_handler, reader,
                                    writer, status_fn=status_fn,
                                    profile_fn=profile_fn,
                                    warmstate_fn=warmstate_fn,
                                    wire=config.wire)
        finally:
            conn_tasks.discard(task)

    if kind == "tcp":
        server = await asyncio.start_server(on_conn, host, port)
        bound_ino = None
    else:
        server = await asyncio.start_unix_server(on_conn, path=socket_path)
        bound_ino = os.stat(socket_path).st_ino
    logger.info("render sidecar serving on %s", socket_path)
    try:
        # Not serve_forever(): its wait_closed() on cancellation waits for
        # every live connection, which the frontends hold open.  Park,
        # then close the listener, cancel the connections, and only then
        # wait.
        await asyncio.Event().wait()
    finally:
        server.close()
        for task in background:
            task.cancel()
        if background:
            await asyncio.gather(*background, return_exceptions=True)
        if governor is not None and pressure_mod.active() is governor:
            pressure_mod.uninstall()
        if sentinel_engine is not None:
            sentinel_engine.close()
            if sentinel_mod.active() is sentinel_engine:
                sentinel_mod.uninstall()
        if fed_manifest is not None and federation.current() is not None \
                and federation.self_host() == fed.host:
            federation.uninstall()
        for task in list(conn_tasks):
            task.cancel()
        if conn_tasks:
            await asyncio.gather(*conn_tasks, return_exceptions=True)
        try:
            await server.wait_closed()
        except Exception:
            pass
        if kind == "unix" and bound_ino is not None:
            # Unlink only our own socket file: a replacement sidecar may
            # have bound the path meanwhile.
            try:
                if os.stat(socket_path).st_ino == bound_ino:
                    os.unlink(socket_path)
            except OSError:
                pass
        if services.warmstate is not None:
            await asyncio.to_thread(services.warmstate.close)
        if db_metadata is not None:
            await db_metadata.close()
        await services.renderer.close()
        if services.prefetcher is not None:
            services.prefetcher.close()
        await services.caches.close()
        from . import execcache
        execcache.uninstall(getattr(services.renderer, "exec_cache", None))


# ---------------------------------------------------------------- client

class _StreamSink:
    """The chunk frames and the final frame of one streaming call."""

    def __init__(self):
        self.queue: asyncio.Queue = asyncio.Queue()

    def push(self, header: dict, body: bytes) -> None:
        self.queue.put_nowait(("chunk", header, body))

    def finish(self, header: dict, body: bytes) -> None:
        self.queue.put_nowait(("final", header, body))

    def fail(self, exc: BaseException) -> None:
        self.queue.put_nowait(("error", exc, b""))


class _Conn:
    """One connection generation: its writer, waiters, read loop and
    negotiated features; a dead generation never touches a newer one."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        # rid -> asyncio.Future (a unary call) or _StreamSink (a stream).
        self.pending: Dict[int, object] = {}
        self.reader_task: Optional[asyncio.Task] = None
        self.frames: Optional[FrameWriter] = None
        self.recv_ring: Optional[ShmRing] = None
        # The segments this client created, both directions.
        self.owned_rings: Tuple[ShmRing, ...] = ()
        # Set before the pendings are failed: a late registration fails
        # at once instead of parking a future nobody resolves.
        self.dead: Optional[BaseException] = None
        # server clock + offset ~ client clock (from the hello).
        self.clock_offset: Optional[float] = None
        # The hang clock: bumped by every frame received, and when a
        # request opens an in-flight episode (none pending before).
        self.last_activity = time.monotonic()

    def register(self, rid: int, waiter) -> None:
        if self.dead is not None:
            raise ConnectionError(str(self.dead)
                                  or "render sidecar went away")
        if not self.pending:
            self.last_activity = time.monotonic()
        self.pending[rid] = waiter

    def fail_pending(self, exc: BaseException) -> None:
        self.dead = exc
        while self.pending:
            _, waiter = self.pending.popitem()
            if isinstance(waiter, _StreamSink):
                waiter.fail(exc)
            elif not waiter.done():
                waiter.set_exception(exc)

    def release_rings(self) -> None:
        for r in self.owned_rings:
            r.close()
        self.owned_rings = ()
        self.recv_ring = None


class SidecarClient:
    """Multiplexed client: one connection, many requests in flight,
    reconnecting lazily; requests in flight fail fast when the sidecar
    goes away.

    Failure policy (``utils.transient``): the idempotent ops retry with
    capped exponential backoff and jitter when the connection dies under
    them; ``plane_put`` never does.  Consecutive failures open the
    breaker, and calls then fail fast (``OverloadedError``: 503) until a
    half-open trial succeeds.  ``breaker=None`` / ``retry=None`` turn
    either off."""

    _DEFAULT = object()

    def __init__(self, socket_path: str, breaker=_DEFAULT, retry=_DEFAULT,
                 wire=None):
        from ..utils.transient import CircuitBreaker, RetryPolicy
        from .config import WireConfig
        self.socket_path = socket_path
        self.breaker = (CircuitBreaker() if breaker is self._DEFAULT
                        else breaker)
        self.retry = RetryPolicy() if retry is self._DEFAULT else retry
        self.wire = wire if wire is not None else WireConfig()
        self._conn: Optional[_Conn] = None
        self._next_id = 0
        self._conn_lock = asyncio.Lock()
        self._write_lock = asyncio.Lock()
        # The hung-wire watchdog's knobs (server.watchdog sets them from
        # watchdog.wire-hang-s and escalate-after); 0 turns the scan off.
        self.wire_hang_s = 0.0
        self.watchdog_escalate_after = 2
        self._wire_fires = 0     # consecutive; a served reply resets it
        # The fleet name of the sidecar behind this client
        # (``parallel.fleet.RemoteMember`` sets it); the hello sends it.
        self.member_label: Optional[str] = None
        # The federation host this client reaches (set for a member on
        # another host): the partition rules match (this host, peer_host),
        # so an unstamped client is never partitioned.
        self.peer_host: str = ""

    def _check_partition(self, op: str) -> None:
        """The netsplit drill: a partition rule from this host to
        ``peer_host`` keeps the frame home and fails the call as a dead
        wire does (``ConnectionError``, into the retries, the breaker and
        the mark-down).  The ``partition`` op is exempt: a drill must
        always be able to heal what it broke."""
        if op == "partition" or not self.peer_host:
            return
        from ..parallel import federation
        from ..utils import faultinject
        src = federation.self_host()
        mode = faultinject.partitioned(src, self.peer_host)
        if mode is not None:
            raise ConnectionError(f"link partitioned ({mode}): {src} -> "
                                  f"{self.peer_host}")

    async def _ensure_connected(self) -> _Conn:
        conn = self._conn
        if conn is not None and not conn.writer.is_closing():
            return conn
        async with self._conn_lock:
            conn = self._conn
            if conn is not None and not conn.writer.is_closing():
                return conn
            reader, writer = await open_sidecar_connection(self.socket_path)
            conn = _Conn(reader, writer)
            conn.frames = FrameWriter(
                writer, max_frames=self.wire.coalesce_max_frames,
                max_bytes=self.wire.coalesce_max_bytes)
            conn.reader_task = asyncio.create_task(self._read_loop(conn))
            try:
                await self._negotiate(conn)
            except BaseException:
                self._drop_conn(conn)
                raise
            self._conn = conn
            return conn

    async def _negotiate(self, conn: _Conn) -> None:
        """The v3 handshake, once a connection: offer ring segments this
        client creates, learn the peer's generation.  A v2 peer answers
        the unknown ``hello`` with 400: the segments are destroyed and
        every leg falls back to v2.  Only a dead connection raises."""
        rings: Tuple[ShmRing, ...] = ()
        if self.wire.ring_bytes > 0:
            created: list = []
            try:
                created.append(ShmRing.create(self.wire.ring_bytes))
                created.append(ShmRing.create(self.wire.ring_bytes))
                rings = tuple(created)
            except Exception as e:
                logger.info("shm ring unavailable (%s); socket bodies", e)
                for r in created:
                    r.close()
                rings = ()
        self._next_id += 1
        rid = self._next_id
        fut = asyncio.get_running_loop().create_future()
        header = {"id": rid, "op": "hello", "v": WIRE_VERSION}
        if self.member_label:
            header["member"] = self.member_label
        if rings:
            header["rings"] = {
                "c2s": {"name": rings[0].name,
                        "size": self.wire.ring_bytes},
                "s2c": {"name": rings[1].name,
                        "size": self.wire.ring_bytes},
            }
        t_hello = time.perf_counter()
        try:
            conn.register(rid, fut)
            await conn.frames.send(header)
            resp_header, resp_body = await asyncio.wait_for(fut, 10.0)
        except asyncio.TimeoutError:
            # A peer that answers nothing to an unknown op: a v2 peer.
            conn.pending.pop(rid, None)
            for r in rings:
                r.close()
            telemetry.WIRE.count_negotiation(ring=False)
            return
        except BaseException:
            # The segments are not the connection's yet: release them.
            for r in rings:
                r.close()
            raise
        doc = {}
        if resp_header.get("status") == 200:
            try:
                doc = json.loads(bytes(resp_body).decode())
            except (ValueError, AttributeError):
                doc = {}
        server_clock = doc.get("clock")
        if isinstance(server_clock, (int, float)):
            # The server read its clock inside our send..receive window:
            # the midpoint is within half the hello's round trip.
            mid = (t_hello + time.perf_counter()) / 2.0
            conn.clock_offset = mid - float(server_clock)
        ring_ok = bool(rings and doc.get("ring")
                       and int(doc.get("v", 2)) >= 3)
        if ring_ok:
            conn.owned_rings = rings
            conn.frames.ring = rings[0]             # c2s: our bodies out
            conn.frames.ring_min_bytes = self.wire.ring_min_body_bytes
            conn.recv_ring = rings[1]               # s2c: peer bodies in
        else:
            for r in rings:
                r.close()
        telemetry.WIRE.count_negotiation(ring=ring_ok)

    def _drop_conn(self, conn: _Conn,
                   reason: str = "render sidecar went away") -> None:
        """Tear one generation down: fail its waiters, stop its flusher,
        release its rings."""
        conn.fail_pending(ConnectionError(reason))
        if conn.frames is not None:
            conn.frames.close()
        if conn.reader_task is not None:
            conn.reader_task.cancel()
        conn.writer.close()
        conn.release_rings()
        if self._conn is conn:
            self._conn = None

    def watchdog_scan(self, now: Optional[float] = None) -> List[dict]:
        """The hung-wire scan (``server.watchdog``'s target contract):
        requests are parked and no frame has arrived for ``wire_hang_s``,
        so the peer is wedged mid-frame.  The heal drops the connection,
        which fails the parked waiters with the ``ConnectionError`` the
        retry policy sends idempotent calls again on.  Consecutive hangs
        without a served reply escalate."""
        if not self.wire_hang_s:
            return []
        now = time.monotonic() if now is None else now
        conn = self._conn
        if conn is None or not conn.pending:
            return []
        idle = now - conn.last_activity
        if idle < self.wire_hang_s:
            return []
        self._wire_fires += 1
        escalate = self._wire_fires >= self.watchdog_escalate_after
        parked = len(conn.pending)
        self._drop_conn(conn, reason="watchdog: sidecar wire hung "
                                     "mid-frame")
        return [{"action": "escalate" if escalate else "drop-connection",
                 "target": f"wire:{self.socket_path}",
                 "escalate": escalate, "pending": parked,
                 "idle_s": round(idle, 3)}]

    async def _read_loop(self, conn: _Conn) -> None:
        try:
            while True:
                header, body = await _read_frame(conn.reader)
                conn.last_activity = time.monotonic()
                body = _ring_body(conn.recv_ring, header, body)
                rid = header.get("id")
                waiter = conn.pending.get(rid)
                if isinstance(waiter, _StreamSink):
                    if "status" in header:
                        # The fin frame, or a v2 single-frame answer.
                        conn.pending.pop(rid, None)
                        waiter.finish(header, body)
                    else:
                        waiter.push(header, body)
                else:
                    conn.pending.pop(rid, None)
                    if waiter is not None and not waiter.done():
                        waiter.set_result((header, body))
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError, OSError):
            pass
        except (RingError, ValueError) as e:
            # A corrupt frame or descriptor: the stream cannot be trusted;
            # fail cleanly and reconnect, never hand bytes to a waiter.
            logger.warning("sidecar wire protocol error: %s", e)
            telemetry.FLIGHT.record("wire.protocol-error",
                                    error=str(e)[:120])
        finally:
            conn.fail_pending(ConnectionError("render sidecar went away"))
            if conn.frames is not None:
                conn.frames.close()
            conn.writer.close()
            conn.release_rings()
            if self._conn is conn:
                self._conn = None

    async def call(self, op: str, ctx_json: dict, body: bytes = b"",
                   extra: Optional[dict] = None):
        """``(status, body)``, or ``(status, error text)`` off 200."""
        resp_header, resp_body = await self.call_full(op, ctx_json,
                                                      body=body, extra=extra)
        return (resp_header["status"],
                resp_body if resp_header["status"] == 200
                else resp_header.get("error", ""))

    def _header(self, rid: int, op: str, ctx_json: dict,
                extra: Optional[dict], stream: bool) -> dict:
        from ..utils import transient
        header = {"id": rid, "op": op, "ctx": ctx_json, "v": WIRE_VERSION}
        if stream:
            header["stream"] = 1
        if extra:
            header.update(extra)
        remaining = transient.remaining_ms()
        if remaining is not None:
            # The remaining budget, not a time: the sidecar re-anchors it
            # on its own clock.
            header["deadline_ms"] = max(0.0, round(remaining, 1))
        trace_id = telemetry.current_trace_id()
        if trace_id:
            header["trace"] = trace_id
        return header

    async def _faults(self, conn: _Conn, header: dict, body) -> None:
        from ..utils import faultinject
        inj = faultinject.active()
        if inj is None:
            return
        delay = inj.wire_delay_s()
        if delay:
            await asyncio.sleep(delay)
        fault = inj.wire_fault()
        if fault is not None:
            await self._inject_wire_fault(conn, fault, header, body)

    def _admit(self, op: str) -> None:
        """The deadline, then the breaker (a spent budget must not take
        the half-open trial slot)."""
        from ..utils import transient
        from .errors import OverloadedError
        transient.check_deadline(f"sidecar {op}")
        if self.breaker is not None and not self.breaker.allow():
            raise OverloadedError(
                f"sidecar circuit breaker open (op {op})",
                retry_after_s=self.breaker.retry_after_s() or 1.0)

    def _served(self, op: str, attempt: int) -> None:
        if self.breaker is not None:
            was_closed = self.breaker.state == self.breaker.CLOSED
            self.breaker.record_success()
            if not was_closed:
                telemetry.FLIGHT.record("breaker.close", op=op)
        telemetry.RESILIENCE.observe_attempts(op, attempt + 1)
        self._wire_fires = 0

    async def call_full(self, op: str, ctx_json: dict, body: bytes = b"",
                        extra: Optional[dict] = None):
        """``(response header, response body)``.

        Sent again when the connection dies under the request, at send
        time or while the reply is awaited, for the ops the retry policy
        calls idempotent only.  Consecutive failures open the breaker; the
        context's deadline caps the backoffs and rides the wire."""
        from ..utils import transient

        attempts = self.retry.attempts_for(op) if self.retry else 1
        attempt = 0
        while True:
            self._admit(op)
            conn: Optional[_Conn] = None
            fut: Optional[asyncio.Future] = None
            rid = 0
            try:
                self._check_partition(op)
                conn = await self._ensure_connected()
                self._next_id += 1
                rid = self._next_id
                fut = asyncio.get_running_loop().create_future()
                conn.register(rid, fut)
                header = self._header(rid, op, ctx_json, extra, False)
                remaining = transient.remaining_ms()
                t_call = time.perf_counter()
                await self._faults(conn, header, body)
                await conn.frames.send(header, body)
                if remaining is not None:
                    # A wedged sidecar must not hold the caller past its
                    # budget; a late reply finds no waiter and is dropped.
                    try:
                        resp_header, resp_body = await asyncio.wait_for(
                            fut, timeout=max(0.0, remaining) / 1000.0)
                    except asyncio.TimeoutError:
                        conn.pending.pop(rid, None)
                        raise transient.DeadlineExceededError(
                            f"sidecar {op}: deadline exceeded awaiting "
                            f"reply")
                else:
                    resp_header, resp_body = await fut
            except (ConnectionError, OSError) as exc:
                if fut is not None and fut.done() and not fut.cancelled():
                    fut.exception()          # retrieved: no warning
                attempt = await self._retry_step(op, conn, rid, attempt,
                                                 attempts, exc)
                continue
            self._served(op, attempt)
            self._graft_response(resp_header, t_call, conn)
            return resp_header, resp_body

    async def _retry_step(self, op: str, conn: Optional[_Conn], rid: int,
                          attempt: int, attempts: int,
                          exc: BaseException) -> int:
        """The failure bookkeeping the unary and streaming calls share:
        drop the dead generation, feed the breaker, count the retry (or
        raise when the attempts are spent) and sleep the backoff, capped
        by the deadline."""
        from ..utils import transient

        if conn is not None:
            conn.pending.pop(rid, None)
            # The write half can die while the read loop waits on a
            # healthy-looking socket: close it so the next attempt
            # reconnects.
            conn.writer.close()
            if self._conn is conn:
                self._conn = None
        if self.breaker is not None:
            opens_before = self.breaker.opens
            self.breaker.record_failure()
            if self.breaker.opens > opens_before:
                telemetry.FLIGHT.record("breaker.open", op=op,
                                        opens=self.breaker.opens)
        attempt += 1
        if attempt >= attempts:
            telemetry.RESILIENCE.observe_attempts(op, attempt)
            telemetry.FLIGHT.record("sidecar.exhausted", op=op,
                                    attempts=attempt)
            raise ConnectionError("render sidecar went away") from exc
        telemetry.RESILIENCE.count_retry(op)
        telemetry.FLIGHT.record("sidecar.retry", op=op, attempt=attempt)
        backoff = self.retry.backoff_s(attempt - 1)
        remaining = transient.remaining_ms()
        if remaining is not None:
            backoff = min(backoff, max(0.0, remaining / 1000.0))
        if backoff > 0:
            await asyncio.sleep(backoff)
        return attempt

    def _graft_response(self, resp_header: dict, t_call: float,
                        conn: Optional[_Conn] = None) -> None:
        """Add the sidecar's spans and costs to the requesting trace.
        Span offsets are from the sidecar's arrival (``t_anchor``), mapped
        onto this clock by the hello's offset and clamped into [send time,
        now], so a child never opens before its parent."""
        trace_id = telemetry.current_trace_id()
        if trace_id and resp_header.get("spans"):
            anchor = t_call
            offset = getattr(conn, "clock_offset", None)
            t_anchor = resp_header.get("t_anchor")
            if offset is not None and isinstance(t_anchor, (int, float)):
                anchor = min(max(t_call, float(t_anchor) + offset),
                             time.perf_counter())
            for s in resp_header["spans"]:
                try:
                    telemetry.record_span(
                        s["name"], anchor + s["start_ms"] / 1000.0,
                        s["dur_ms"], trace_ids=(trace_id,))
                except (KeyError, TypeError):
                    pass      # a malformed span is dropped
        if trace_id and isinstance(resp_header.get("costs"), dict):
            telemetry.merge_costs(trace_id, resp_header["costs"])

    async def call_stream(self, op: str, ctx_json: dict,
                          extra: Optional[dict] = None,
                          final_out: Optional[dict] = None):
        """v3 leg 2: an async generator of the body's chunks as their
        frames arrive; the final frame's status maps through the unary
        call's contract (raised before the first chunk when the request
        failed).  A v2 peer, or an answer the sidecar did not stream,
        gives one chunk.  ``final_out`` receives the fin frame's fields
        (its provenance and quality marks).

        Until the first chunk, retries as :meth:`call_full` does; after
        it, bytes may be on the HTTP wire, and a death mid-stream raises
        ``ConnectionError`` for the caller."""
        from ..utils import transient

        async def sink_get(sink):
            remaining = transient.remaining_ms()
            if remaining is None:
                return await sink.queue.get()
            try:
                return await asyncio.wait_for(
                    sink.queue.get(), timeout=max(0.0, remaining) / 1000.0)
            except asyncio.TimeoutError:
                raise transient.DeadlineExceededError(
                    f"sidecar {op}: deadline exceeded awaiting stream")

        attempts = self.retry.attempts_for(op) if self.retry else 1
        attempt = 0
        while True:
            self._admit(op)
            conn = None
            rid = 0
            sink = _StreamSink()
            try:
                self._check_partition(op)
                conn = await self._ensure_connected()
                self._next_id += 1
                rid = self._next_id
                conn.register(rid, sink)
                header = self._header(rid, op, ctx_json, extra, True)
                t_call = time.perf_counter()
                await self._faults(conn, header, b"")
                await conn.frames.send(header)
                kind, first_h, first_body = await sink_get(sink)
                if kind == "error":
                    raise ConnectionError(str(first_h)
                                          or "render sidecar went away")
            except (ConnectionError, OSError) as exc:
                attempt = await self._retry_step(op, conn, rid, attempt,
                                                 attempts, exc)
                continue
            except BaseException:
                if conn is not None:
                    conn.pending.pop(rid, None)
                raise
            break
        telemetry.RESILIENCE.observe_attempts(op, attempt + 1)
        self._wire_fires = 0
        try:
            expected_seq = 0
            kind, h, body = kind, first_h, first_body
            while True:
                if kind == "error":
                    raise ConnectionError(str(h)
                                          or "render sidecar went away")
                if kind == "chunk":
                    seq = h.get("seq")
                    if seq != expected_seq:
                        # Chunks out of order: never serve spliced bytes.
                        self._drop_conn(conn)
                        raise ConnectionError(
                            f"stream chunk seq {seq!r} != expected "
                            f"{expected_seq} (op {op})")
                    expected_seq += 1
                    if expected_seq == 1:
                        telemetry.record_span(
                            "wire.firstChunk", t_call,
                            (time.perf_counter() - t_call) * 1000.0)
                    yield bytes(body)
                else:
                    final, final_body = h, body
                    break
                kind, h, body = await sink_get(sink)
            if self.breaker is not None:
                was_closed = self.breaker.state == self.breaker.CLOSED
                self.breaker.record_success()
                if not was_closed:
                    telemetry.FLIGHT.record("breaker.close", op=op)
            self._graft_response(final, t_call, conn)
            if final_out is not None:
                final_out.update(final)
            status = final.get("status")
            if status != 200:
                if expected_seq:
                    raise ConnectionError(
                        f"stream failed mid-flight ({status})")
                _map_status(status, final.get("error", ""),
                            retry_after_s=final.get("retry_after"))
                return
            if expected_seq == 0 and final_body:
                yield bytes(final_body)      # a v2 single-frame answer
        finally:
            conn.pending.pop(rid, None)

    async def _inject_wire_fault(self, conn: _Conn, kind: str,
                                 header: dict, body) -> None:
        """The chaos hook: ``drop`` sends nothing, ``truncate`` half a
        frame; then the connection closes and the ``ConnectionError`` the
        retry path handles is raised."""
        if kind == "truncate":
            frame = _pack(header, body)
            async with self._write_lock:
                conn.writer.write(frame[:max(1, len(frame) // 2)])
                try:
                    await conn.writer.drain()
                except (ConnectionError, OSError):
                    pass
        conn.writer.close()
        if self._conn is conn:
            self._conn = None
        raise ConnectionError(f"injected wire fault: {kind}")

    async def stage_plane(self, arr, digest: Optional[str] = None):
        """Digest-first push of one host plane stack (protocol v2): probe,
        upload only on a miss.  ``(digest, was_resident)``; against a peer
        that cannot take the push, ``(digest, False)`` and nothing sent."""
        results = await self.stage_planes(
            [arr], digests=None if digest is None else [digest])
        return results[0]

    async def stage_planes(self, arrs, digests=None, concurrency: int = 4):
        """Bulk digest-first push: one probe for the list, then the misses'
        uploads ``concurrency`` at a time (content repeated within the list
        is sent once).  ``[(digest, was_resident), ...]``."""
        import numpy as np

        from ..io.devicecache import plane_digest

        def prepare():
            out = []
            for i, a in enumerate(arrs):
                a = np.ascontiguousarray(a)
                d = (digests[i] if digests is not None and digests[i]
                     else plane_digest(a))
                out.append((a, d))
            return out

        prepared = await asyncio.to_thread(prepare)
        dlist = [d for _, d in prepared]
        status, payload = await self.call("plane_probe", {},
                                          extra={"digests": dlist})
        if status != 200:
            return [(d, False) for d in dlist]     # a v1 peer: no push
        try:
            doc = json.loads(bytes(payload).decode())
        except (ValueError, AttributeError):
            doc = {}
        if not doc.get("enabled", True):
            return [(d, False) for d in dlist]
        resident = doc.get("resident")
        if not isinstance(resident, list) or len(resident) != len(dlist):
            # A peer without the batched probe: one probe a plane.
            resident = []
            for d in dlist:
                status, payload = await self.call("plane_probe", {},
                                                  extra={"digest": d})
                if status != 200:
                    resident.append(False)
                    continue
                try:
                    pdoc = json.loads(bytes(payload).decode())
                except (ValueError, AttributeError):
                    pdoc = {}
                resident.append(bool(pdoc.get("resident")))

        sem = asyncio.Semaphore(max(1, concurrency))
        results: list = [None] * len(prepared)

        async def put_one(i: int, arr, digest: str) -> None:
            async with sem:
                status, payload = await self.call(
                    "plane_put", {}, body=memoryview(arr).cast("B"),
                    extra={"digest": digest, "dtype": str(arr.dtype),
                           "shape": list(arr.shape)})
            if status != 200:
                raise RuntimeError(f"plane_put failed ({status}): "
                                   f"{payload}")
            doc = json.loads(bytes(payload).decode())
            results[i] = (doc.get("digest", digest),
                          bool(doc.get("resident")))

        puts = []
        uploading: set = set()
        dup_indices: list = []
        for i, ((arr, digest), res) in enumerate(zip(prepared, resident)):
            if res:
                results[i] = (digest, True)
            elif digest in uploading:
                dup_indices.append((i, digest))
            else:
                uploading.add(digest)
                puts.append(put_one(i, arr, digest))
        if puts:
            # Settle every upload before raising the first failure.
            outcomes = await asyncio.gather(*puts, return_exceptions=True)
            errors = [o for o in outcomes if isinstance(o, BaseException)]
            if errors:
                raise errors[0]
        for i, digest in dup_indices:
            results[i] = (digest, True)
        return results

    async def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        conn.fail_pending(ConnectionError("client closed"))
        if conn.frames is not None:
            conn.frames.close()
        if conn.reader_task is not None:
            conn.reader_task.cancel()
            try:
                await conn.reader_task
            except asyncio.CancelledError:
                pass
        conn.writer.close()
        conn.release_rings()


class SidecarImageHandler:
    """The frontend's image handler: ``ImageRegionHandler``'s call surface
    and exception contract over the wire.

    ``fallback`` (``server.degraded.DegradedCpuHandler``, with
    ``fault-tolerance.degraded-mode``) serves when the sidecar is
    unreachable: the connection and every retry died, or the breaker is
    open.  Such an answer is counted and its provenance tier is
    ``degraded``.  An answer of a live sidecar (4xx, its own shed, a
    deadline) never falls back."""

    def __init__(self, client: SidecarClient, fallback=None):
        self.client = client
        self.fallback = fallback

    async def _degraded(self, ctx) -> bytes:
        from ..utils import provenance
        telemetry.RESILIENCE.count_degraded_render()
        provenance.mark(ctx, tier="degraded")
        return await self.fallback.render_image_region(ctx)

    async def render_image_region(self, ctx: ImageRegionCtx) -> bytes:
        from ..utils import provenance
        from .errors import OverloadedError
        from .pressure import shed_bulk_under_pressure
        # This process's own brownout sheds bulk work before the wire.
        shed_bulk_under_pressure(ctx)
        try:
            resp_header, payload = await self.client.call_full(
                "image", ctx.to_json())
        except (ConnectionError, OverloadedError):
            if self.fallback is None:
                raise
            return await self._degraded(ctx)
        provenance.merge_wire(ctx, resp_header.get("prov"))
        if resp_header.get("quality_capped"):
            # Capped bytes are never edge-cached under the full identity.
            ctx._pressure_quality_capped = True
        return _map_response(resp_header, payload)

    async def render_image_region_stream(self, ctx: ImageRegionCtx):
        """The body's chunks as their frames arrive (they concatenate to
        :meth:`render_image_region`'s bytes).  A stream that fails before
        its first chunk falls back to the unary path (with its own CPU
        fallback); a death mid-stream resumes through the unary path and
        sends the rest of the identical bytes."""
        from ..utils import provenance
        from .errors import OverloadedError
        offset = 0
        final_out: dict = {}
        try:
            async for chunk in self.client.call_stream(
                    "image", ctx.to_json(), final_out=final_out):
                offset += len(chunk)
                yield chunk
            provenance.merge_wire(ctx, final_out.get("prov"))
            if final_out.get("quality_capped"):
                ctx._pressure_quality_capped = True
            return
        except (ConnectionError, OverloadedError):
            if offset == 0 and self.fallback is not None:
                # call_stream spent the retries already.
                yield await self._degraded(ctx)
                return
        if offset == 0:
            yield await self.render_image_region(ctx)
            return
        # The render is deterministic: the unary answer's tail is the rest.
        body = await self.render_image_region(ctx)
        if len(body) < offset:
            raise ConnectionError("stream resume mismatch: re-rendered "
                                  "body shorter than the bytes already "
                                  "sent")
        yield bytes(body[offset:])


class SidecarMaskHandler:
    """The frontend's mask handler over the wire (same fallback rule)."""

    def __init__(self, client: SidecarClient, fallback=None):
        self.client = client
        self.fallback = fallback

    async def render_shape_mask(self, ctx: ShapeMaskCtx) -> bytes:
        from ..utils import provenance
        from .errors import OverloadedError
        try:
            resp_header, payload = await self.client.call_full(
                "mask", ctx.to_json())
        except (ConnectionError, OverloadedError):
            if self.fallback is None:
                raise
            telemetry.RESILIENCE.count_degraded_render()
            provenance.mark(ctx, tier="degraded")
            return await self.fallback.render_shape_mask(ctx)
        provenance.merge_wire(ctx, resp_header.get("prov"))
        return _map_response(resp_header, payload)


def _map_response(resp_header: dict, payload):
    status = resp_header["status"]
    return _map_status(status, payload if status == 200
                       else resp_header.get("error", ""),
                       retry_after_s=resp_header.get("retry_after"))


def _map_status(status: int, payload, retry_after_s=None):
    """Wire status -> the exception contract of ``server.errors`` (the
    app's status mapping completes the round trip)."""
    from ..utils.transient import DeadlineExceededError
    from .errors import OverloadedError
    if status == 200:
        return payload
    if status == 400:
        raise BadRequestError(str(payload))
    if status == 404:
        raise NotFoundError()
    if status == 503:
        raise OverloadedError(str(payload) or "sidecar overloaded",
                              retry_after_s=(retry_after_s
                                             if retry_after_s is not None
                                             else 1.0))
    if status == 504:
        raise DeadlineExceededError(str(payload)
                                    or "sidecar deadline exceeded")
    raise RuntimeError(f"sidecar render failed ({status})")


# --------------------------------------------------------------- launch

def sidecar_main(config, device="cuda") -> None:
    """The blocking entry of ``--role sidecar``.  SIGTERM or SIGINT runs
    the shutdown chain (warm-state snapshot, build-store drain, flight
    dump) on its own thread at signal time, then the orderly teardown."""
    import signal
    import threading

    holder: dict = {}

    def start_chain() -> None:
        from .shutdown import build_shutdown_chain
        telemetry.FLIGHT.record("signal", sig="SIGTERM")
        chain = build_shutdown_chain(config, holder.get("services"))
        t = threading.Thread(target=chain.run, args=("sigterm",),
                             name="shutdown-chain", daemon=True)
        holder["chain_thread"] = t
        t.start()

    async def main():
        task = asyncio.current_task()
        loop = asyncio.get_running_loop()

        def on_signal():
            start_chain()
            task.cancel()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, on_signal)
            except (NotImplementedError, RuntimeError):
                pass
        try:
            await run_sidecar(config, services_out=holder, device=device)
        except asyncio.CancelledError:
            logger.info("render sidecar stopped")

    try:
        asyncio.run(main())
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        chain_thread = holder.get("chain_thread")
        if chain_thread is not None:
            chain_thread.join(timeout=15.0)


def wait_sidecar_socket(proc, socket_path: str,
                        timeout_s: float = 180.0) -> None:
    """Block until the child accepts on ``socket_path``; a child that died
    during startup raises at once with its exit code."""
    import socket as pysocket

    deadline = time.monotonic() + timeout_s
    kind, host, port = parse_address(socket_path)
    while True:
        code = proc.poll()
        if code is not None:
            raise RuntimeError(f"sidecar exited with {code} during startup")
        try:
            if kind == "tcp":
                s = pysocket.create_connection((host, port), timeout=1.0)
            else:
                s = pysocket.socket(pysocket.AF_UNIX)
                s.settimeout(1.0)
                s.connect(socket_path)
            s.close()
            return
        except OSError:
            pass
        code = proc.poll()
        if code is not None:
            raise RuntimeError(f"sidecar exited with {code} during startup")
        if time.monotonic() >= deadline:
            raise RuntimeError("sidecar did not open its socket in time")
        time.sleep(0.2)


def spawn_sidecar(config_path: Optional[str], socket_path: str,
                  extra_args: Optional[list] = None):
    """``--role split``: start ``python -m omero_ms_image_region_tpu_torch
    .server --role sidecar`` as a child and wait for its socket to accept;
    returns the ``Popen``."""
    import subprocess
    import sys

    argv = [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
            "--role", "sidecar", "--sidecar-socket", socket_path]
    if config_path:
        argv += ["--config", config_path]
    argv += list(extra_args or ())
    proc = subprocess.Popen(argv)
    try:
        wait_sidecar_socket(proc, socket_path)
    except Exception:
        if proc.poll() is None:
            proc.terminate()
        raise
    return proc


class SidecarSupervisor:
    """Keeps the sidecar child of ``--role split`` alive: spawns it,
    watches it from a daemon thread, and spawns it again with capped
    exponential backoff when it dies.  The spawn returns only once the
    socket accepts (bound after the card's stack is built), and the
    frontends' ``/readyz`` holds traffic until the new child's prewarm is
    done.  ``spawn_fn`` is injectable (a test supervises a cheap child)."""

    def __init__(self, spawn_fn, base_backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0):
        import threading
        self._spawn_fn = spawn_fn
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.proc = None
        self.restarts = 0
        self._stop = threading.Event()
        self._thread = None

    @classmethod
    def for_config(cls, config_path: Optional[str], socket_path: str,
                   extra_args: Optional[list] = None,
                   max_backoff_s: float = 30.0) -> "SidecarSupervisor":
        return cls(lambda: spawn_sidecar(config_path, socket_path,
                                         extra_args),
                   max_backoff_s=max_backoff_s)

    def start(self):
        """Spawn the first child (blocking until its socket accepts) and
        start watching it."""
        import threading
        self.proc = self._spawn_fn()
        self._thread = threading.Thread(target=self._monitor,
                                        name="sidecar-supervisor",
                                        daemon=True)
        self._thread.start()
        return self.proc

    def _monitor(self) -> None:
        import subprocess

        backoff = self.base_backoff_s
        spawned_at = time.monotonic()
        while not self._stop.is_set():
            proc = self.proc
            try:
                proc.wait(timeout=0.5)
            except subprocess.TimeoutExpired:
                if time.monotonic() - spawned_at > 30.0:
                    # A child that held a while resets the ladder: it
                    # punishes crash loops, not isolated crashes.
                    backoff = self.base_backoff_s
                continue
            if self._stop.is_set():
                break
            logger.warning("render sidecar exited with %s; restarting in "
                           "%.1f s", proc.returncode, backoff)
            if self._stop.wait(backoff):
                break
            backoff = min(backoff * 2.0, self.max_backoff_s)
            try:
                self.proc = self._spawn_fn()
            except Exception:
                logger.exception("sidecar respawn failed; will retry")
                continue
            if self._stop.is_set():
                # stop() raced the respawn: the new child must not leak.
                try:
                    self.proc.terminate()
                except Exception:
                    pass
                break
            spawned_at = time.monotonic()
            self.restarts += 1
            telemetry.RESILIENCE.count_supervisor_restart()
            telemetry.FLIGHT.record("supervisor.restart", n=self.restarts)
            logger.info("render sidecar restarted (restart #%d)",
                        self.restarts)

    def stop(self, timeout_s: float = 15.0) -> None:
        """Stop watching and terminate the child (no restart)."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout_s)
        proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=timeout_s)
            except Exception:
                proc.kill()


class SidecarUnit:
    """One fleet member's sidecar process as a unit the autoscaler starts
    and stops: a scale-down terminates it (its card memory is released),
    a scale-up spawns it again, blocking until its socket accepts.
    ``spawn_fn`` is injectable (a test supervises a stand-in).  Both moves
    are idempotent: stopping a stopped unit and starting a live one do
    nothing, so a retried scale operation never spawns twice."""

    def __init__(self, name: str, spawn_fn):
        self.name = name
        self._spawn_fn = spawn_fn
        self.proc = None
        self.starts = 0
        self.stops = 0

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def start(self) -> None:
        """Spawn the unit (the spawn returns once the socket accepts);
        nothing while its process lives."""
        if self.alive():
            return
        self.proc = self._spawn_fn()
        self.starts += 1
        telemetry.FLIGHT.record("autoscale.unit-start", member=self.name)
        logger.info("sidecar unit %s started (pid %s)", self.name,
                    getattr(self.proc, "pid", None))

    def stop(self, timeout_s: float = 15.0) -> None:
        """SIGTERM (the sidecar's shutdown chain runs), kill past
        ``timeout_s``; nothing when already stopped."""
        proc = self.proc
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=timeout_s)
        except Exception:
            proc.kill()
        self.stops += 1
        telemetry.FLIGHT.record("autoscale.unit-stop", member=self.name)
        logger.info("sidecar unit %s stopped", self.name)


class SidecarUnitLifecycle:
    """Member name -> :class:`SidecarUnit`, the hooks
    ``server.autoscaler.Autoscaler(lifecycle=...)`` drives: ``stop`` after
    the member's drain settled (the handoff needs the live process),
    ``start`` before its undrain (no route lands on a dead socket).  An
    unknown name does nothing: a fleet may manage part of its members."""

    def __init__(self, units: Dict[str, SidecarUnit]):
        self.units = dict(units)

    @classmethod
    def for_config(cls, config_path: str,
                   sockets_by_member: Dict[str, str]
                   ) -> "SidecarUnitLifecycle":
        """One unit per member, each spawned from the sidecar config
        ``config_path`` (``autoscaler.unit-config``) on its own socket."""
        return cls({name: SidecarUnit(
            name, lambda sock=sock: spawn_sidecar(config_path, sock))
            for name, sock in sockets_by_member.items()})

    def start(self, name: str) -> None:
        unit = self.units.get(name)
        if unit is not None:
            unit.start()

    def stop(self, name: str) -> None:
        unit = self.units.get(name)
        if unit is not None:
            unit.stop()

    def start_all(self) -> None:
        """Spawn every unit at once (each start blocks until its socket
        accepts, and a sidecar's start takes seconds)."""
        import concurrent.futures as cf

        units = list(self.units.values())
        if len(units) <= 1:
            for unit in units:
                unit.start()
            return
        with cf.ThreadPoolExecutor(max_workers=len(units),
                                   thread_name_prefix="unit-start") as pool:
            for fut in [pool.submit(u.start) for u in units]:
                fut.result()

    def stop_all(self) -> None:
        for unit in self.units.values():
            unit.stop()

    def alive(self, name: str) -> bool:
        unit = self.units.get(name)
        return unit is not None and unit.alive()
