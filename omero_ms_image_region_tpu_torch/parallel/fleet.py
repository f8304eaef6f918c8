"""The fleet: N members, each owning a shard of the card-resident state.

Counterpart of the JAX package's ``parallel/fleet.py``, making the same
decisions on the same input.  A :class:`FleetRouter` in front of N members
routes each render by a consistent hash of its plane identity
(:func:`plane_route_key`: image, z, t, resolution, tile or region, never
the rendering settings), so every render of one plane lands on the member
whose ``DeviceRawCache`` holds it: the raw-cache tier shards instead of
duplicating, and a re-window of a hot plane finds its bytes resident.

Members are in-process (:class:`LocalMember`: its own renderer, batcher
lanes and raw cache, sharing the host services with the others; the
combined role's ``fleet.members``) or render sidecars
(:class:`RemoteMember`: a ``server.sidecar`` process over the wire; the
frontend role's ``fleet.sockets``).  Each in-process member renders on its
own ``torch.device`` (``ImageRegionServices.pin_device``); with no device
sets every member takes the app's device, as JAX's members take the
process default device, so on one card the members share ``cuda:0``.

Load skew is met by bounded stealing: each member drains its queue through
``lane_width`` lanes, and an idle lane steals the oldest interactive
request of the most backlogged peer once its backlog reaches
``steal_min_backlog``.  A stolen render runs from the source bytes without
adopting the plane (``adopt_cache=False``; the ``adopt: 0`` wire key), so
stealing never fragments the shard map.  A member whose render fails with
a connection error is marked down for ``down_cooldown_s``; its shard fails
over hash-ring-next and its queued work is re-homed there.  A drain
(:meth:`FleetRouter.drain_member`) takes a member out of routing on
purpose, settles its in-flight work and hands its shard, warm, to the ring
successors.  Hot planes get a replica set (:class:`HeatTracker`, a prefix
of the ring chain) and reads balance across it; the hottest one's heat is
the autoscaler's replica-pressure signal
(:meth:`FleetRouter.replica_pressure`).

The federation's hooks (``parallel.federation``): a ring seeded from the
manifest and swapped at an epoch commit (:meth:`FleetRouter.apply_manifest`);
the quorum fences of a minority host (``federation.quorum_allow``: no
shard adoption in the chain walk or a failover, no hot-key promotion, no
byte write-back to a remote authority); the drain's byte handoff to a
successor on another host (``wire_handoff``: the drainer's
:meth:`LocalMember.shard_export` shipped over ``shard_transfer``); the
prefetcher's seam to a remote owner (:meth:`FleetRouter
.remote_prestage_for_route`); and the ``RemoteMember`` side of the
federation's wire ops with a ``fed.hop`` span ({host, member, kind}) on
each exchange with another host.  With no federation installed every
decision is the single-host one.  A hop span (``fleet.hop``) is recorded
on the requester's trace.
"""

from __future__ import annotations

import asyncio
import bisect
import collections
import hashlib
import logging
import math
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..server.ctx import plane_route_key  # noqa: F401  (re-exported)

logger = logging.getLogger("omero_ms_image_region_tpu_torch.fleet")


def _entry_key(entry: dict) -> tuple:
    """A restageable entry's region key as a tuple: matches exported bytes
    to their hint entries across JSON (lists against tuples)."""
    try:
        image_id, z, t, level, region, channels = entry["key"]
        return (int(image_id), int(z), int(t), int(level),
                tuple(int(v) for v in region),
                tuple(int(c) for c in channels))
    except (KeyError, TypeError, ValueError):
        return (id(entry),)


# ------------------------------------------------------------ hash ring

class HashRing:
    """Consistent hash ring with virtual nodes.

    BLAKE2b over the literal strings (never Python's salted ``hash()``),
    so one set of members, replicas and seed gives every process the same
    owner and chain for every key, the JAX ring's bit for bit.
    ``replicas`` virtual nodes a member keep the split near uniform; a join
    or a leave moves only the keys whose arcs changed hands (~1/N)."""

    def __init__(self, members: Sequence[str], replicas: int = 64,
                 seed: str = ""):
        if not members:
            raise ValueError("hash ring needs at least one member")
        if len(set(members)) != len(members):
            raise ValueError("duplicate fleet member names")
        self.replicas = max(1, int(replicas))
        # Folded into every point so two rings with the same member names
        # never share a key space; "" keeps the unseeded goldens.
        self.seed = str(seed)
        self.members: Tuple[str, ...] = tuple(members)
        prefix = f"{self.seed}|" if self.seed else ""
        points = sorted((self._point(f"{prefix}{name}#{v}"), name)
                        for name in self.members
                        for v in range(self.replicas))
        self._points: List[int] = [p for p, _ in points]
        self._owners: List[str] = [o for _, o in points]

    @staticmethod
    def _point(s: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")

    def _key_point(self, key: str) -> int:
        return self._point(f"{self.seed}|{key}" if self.seed else key)

    def chain(self, key: str) -> List[str]:
        """The members in ring order from ``key``'s arc, each once: the
        first owns the key, the rest are its failover order."""
        n = len(self._points)
        i = bisect.bisect(self._points, self._key_point(key)) % n
        seen: List[str] = []
        for step in range(n):
            owner = self._owners[(i + step) % n]
            if owner not in seen:
                seen.append(owner)
                if len(seen) == len(self.members):
                    break
        return seen

    def member(self, key: str) -> str:
        """The key's owner."""
        return self.chain(key)[0]


# ------------------------------------------------------------- hot keys

class HeatTracker:
    """Decayed request rate per route, the hot-key detector.

    Each observation adds one unit; heat decays with time constant
    ``decay_s`` (applied on read).  At a steady ``r`` requests/s a route's
    heat tends to ``r * decay_s``.  At most ``top_k`` routes are tracked: a
    new route enters a full table only by evicting one whose heat fell
    below its own single unit.  ``clock`` is injectable."""

    def __init__(self, threshold: float, decay_s: float,
                 top_k: int = 128, clock=time.monotonic):
        self.threshold = float(threshold)
        self.decay_s = max(1e-3, float(decay_s))
        self.top_k = max(1, int(top_k))
        self.clock = clock
        self._heat: Dict[str, Tuple[float, float]] = {}

    def _decayed(self, heat: float, last: float, now: float) -> float:
        if now <= last:
            return heat
        return heat * math.exp(-(now - last) / self.decay_s)

    def observe(self, route: str) -> float:
        """Count one request; its decayed heat, this one included."""
        now = self.clock()
        held = self._heat.get(route)
        if held is None:
            if len(self._heat) >= self.top_k:
                coldest = min(self._heat, key=lambda r: self._decayed(
                    *self._heat[r], now))
                if self._decayed(*self._heat[coldest], now) > 1.0:
                    return 1.0     # a table of hotter routes: untracked
                del self._heat[coldest]
            heat = 1.0
        else:
            heat = self._decayed(held[0], held[1], now) + 1.0
        self._heat[route] = (heat, now)
        return heat

    def heat(self, route: str) -> float:
        """The decayed heat without counting a request."""
        held = self._heat.get(route)
        if held is None:
            return 0.0
        return self._decayed(held[0], held[1], self.clock())


# -------------------------------------------------------------- members

class MemberDownError(ConnectionError):
    """A member's refusal while it is already marked down.  Not a fresh
    death: re-marking on it would push the cooldown forward on every
    routed request, and a member with steady traffic could never come
    back."""


class _DownState:
    """A member's health and drain flags: down is a cooldown (a served
    render, or its end, re-admits it); draining takes no new routes but
    finishes its work.  ``drain_intent`` says who drained it
    (``"operator"``, ``"autoscale"``, or None at shutdown's quiesce)."""

    def _init_state(self, down_cooldown_s: float) -> None:
        self.down_cooldown_s = down_cooldown_s
        self._down_until = 0.0
        self.draining = False
        self.drain_intent: Optional[str] = None

    @property
    def healthy(self) -> bool:
        return time.monotonic() >= self._down_until

    def mark_down(self) -> None:
        self._down_until = time.monotonic() + self.down_cooldown_s

    def revive(self) -> None:
        self._down_until = 0.0


class LocalMember(_DownState):
    """An in-process member: its own renderer and raw cache behind an
    ``ImageRegionHandler``, the host services (pixel stores, byte caches,
    metadata, the ACL memo) shared with the other members.

    ``byte_cache_prechecked``: the fleet handler above the router already
    probed the byte cache and ran the caller's ACL, so the member's handler
    skips its own probe.  ``services`` gives the shard accounting and the
    prestage; ``handler`` is duck-typed, so a test can wrap it.
    ``devices`` is the member's device set (its first is the renderer's
    ``torch.device``); empty: the app's device."""

    remote = False

    def __init__(self, name: str, handler, services=None,
                 down_cooldown_s: float = 5.0,
                 byte_cache_prechecked: bool = False,
                 devices: Optional[Sequence] = None):
        self.name = name
        self.handler = handler
        self.services = services
        self.byte_cache_prechecked = byte_cache_prechecked
        self.devices: Tuple = tuple(devices or ())
        self._init_state(down_cooldown_s)

    async def render(self, ctx, adopt_cache: bool = True) -> bytes:
        if not self.healthy:
            raise MemberDownError(f"fleet member {self.name} is down")
        if self.byte_cache_prechecked:
            data = await self.handler.render_image_region(
                ctx, adopt_cache=adopt_cache, skip_byte_cache=True)
        else:
            data = await self.handler.render_image_region(
                ctx, adopt_cache=adopt_cache)
        self.revive()           # a served call re-admits the member
        return data

    def _cache(self):
        return getattr(self.services, "raw_cache", None)

    def queue_depth(self) -> int:
        renderer = getattr(self.services, "renderer", None)
        return (renderer.queue_depth() if hasattr(renderer, "queue_depth")
                else 0)

    def resident_digests(self):
        cache = self._cache()
        return cache.resident_digests() if cache is not None else set()

    def resident_planes(self) -> int:
        cache = self._cache()
        return len(cache) if cache is not None else 0

    async def shard_manifest(self, limit: int = 0) -> List[dict]:
        """The member's raw-cache shard as restageable entries, MRU first
        (the drain handoff's hint list)."""
        cache = self._cache()
        return cache.snapshot_entries(limit) if cache is not None else []

    async def route_manifest(self, route: str) -> List[dict]:
        """One route's entries (what a hot route's replicas stage)."""
        cache = self._cache()
        return cache.entries_for_route(route) if cache is not None else []

    async def prestage_manifest(self, entries: List[dict]) -> int:
        """Stage handed-over entries into this member's raw cache, each
        re-read from the pixel store (``services.warmstate
        .restage_plane_entry``); a resident entry is a hit, never a second
        copy.  Best effort: a bad entry is a cold miss later."""
        from ..services.warmstate import restage_plane_entry
        cache = self._cache()
        pixels = getattr(self.services, "pixels_service", None)
        if cache is None or pixels is None:
            return 0

        def stage_all() -> int:
            staged = 0
            for entry in entries:
                try:
                    if restage_plane_entry(cache, pixels, entry):
                        staged += 1
                except Exception:
                    continue
            return staged

        return await asyncio.to_thread(stage_all)

    async def shard_export(self, limit: int = 0) -> List[dict]:
        """The member's raw-cache shard as entries with the plane bytes
        (``dtype``, ``shape``, ``bytes``): the cross-host drain handoff's
        payload, since a successor on another host cannot re-read this
        host's pixel store.  MRU first; an entry evicted meanwhile is
        skipped."""
        import numpy as np
        import torch

        from ..io.devicecache import region_key
        cache = self._cache()
        if cache is None:
            return []
        entries = cache.snapshot_entries(limit)

        def export() -> List[dict]:
            out = []
            for entry in entries:
                key = _entry_key(entry)
                if len(key) != 6:
                    continue
                arr = cache.get(region_key(*key))
                if arr is None:
                    continue
                if arr.dtype == torch.uint16:
                    # Read as int16: not every torch maps uint16 to numpy.
                    host = arr.view(torch.int16).cpu().numpy().view(
                        np.uint16)
                else:
                    host = arr.cpu().numpy()
                out.append({**entry, "dtype": str(host.dtype),
                            "shape": list(host.shape),
                            "bytes": host.tobytes()})
            return out

        return await asyncio.to_thread(export)

    async def shard_transfer(self, entries: List[dict]) -> int:
        """Stage handed-over plane bytes into this member's raw cache under
        their region key and route: the in-process mirror of the
        ``shard_transfer`` op, so the handoff does not care which kind of
        member the successor is.  A resident plane is a hit."""
        import numpy as np

        from ..io.devicecache import region_key
        cache = self._cache()
        if cache is None:
            return 0

        def stage_all() -> int:
            staged = 0
            for entry in entries:
                key = _entry_key(entry)
                try:
                    arr = np.frombuffer(
                        entry["bytes"], dtype=entry["dtype"]).reshape(
                        tuple(entry["shape"]))
                except (KeyError, TypeError, ValueError):
                    continue
                if len(key) != 6:
                    continue
                cache.get_or_load(region_key(*key), lambda a=arr: a,
                                  digest=entry.get("digest"),
                                  route_key=entry.get("route"))
                staged += 1
            return staged

        return await asyncio.to_thread(stage_all)


class RemoteMember(_DownState):
    """A render sidecar, reached over the wire (``server.sidecar
    .SidecarClient``).  Its client's open breaker, or a connection death a
    lane saw through every retry, marks it down for ``down_cooldown_s``;
    the first served call after that re-admits it."""

    remote = True

    def __init__(self, name: str, client, down_cooldown_s: float = 5.0):
        self.name = name
        self.client = client
        # The hello tells the sidecar its fleet name (its flight events
        # then carry it).
        try:
            client.member_label = name
        except AttributeError:      # a duck-typed test client
            pass
        self._init_state(down_cooldown_s)

    @property
    def healthy(self) -> bool:
        breaker = getattr(self.client, "breaker", None)
        if breaker is not None and breaker.state == breaker.OPEN:
            return False
        return time.monotonic() >= self._down_until

    def _fed_span(self, kind: str, t0: float, t1: float, **meta) -> None:
        """One ``fed.hop`` span ({host, member, kind}) on an exchange with
        a member on another federation host; nothing for a same-host
        member or with no federation (``federation.remote_host_of``), and
        nothing outside a trace."""
        from . import federation
        from ..utils import telemetry
        host = federation.remote_host_of(self.name)
        if host:
            telemetry.record_span("fed.hop", t0, (t1 - t0) * 1000.0,
                                  host=host, member=self.name, kind=kind,
                                  **meta)

    async def render(self, ctx, adopt_cache: bool = True) -> bytes:
        from ..server.sidecar import _map_response
        from ..utils import provenance
        extra = None if adopt_cache else {"adopt": 0}
        resp_header, payload = await self.client.call_full(
            "image", ctx.to_json(), extra=extra)
        self.revive()
        provenance.merge_wire(ctx, resp_header.get("prov"))
        if resp_header.get("quality_capped"):
            # Capped bytes are never stored under the full-quality key,
            # the peer write-back included.
            ctx._pressure_quality_capped = True
        return _map_response(resp_header, payload)

    async def _doc(self, op: str, extra: dict, body: bytes = b""
                   ) -> Optional[dict]:
        """The JSON answer of ``op`` (None unless 200 with a body)."""
        import json
        status, resp = await self.client.call(op, {}, body=body,
                                              extra=extra)
        if status != 200 or not resp:
            return None
        return json.loads(bytes(resp).decode())

    # The byte tier over the wire: every failure is None or False (the
    # peer tier may only remove work).

    async def byte_probe(self, keys: List[str],
                         tier: str = "region") -> List[bool]:
        try:
            extra = {"keys": [str(k) for k in keys]}
            if tier != "region":
                extra["tier"] = tier
            doc = await self._doc("byte_probe", extra) or {}
            present = [bool(p) for p in (doc.get("present") or ())]
            present += [False] * (len(keys) - len(present))
            return present[:len(keys)]
        except Exception:
            return [False] * len(keys)

    async def byte_fetch(self, key: str, image_id=None, session=None,
                         tier: str = "region",
                         obj: str = "Image") -> Optional[bytes]:
        """None: the authority's miss (or its ACL's refusal); a transport
        failure raises, so the caller counts a fallback, not a miss."""
        extra = {"key": str(key)}
        if tier != "region":
            extra["tier"] = tier
        if image_id is not None:
            # The sidecar runs its own ACL for this session first.
            extra["image_id"] = int(image_id)
            extra["session"] = session
            if obj != "Image":
                extra["obj"] = obj
        t0 = time.perf_counter()
        resp_header, payload = await self.client.call_full(
            "byte_fetch", {}, extra=extra)
        self._fed_span("byte_fetch", t0, time.perf_counter(),
                       hit=int(resp_header.get("status") == 200
                               and payload is not None))
        if resp_header.get("status") != 200 or payload is None:
            return None
        return bytes(payload)

    async def byte_put(self, key: str, value: bytes,
                       tier: str = "region") -> bool:
        try:
            digest = hashlib.blake2b(bytes(value),
                                     digest_size=16).hexdigest()
            extra = {"key": str(key), "digest": digest}
            if tier != "region":
                extra["tier"] = tier
            t0 = time.perf_counter()
            status, _ = await self.client.call("byte_put", {},
                                               body=bytes(value),
                                               extra=extra)
            self._fed_span("byte_put", t0, time.perf_counter(),
                           bytes=len(value))
            return status == 200
        except Exception:
            return False

    def queue_depth(self) -> int:
        return 0                # the sidecar's own gauge carries it

    def resident_digests(self):
        return set()

    def resident_planes(self) -> int:
        return 0

    async def shard_manifest(self, limit: int = 0) -> List[dict]:
        """The sidecar's shard (``shard_manifest``); [] from an
        unreachable or older sidecar: the successor then warms lazily."""
        try:
            doc = await self._doc("shard_manifest", {"limit": limit}) or {}
            return list(doc.get("entries") or ())
        except Exception:
            return []

    async def explain_residency(self, key: str, route: str) -> dict:
        try:
            import json
            status, body = await self.client.call(
                "explain", {}, extra={"key": key, "route": route})
            if status != 200 or not body:
                return {"error": f"explain op status {status}"}
            return dict(json.loads(bytes(body).decode()))
        except Exception as e:
            return {"error": str(e)[:120]}

    async def prestage_manifest(self, entries: List[dict]) -> int:
        """Hand entries to the sidecar (``prestage``): it re-reads them
        from its own pixel store into its raw cache."""
        try:
            t0 = time.perf_counter()
            doc = await self._doc("prestage", {"entries": entries}) or {}
            self._fed_span("remote_prestage", t0, time.perf_counter(),
                           entries=len(entries))
            return int(doc.get("staged", 0))
        except Exception:
            return 0

    # The federation's ops: manifest_hello and member_gossip are reads,
    # the epoch ops idempotent by contract (all retried); shard_transfer
    # ships state and is never sent twice.  Each carries this host
    # (``from_host``), which feeds the receiver's quorum tracker.

    async def _fed_doc(self, op: str, extra: dict) -> Optional[dict]:
        """The JSON answer of a federation op; None when unreachable."""
        try:
            return await self._doc(op, extra)
        except Exception:
            return None

    async def manifest_hello(self, doc: dict,
                             probe_keys: Optional[List[str]] = None
                             ) -> Optional[dict]:
        """Send our manifest and learn whether the peer's agrees (and, with
        ``probe_keys``, the peer's own ring owner of each).  None:
        unreachable, or a peer without the op."""
        from . import federation
        extra = {"manifest": doc, "from_host": federation.self_host()}
        if probe_keys:
            extra["probe_keys"] = list(probe_keys)
        return await self._fed_doc("manifest_hello", extra)

    async def member_gossip(self, view: dict) -> Optional[dict]:
        """Swap member views and the manifest identity."""
        from . import federation
        return await self._fed_doc("member_gossip", {
            "view": view, "from_host": federation.self_host()})

    async def epoch_propose(self, doc: dict) -> Optional[dict]:
        """A roll's phase 1: the peer records the manifest pending and
        acks; nothing activates."""
        from . import federation
        return await self._fed_doc("epoch_propose", {
            "manifest": doc, "from_host": federation.self_host()})

    async def epoch_commit(self, doc: dict,
                           digest: str = "") -> Optional[dict]:
        """A roll's phase 2: the peer checks the digest, activates the
        manifest and swaps its ring (an already-active epoch acks)."""
        from . import federation
        extra = {"manifest": doc, "from_host": federation.self_host()}
        if digest:
            extra["digest"] = digest
        return await self._fed_doc("epoch_commit", extra)

    async def shard_transfer(self, entries: List[dict]) -> int:
        """Ship warm plane bytes into the sidecar's raw cache, one frame a
        plane (the body the buffer, the header its ``key``, ``digest``,
        ``route``, ``dtype`` and ``shape``).  Best effort an entry: a
        failed ship is a cold miss later.  The sidecar's stage, anchored
        on its clock, is grafted as a ``fed.hop`` span of kind ``stage``
        clamped into the call's bracket."""
        import json

        from . import federation
        from ..utils import telemetry
        staged = 0
        for entry in entries:
            payload = entry.get("bytes")
            if payload is None:
                continue
            meta = {k: entry.get(k) for k in
                    ("key", "digest", "route", "dtype", "shape")}
            try:
                t_send = time.perf_counter()
                status, body = await self.client.call(
                    "shard_transfer", {}, body=bytes(payload),
                    extra={"entry": meta})
                t_recv = time.perf_counter()
                doc = (json.loads(bytes(body).decode())
                       if status == 200 and body else {})
                self._fed_span("shard_transfer", t_send, t_recv,
                               bytes=len(payload),
                               staged=int(bool(doc.get("staged"))))
                if not doc.get("staged"):
                    continue
                staged += 1
                telemetry.FEDERATION.count_transfer(len(payload))
                host = federation.remote_host_of(self.name)
                anchored = (federation.anchor_remote_time(
                    doc.get("host") or host, doc.get("t_anchor"),
                    (t_send, t_recv)) if host else None)
                if anchored is not None:
                    dur = max(0.0, min(float(doc.get("ms") or 0.0),
                                       (t_recv - anchored) * 1000.0))
                    telemetry.record_span(
                        "fed.hop", anchored, dur,
                        host=doc.get("host") or host, member=self.name,
                        kind="stage")
            except Exception:
                continue
        return staged

# --------------------------------------------------------------- router

class _Work:
    __slots__ = ("ctx", "future", "owner", "stolen", "hops", "deadline",
                 "t_enqueue", "bulk", "trace_ids")

    def __init__(self, ctx, future, owner: str, deadline):
        from ..server.pressure import is_bulk
        from ..utils import telemetry
        self.ctx = ctx
        self.future = future
        self.owner = owner
        self.stolen = False
        self.hops = 0
        self.deadline = deadline
        self.t_enqueue = time.perf_counter()
        # The requester's traces: lanes run outside any request context,
        # so the render re-adopts them.
        self.trace_ids = telemetry.current_trace_ids()
        # The QoS class, once: the verdict the ladder's shed_bulk and the
        # member-0 pin use.
        self.bulk = is_bulk(ctx)


class _MemberQueue:
    """One member's pending work as a weighted two-class queue.

    ``qos_weight`` 0 is plain FIFO.  With weight w > 0, while both classes
    wait, up to w interactive units pop for each bulk unit; arrival order
    holds within each class."""

    __slots__ = ("_items", "qos_weight", "_ic_run", "_ic")

    def __init__(self, qos_weight: int = 0):
        self._items: Deque[_Work] = collections.deque()
        self.qos_weight = max(0, int(qos_weight))
        self._ic_run = 0
        self._ic = 0            # interactive units queued (O(1) reads)

    def append(self, work: _Work) -> None:
        self._items.append(work)
        if not work.bulk:
            self._ic += 1

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def _first_index(self, bulk: bool) -> Optional[int]:
        for i, w in enumerate(self._items):
            if w.bulk == bulk:
                return i
        return None

    def _on_pop(self, work: _Work) -> _Work:
        if not work.bulk:
            self._ic -= 1
        return work

    def _take(self, i: int) -> _Work:
        work = self._on_pop(self._items[i])
        del self._items[i]
        return work

    def popleft(self) -> _Work:
        """The next unit under the weighted dequeue."""
        from ..utils import telemetry
        items = self._items
        if self.qos_weight <= 0:
            return self._on_pop(items.popleft())
        if self._ic == 0 or self._ic == len(items):
            self._ic_run = 0    # one class: FIFO, the quota resets
            work = self._on_pop(items.popleft())
        elif self._ic_run >= self.qos_weight:
            work = self._take(self._first_index(True))  # no starvation
            self._ic_run = 0
        else:
            i_ic = self._first_index(False)
            work = self._take(i_ic)
            self._ic_run += 1
            if i_ic > 0:
                # Overtook a bulk unit that arrived first.
                telemetry.QOS.count_jump()
        telemetry.QOS.count_dequeued("bulk" if work.bulk
                                     else "interactive")
        return work

    def pop_raw(self) -> _Work:
        """Arrival order, no policy (reassign, fail and close)."""
        return self._on_pop(self._items.popleft())

    def steal_depth(self) -> int:
        """Stealable units: interactive only (bulk work is pinned)."""
        return self._ic

    def steal_pop(self) -> Optional[_Work]:
        """The oldest interactive unit, or None."""
        if self._ic == 0:
            return None
        return self._take(self._first_index(False))


class FleetRouter:
    """Consistent-hash request router over N members.

    Per-member queues drained by ``lane_width`` asyncio lanes each; an idle
    lane steals the oldest request of the most backlogged peer at
    ``steal_min_backlog`` (0: never), and a stolen render does not adopt
    the plane.  A member's death (a ``ConnectionError`` through the client's
    retries) marks it down, re-homes its queue hash-ring-next and fails the
    dead call over the same way (``failover``; off: its shard fails with
    it).  ``hotkey`` (a ``HotkeyConfig``) turns on hot-plane replication;
    ``peer_fetch`` the byte tier's peer fetch and write-back for remote
    members, each fetch bounded by ``peer_timeout_s``.  ``wire_handoff``
    (a federation): a drain ships the warm bytes of an in-process drainer
    to remote successors over ``shard_transfer``, since their host cannot
    re-read this host's pixel store."""

    def __init__(self, members: Sequence, lane_width: int = 2,
                 steal_min_backlog: int = 2, hash_replicas: int = 64,
                 failover: bool = True, qos_weight: int = 0,
                 peer_fetch: bool = True, peer_timeout_s: float = 0.5,
                 ring_seed: str = "", hotkey=None,
                 wire_handoff: bool = False):
        if not members:
            raise ValueError("fleet needs at least one member")
        if lane_width < 1:
            raise ValueError("fleet lane_width must be >= 1")
        self.members: Dict[str, object] = {m.name: m for m in members}
        if len(self.members) != len(members):
            raise ValueError("duplicate fleet member names")
        self.order: List[str] = [m.name for m in members]
        self.ring = HashRing(self.order, replicas=hash_replicas,
                             seed=ring_seed)
        self.lane_width = lane_width
        self.steal_min_backlog = max(0, int(steal_min_backlog))
        self.failover = failover
        self.qos_weight = max(0, int(qos_weight))
        # Admission's service parallelism (wait = depth * EWMA / lanes).
        self.device_lanes = lane_width * len(members)
        self._queues: Dict[str, _MemberQueue] = {
            name: _MemberQueue(self.qos_weight) for name in self.order}
        self._inflight: Dict[str, int] = {n: 0 for n in self.order}
        # One wake event for every idle lane: any lane may want any
        # member's new work.
        self._wake: Optional[asyncio.Event] = None
        self._lanes: List[asyncio.Task] = []
        self._closed = False
        self.peer_fetch = peer_fetch
        self.peer_timeout_s = peer_timeout_s
        self.wire_handoff = bool(wire_handoff)
        # In-process members share one byte-cache chain the fleet handler
        # already probed: only remote peers are asked.
        self._has_remote_members = any(
            getattr(m, "remote", False) for m in members)
        self._putback_tasks: set = set()
        # A drained member's manifest, replayed into it on undrain.
        self._drain_manifests: Dict[str, List[dict]] = {}
        self.last_undrain_prestage: Optional[asyncio.Task] = None
        self.hotkey = (hotkey if hotkey is not None
                       and getattr(hotkey, "enabled", False)
                       and len(self.order) > 1 else None)
        self._heat: Optional[HeatTracker] = None
        if self.hotkey is not None:
            self._heat = HeatTracker(
                threshold=getattr(self.hotkey, "threshold", 12.0),
                decay_s=getattr(self.hotkey, "decay_s", 20.0),
                top_k=getattr(self.hotkey, "top_k", 128))
        # route -> its replica set (a chain prefix; [0] is the owner, the
        # write and byte-tier authority).
        self._replica_sets: Dict[str, List[str]] = {}
        # route -> members staged this promotion (the never-double-stage
        # guard; cleared on demotion).
        self._replica_staged: Dict[str, set] = {}
        # Every route ever promoted (bounded): the shard report tells
        # deliberate replication from duplicate staging.
        self._hot_ever: set = set()

    # ----------------------------------------------------------- routing

    @staticmethod
    def _pinned(ctx) -> bool:
        """Full-plane and projection jobs pin to member 0 and are never
        stolen (``server.pressure.is_bulk``: the ladder's shed_bulk reads
        the same verdict)."""
        from ..server.pressure import is_bulk
        return is_bulk(ctx)

    def _routable(self, name: str) -> bool:
        """May new work land here: alive and not draining."""
        member = self.members[name]
        return member.healthy and not member.draining

    def owner_of(self, ctx) -> str:
        """The member serving this request: hash-ring-next past down and
        draining members, the least queued live replica of a promoted
        route; pinned work on the first routable member."""
        if self._pinned(ctx):
            return self._walk_chain(list(self.order))
        return self._serving_member(plane_route_key(ctx))

    def _serving_member(self, route: str, record: bool = False) -> str:
        """A promoted route's least queued live replica (ties in chain
        order, so an idle fleet serves from the owner); else, or with no
        live replica, the chain walk."""
        replicas = (self._replica_sets.get(route) if self._replica_sets
                    else None)
        if replicas:
            live = [n for n in replicas if self._routable(n)]
            if live:
                target = min(live, key=lambda n: (
                    len(self._queues[n]) + self._inflight[n],
                    replicas.index(n)))
                if record and target != replicas[0]:
                    from ..utils import telemetry
                    telemetry.HOTKEY.count_balanced(target)
                return target
        return self._walk_chain(self.ring.chain(route))

    def _walk_chain(self, chain: List[str]) -> str:
        from . import federation
        fenced = self.failover and federation.is_fenced()
        if not self.failover or fenced:
            # failover off: a down owner keeps its shard (which then
            # fails), for queued work and new arrivals alike.  A drain is
            # an operator's handoff, so it is walked past.  A fenced
            # minority walks the same way: adopting a silent peer's shard
            # in a netsplit is how split brains write, so the owner's call
            # fails (a refusal counted) and the front answers 503.
            for name in chain:
                if not self.members[name].draining:
                    if fenced and not self._routable(name):
                        federation.quorum_allow("adoption")
                    return name
            return chain[0]
        for name in chain:
            if self._routable(name):
                return name
        # Every member down: the owner takes the call, so the failure is
        # the ConnectionError -> 503 contract.
        return chain[0]

    # ----------------------------------------------- hot-plane replication

    def _observe_heat(self, route: str) -> None:
        """One dispatch: bump the route's heat, promote it past the
        threshold, sweep cooled promotions down."""
        heat = self._heat.observe(route)
        if heat >= self._heat.threshold and route not in self._replica_sets:
            from . import federation
            # Fenced: no promotion (its staging would land on replicas
            # this island cannot prove it owns); it promotes again on the
            # first hot dispatch after the restore.
            if federation.quorum_allow("promotion"):
                self._promote_route(route, heat)
        self._sweep_hot_routes()

    def _promote_route(self, route: str, heat: float) -> None:
        """Give a hot route a replica set (a prefix of its chain) and
        stage the owner's warm slice onto the new replicas in the
        background."""
        from ..utils import decisions, telemetry
        chain = self.ring.chain(route)
        r = min(max(2, int(getattr(self.hotkey, "max_replicas", 2))),
                len(chain))
        replicas = chain[:r]
        self._replica_sets[route] = replicas
        self._hot_ever.add(route)
        while len(self._hot_ever) > 4096:
            self._hot_ever.pop()
        telemetry.HOTKEY.count_promoted()
        telemetry.HOTKEY.set_hot_routes(len(self._replica_sets))
        telemetry.FLIGHT.record("hotkey.promote", route=route[:12],
                                heat=round(heat, 1),
                                replicas=",".join(replicas))
        decisions.record("hotkey", "promoted",
                         detail={"route": route[:16],
                                 "heat": round(heat, 2),
                                 "replicas": list(replicas)})
        self._spawn(self._stage_replicas(route, replicas))

    def _spawn(self, coro) -> Optional[asyncio.Task]:
        """A background task tracked for :meth:`close` (None with no
        running loop: the work is skipped)."""
        try:
            task = asyncio.get_running_loop().create_task(coro)
        except RuntimeError:
            coro.close()
            return None
        self._putback_tasks.add(task)
        task.add_done_callback(self._putback_tasks.discard)
        return task

    async def _stage_replicas(self, route: str,
                              replicas: List[str]) -> int:
        """Stage the owner's entries of the route onto each replica, at
        most once a (route, replica) pair a promotion; the staging path
        makes a resident plane a hit, never a second buffer."""
        from ..utils import telemetry
        owner = self.members.get(replicas[0])
        if owner is None:
            return 0
        route_fn = getattr(owner, "route_manifest", None)
        try:
            if route_fn is not None:
                entries = await route_fn(route)
            else:
                entries = [e for e in await owner.shard_manifest(0)
                           if e.get("route") == route]
        except Exception:
            entries = []
        staged_members = self._replica_staged.setdefault(route, set())
        total = 0
        for name in replicas[1:]:
            if name in staged_members:
                # A second stage in one promotion would be a bookkeeping
                # fault: counted, and held at 0.
                telemetry.HOTKEY.count_duplicate_staged()
                continue
            member = self.members.get(name)
            if member is None or not member.healthy:
                continue
            staged_members.add(name)
            if not entries:
                continue        # nothing warm yet: it warms by its reads
            try:
                n = await member.prestage_manifest(entries)
            except Exception:
                staged_members.discard(name)
                continue
            total += n
            telemetry.HOTKEY.count_staged(n)
            telemetry.FLIGHT.record("hotkey.stage", route=route[:12],
                                    member=name, entries=n)
        return total

    def _sweep_hot_routes(self) -> None:
        """Demote the routes whose heat fell to ``threshold *
        demote_fraction`` (the hysteresis band).  The replicas' planes
        stay until the cache's LRU or the pressure ladder takes them."""
        if not self._replica_sets:
            return
        demote_at = self._heat.threshold * float(
            getattr(self.hotkey, "demote_fraction", 0.5))
        for route in list(self._replica_sets):
            if self._heat.heat(route) <= demote_at:
                self._demote_route(route)

    def _demote_route(self, route: str) -> None:
        from ..utils import decisions, telemetry
        self._replica_sets.pop(route, None)
        self._replica_staged.pop(route, None)
        telemetry.HOTKEY.count_demoted()
        telemetry.HOTKEY.set_hot_routes(len(self._replica_sets))
        telemetry.FLIGHT.record("hotkey.demote", route=route[:12])
        decisions.record("hotkey", "demoted", detail={"route": route[:16]})

    def shed_replicas(self) -> int:
        """Demote every promoted route (the pressure ladder's evict step,
        before its LRU pass)."""
        routes = list(self._replica_sets)
        for route in routes:
            self._demote_route(route)
        return len(routes)

    def apply_manifest(self, manifest) -> bool:
        """Swap the ring to ``manifest``'s geometry (``names()``,
        ``replicas``, ``ring_seed``, ``version``): the same members only
        (a membership change needs a restart and raises), promoted routes
        shed first, since their replica sets are prefixes of the old
        chains."""
        from ..utils import telemetry
        names = set(manifest.names())
        if names != set(self.order):
            raise ValueError(
                "epoch roll changed fleet membership "
                f"({sorted(names ^ set(self.order))}); a live router "
                "only swaps ring geometry — membership changes need "
                "a restart")
        shed = self.shed_replicas()
        self.ring = HashRing(self.order, replicas=manifest.replicas,
                             seed=manifest.ring_seed)
        telemetry.FLIGHT.record("fleet.ring-swap", epoch=manifest.version,
                                seed=str(manifest.ring_seed)[:16],
                                replicas=manifest.replicas, shed_hot=shed)
        return True

    def replica_set(self, route: str) -> List[str]:
        """The route's replica set ([owner] when not promoted)."""
        replicas = self._replica_sets.get(route)
        if replicas:
            return list(replicas)
        return self.ring.chain(route)[:1]

    def is_hot_route(self, route: str) -> bool:
        return route in self._replica_sets

    def hot_route_count(self) -> int:
        return len(self._replica_sets)

    def hot_owned(self, name: str) -> int:
        """The promoted routes whose replica set holds ``name`` (the
        gossip view's ``hot`` figure)."""
        return sum(1 for reps in self._replica_sets.values() if name in reps)

    def replica_pressure(self) -> float:
        """The hottest promoted route's heat in promotion thresholds (0
        with none promoted): the autoscaler's "one plane outruns one
        member" signal, which queue depth misses while the replicas
        absorb the skew.  Sets the ``imageregion_hotkey_replica_pressure``
        gauge."""
        from ..utils import telemetry
        pressure = 0.0
        if self._heat is not None and self._replica_sets:
            pressure = max(self._heat.heat(r) / self._heat.threshold
                           for r in self._replica_sets)
        telemetry.HOTKEY.set_pressure(pressure)
        return pressure

    def local_replica_caches(self, route: str) -> List:
        """The raw caches of a promoted route's live in-process replicas,
        in balanced-read order (the prefetcher stages a hot route's
        predictions into each); [] for a route not promoted."""
        out = []
        for name in self._replica_sets.get(route, ()):
            if not self._routable(name):
                continue
            member = self.members[name]
            if getattr(member, "remote", False):
                continue
            cache = getattr(getattr(member, "services", None),
                            "raw_cache", None)
            if cache is not None:
                out.append(cache)
        return out

    def queue_depth(self) -> int:
        """Queued and executing across the fleet (admission's and
        ``/readyz``'s depth)."""
        return (sum(len(q) for q in self._queues.values())
                + sum(self._inflight.values()))

    def member_depth(self, name: str) -> int:
        return len(self._queues[name])

    def member_inflight(self, name: str) -> int:
        return self._inflight[name]

    def healthy_members(self) -> List[str]:
        return [n for n in self.order if self.members[n].healthy]

    def cache_for_route(self, route_key: str):
        """The raw cache of the member that serves ``route_key`` (the
        prefetcher's seam: a predicted plane stages into the shard that
        will serve it); None for a remote owner, or an owner without a
        cache."""
        for name in self.ring.chain(route_key):
            if self._routable(name):
                return getattr(getattr(self.members[name], "services",
                                       None), "raw_cache", None)
        return None

    def remote_prestage_for_route(self, route_key: str,
                                  entry: dict) -> bool:
        """The prefetcher's cross-host seam: a predicted plane whose serving
        member is remote is staged on its owner's host (a fire and forget
        ``prestage`` hint: the owner re-reads it from its own pixel store).
        False for a local owner (:meth:`cache_for_route` serves it), with
        no routable member, or with no running loop."""
        from ..utils import telemetry
        for name in self.ring.chain(route_key):
            if not self._routable(name):
                continue
            member = self.members[name]
            if not getattr(member, "remote", False):
                return False

            async def hint() -> None:
                try:
                    await member.prestage_manifest([entry])
                except Exception:
                    pass        # speculation only removes work

            if self._spawn(hint()) is None:
                return False
            telemetry.FEDERATION.count_remote_prestage()
            return True
        return False

    def draining_members(self, intent: Optional[str] = None) -> List[str]:
        """The draining members; ``intent`` filters to one kind."""
        return [n for n in self.order if self.members[n].draining
                and (intent is None
                     or getattr(self.members[n], "drain_intent",
                                None) == intent)]

    # ----------------------------------------------------------- drains

    async def drain_member(self, name: str, prestage: bool = True,
                           max_planes: int = 256,
                           settle_timeout_s: float = 30.0,
                           intent: str = "operator") -> dict:
        """A rolling drain of one member, in four phases, each a flight
        event and an ``imageregion_drain_state`` transition:

        1. draining: no new routes, and its queued work re-homes
           hash-ring-next (adopting there);
        2. settle: its in-flight renders finish (``settle_timeout_s``
           bounds the wait, not the work);
        3. handoff: its shard manifest (MRU first, at most
           ``max_planes``) is prestaged onto each plane's new owner;
        4. drained: safe to restart; :meth:`undrain_member` rejoins it.

        Draining a draining member runs the settle and handoff again."""
        from ..utils import decisions, telemetry
        if name not in self.members:
            raise KeyError(f"unknown fleet member {name!r}")
        member = self.members[name]
        member.draining = True
        member.drain_intent = intent
        telemetry.DRAIN.set_state(name, "draining")
        telemetry.FLIGHT.record("drain.phase", member=name,
                                phase="draining", intent=intent,
                                queued=len(self._queues[name]),
                                inflight=self._inflight[name])
        self._reassign(name, reason="drain")
        t0 = time.monotonic()
        while (self._inflight[name] > 0
               and time.monotonic() - t0 < settle_timeout_s):
            await asyncio.sleep(0.02)
        settled = self._inflight[name] == 0
        manifest = await member.shard_manifest(max_planes)
        if manifest:
            self._drain_manifests[name] = manifest
        prestaged = 0
        if prestage and manifest:
            telemetry.FLIGHT.record("drain.phase", member=name,
                                    phase="handoff", planes=len(manifest))
            prestaged = await self._prestage_handoff(name, manifest)
            telemetry.DRAIN.count_prestaged(prestaged)
        telemetry.DRAIN.set_state(name, "drained")
        telemetry.FLIGHT.record("drain.phase", member=name,
                                phase="drained", settled=settled,
                                planes=len(manifest), prestaged=prestaged)
        logger.info("fleet member %s drained (settled=%s, %d shard planes, "
                    "%d pre-staged on successors)", name, settled,
                    len(manifest), prestaged)
        decisions.record("drain", "done" if settled else "failed",
                         member=name, detail={
                             "intent": intent, "settled": settled,
                             "planes": len(manifest),
                             "prestaged": prestaged})
        return {"member": name, "settled": settled, "intent": intent,
                "planes": len(manifest), "prestaged": prestaged}

    async def _prestage_handoff(self, draining: str,
                                manifest: List[dict]) -> int:
        """Hand each entry to the member that will serve it: its recorded
        route walks the ring as a request would (the drainer is no longer
        routable); an entry without one spreads by its key."""
        from ..utils import decisions
        by_successor: Dict[str, List[dict]] = {}
        for entry in manifest:
            route = entry.get("route") or repr(entry.get("key"))
            for candidate in self.ring.chain(route):
                if candidate != draining and self._routable(candidate):
                    by_successor.setdefault(candidate, []).append(entry)
                    break
        staged = failed = 0
        drainer = self.members[draining]
        # Cross-host warm handoff: an in-process drainer's bytes ship to
        # remote successors, exported once; any export failure falls back
        # to the hint list.
        exported: Dict[tuple, dict] = {}
        if self.wire_handoff and not drainer.remote and any(
                self.members[s].remote for s in by_successor):
            try:
                for entry in await drainer.shard_export(len(manifest)):
                    exported[_entry_key(entry)] = entry
            except Exception:
                logger.warning("shard export from %s failed; hint-list "
                               "handoff", draining, exc_info=True)
        for successor, entries in by_successor.items():
            member = self.members[successor]
            try:
                if exported and member.remote:
                    # Entries evicted before the export go as hints.
                    staged += await member.shard_transfer(
                        [exported[_entry_key(e)] for e in entries
                         if _entry_key(e) in exported])
                    rest = [e for e in entries
                            if _entry_key(e) not in exported]
                    if rest:
                        staged += await member.prestage_manifest(rest)
                else:
                    staged += await member.prestage_manifest(entries)
            except Exception:
                failed += 1
                logger.warning("drain handoff to %s failed", successor,
                               exc_info=True)
        decisions.record("handoff", "failed" if failed else "done",
                         member=draining, detail={
                             "planes": len(manifest), "staged": staged,
                             "successors": len(by_successor),
                             "failed_successors": failed})
        return staged

    def undrain_member(self, name: str, prestage_back: bool = True) -> None:
        """Rejoin a drained member: its arcs route to it again at the next
        dispatch (the ring never changed).  The manifest it held when it
        drained is replayed into it in the background
        (``last_undrain_prestage``), so a restarted member rejoins warm."""
        from ..utils import decisions, telemetry
        if name not in self.members:
            raise KeyError(f"unknown fleet member {name!r}")
        member = self.members[name]
        member.draining = False
        member.drain_intent = None
        telemetry.DRAIN.set_state(name, "active")
        telemetry.FLIGHT.record("drain.phase", member=name,
                                phase="undrained")
        decisions.record("undrain", "done", member=name, detail={
            "prestage_back": bool(prestage_back
                                  and self._drain_manifests.get(name))})
        entries = self._drain_manifests.pop(name, None)
        self.last_undrain_prestage = None
        if prestage_back and entries:
            async def restage_back() -> None:
                try:
                    staged = await member.prestage_manifest(entries)
                except Exception:
                    logger.warning("undrain pre-stage-back into %s failed",
                                   name, exc_info=True)
                    return
                telemetry.DRAIN.count_prestaged(staged)
                telemetry.FLIGHT.record(
                    "drain.phase", member=name, phase="prestage-back",
                    planes=len(entries), prestaged=staged)

            self.last_undrain_prestage = self._spawn(restage_back())
        logger.info("fleet member %s undrained (rejoined the ring)", name)

    # ---------------------------------------------------------- dispatch

    def _ensure_lanes(self) -> None:
        if self._lanes or self._closed:
            return
        from ..utils import transient
        self._wake = asyncio.Event()
        # The lanes are made from the first request's context: detached
        # from its deadline, or every render would inherit that budget.
        with transient.deadline_scope(None):
            for name in self.order:
                for lane in range(self.lane_width):
                    self._lanes.append(asyncio.create_task(
                        self._lane(name), name=f"fleet-{name}-l{lane}"))

    async def dispatch(self, ctx) -> bytes:
        """Route one render to its member and await the bytes (on the
        event loop: the queues are loop-confined, no lock)."""
        from ..utils import telemetry, transient

        if self._closed:
            raise ConnectionError("fleet router is closed")
        self._ensure_lanes()
        if self._heat is not None and not self._pinned(ctx):
            route = plane_route_key(ctx)
            self._observe_heat(route)
            owner = self._serving_member(route, record=True)
        else:
            owner = self.owner_of(ctx)
        work = _Work(ctx, asyncio.get_running_loop().create_future(),
                     owner, transient.deadline())
        if work.trace_ids:
            telemetry.record_span("fleet.hop", work.t_enqueue, 0.0,
                                  trace_ids=work.trace_ids)
        self._queues[owner].append(work)
        telemetry.FLEET.count_routed(owner)
        self._wake.set()
        remaining = transient.remaining_ms()
        if remaining is None:
            return await work.future
        try:
            return await asyncio.wait_for(
                asyncio.shield(work.future),
                timeout=max(0.0, remaining) / 1000.0)
        except asyncio.TimeoutError:
            if not work.future.done():
                work.future.cancel()    # a lane popping it skips it
            raise transient.DeadlineExceededError(
                "deadline exceeded awaiting fleet render")
        except asyncio.CancelledError:
            if not work.future.done():
                work.future.cancel()
            raise

    async def fetch_peer_bytes(self, ctx) -> Optional[bytes]:
        """The peer rung: when the render would land on a member that is
        not its chain's byte authority (the owner is down or draining),
        fetch the authority's already-rendered bytes (``byte_fetch``, its
        own ACL) in place of a re-render.  Remote members only; every
        failure, miss or timeout is None (the peer tier only removes
        work)."""
        if (not self.peer_fetch or not self._has_remote_members
                or self._pinned(ctx)):
            return None
        from ..utils import provenance, telemetry
        serving = self.owner_of(ctx)
        route = plane_route_key(ctx)
        for name in self.ring.chain(route):
            if name == serving:
                return None     # the server probes its own tier
            member = self.members[name]
            if not member.remote or not (member.healthy
                                         or member.draining):
                continue
            telemetry.HTTPCACHE.count_peer_probe()
            t0 = time.perf_counter()
            try:
                data = await asyncio.wait_for(
                    member.byte_fetch(ctx.cache_key, image_id=ctx.image_id,
                                      session=ctx.omero_session_key),
                    self.peer_timeout_s)
            except Exception:
                telemetry.HTTPCACHE.count_peer_fallback()
                return None
            if data is None:
                return None     # the authority has none: render
            telemetry.HTTPCACHE.count_peer_hit()
            telemetry.HTTPCACHE.count_peer_fetch()
            telemetry.record_span("fleet.hop", t0,
                                  (time.perf_counter() - t0) * 1000.0)
            provenance.mark(ctx, tier="peer", member=name)
            telemetry.FLIGHT.record("fleet.byte-peer", authority=name,
                                    serving=serving, nbytes=len(data))
            return data
        return None

    @staticmethod
    def _mask_route(ctx) -> str:
        """A mask's ring route: its byte-cache key, namespaced apart from
        render identities."""
        return f"mask|{ctx.cache_key()}"

    async def fetch_peer_mask(self, ctx) -> Optional[bytes]:
        """A mask PNG from its ring authority's mask byte tier (explicit
        colour masks only, which are the byte-cached ones; remote members
        only).  None on a miss, a refusal or a failure."""
        if (not self.peer_fetch or not self._has_remote_members
                or getattr(ctx, "color", None) is None):
            return None
        from ..utils import provenance, telemetry
        key = str(ctx.cache_key())
        for name in self.ring.chain(self._mask_route(ctx)):
            member = self.members[name]
            if not getattr(member, "remote", False) \
                    or not (member.healthy or member.draining):
                continue
            telemetry.HTTPCACHE.count_peer_probe()
            try:
                data = await asyncio.wait_for(
                    member.byte_fetch(key, image_id=ctx.shape_id,
                                      session=ctx.omero_session_key,
                                      tier="mask", obj="Mask"),
                    self.peer_timeout_s)
            except Exception:
                telemetry.HTTPCACHE.count_peer_fallback()
                return None
            if data is None:
                return None
            telemetry.HTTPCACHE.count_peer_hit()
            telemetry.HTTPCACHE.count_peer_fetch()
            provenance.mark(ctx, tier="peer", member=name)
            telemetry.FLIGHT.record("fleet.mask-peer", authority=name,
                                    nbytes=len(data))
            return data
        return None

    def put_peer_mask(self, ctx, data: bytes) -> None:
        """Ship a just-rendered explicit-colour mask to its ring
        authority's mask tier (fire and forget); a local authority already
        has it."""
        if (not self.peer_fetch or not self._has_remote_members
                or getattr(ctx, "color", None) is None):
            return
        from ..utils import telemetry
        key = str(ctx.cache_key())
        for name in self.ring.chain(self._mask_route(ctx)):
            member = self.members[name]
            if not (member.healthy or member.draining):
                continue
            if not getattr(member, "remote", False):
                return
            from . import federation
            if not federation.quorum_allow("write_authority"):
                return          # fenced: no write-back across the split

            async def put() -> None:
                try:
                    if await member.byte_put(key, data, tier="mask"):
                        telemetry.HTTPCACHE.count_peer_putback()
                except Exception:
                    pass
            self._spawn(put())
            return

    def _byte_putback(self, work: _Work, data: bytes) -> None:
        """A thief rendered another member's plane: ship the bytes to the
        owner's byte tier (fire and forget ``byte_put``, never retried),
        so the owner answers the next request itself."""
        if not self.peer_fetch:
            return
        owner = self.members.get(work.owner)
        if owner is None or not owner.remote or not owner.healthy:
            return
        from . import federation
        if not federation.quorum_allow("write_authority"):
            # Fenced: the authority may have moved on the majority side.
            return
        if getattr(work.ctx, "_pressure_quality_capped", False):
            return              # capped bytes never take the full key
        from ..utils import telemetry
        key = work.ctx.cache_key

        async def put() -> None:
            try:
                if await owner.byte_put(key, data):
                    telemetry.HTTPCACHE.count_peer_putback()
            except Exception:
                pass
        self._spawn(put())

    def _takeable(self, name: str) -> bool:
        """Is there work this member's lanes could take now: its own, or
        a peer backlog past the steal threshold?"""
        if self._queues[name]:
            return True
        if self.steal_min_backlog <= 0 or not self._routable(name):
            return False
        return any(self._queues[other].steal_depth()
                   >= self.steal_min_backlog
                   for other in self.order if other != name)

    def _pop_work(self, name: str) -> Optional[_Work]:
        """The lane's next unit: its own queue first (the weighted
        dequeue), else the oldest interactive unit of the most backlogged
        peer at or past the threshold.  A draining member never steals."""
        queue = self._queues[name]
        if queue:
            return queue.popleft()
        if self.steal_min_backlog <= 0 or not self._routable(name):
            return None
        victim, depth = None, 0
        for other in self.order:
            if other == name:
                continue
            qlen = self._queues[other].steal_depth()
            if qlen >= self.steal_min_backlog and qlen > depth:
                victim, depth = other, qlen
        if victim is None:
            return None
        work = self._queues[victim].steal_pop()
        if work is None:
            return None
        work.stolen = True
        from ..utils import telemetry
        telemetry.FLEET.count_stolen(name)
        telemetry.FLIGHT.record("fleet.steal", by=name, owner=work.owner,
                                backlog=depth)
        return work

    def _reassign(self, dead: str, reason: str = "failover") -> None:
        """Move a dead (or draining) member's queued work to each unit's
        hash-ring-next routable member (adopting there)."""
        from ..utils import telemetry
        queue = self._queues[dead]
        moved = 0
        while queue:
            self._route_failover(queue.pop_raw(), reason=reason)
            moved += 1
        if moved:
            telemetry.FLIGHT.record("fleet.drain", member=dead, moved=moved)
            self._wake.set()

    def _fail_queue(self, dead: str, error: Exception) -> None:
        """failover off: a dead member's queued work fails with it."""
        queue = self._queues[dead]
        while queue:
            work = queue.pop_raw()
            if not work.future.done():
                work.future.set_exception(ConnectionError(str(error)))

    def _route_failover(self, work: _Work,
                        reason: str = "failover") -> None:
        """Queue one unit on the first routable member of its chain.  The
        failed member is excluded by its health alone: a stolen unit's
        owner never failed, and is where it belongs."""
        from . import federation
        from ..utils import provenance, telemetry
        if reason == "failover" and not federation.quorum_allow("adoption"):
            # Fenced: a death's re-home is a shard adoption (the member may
            # be alive on the majority side), refused; the unit fails as
            # an all-down fleet's does.  A drain's re-home stays allowed.
            if not work.future.done():
                work.future.set_exception(ConnectionError(
                    "fenced minority partition: shard adoption refused"))
            return
        chain = (list(self.order) if self._pinned(work.ctx)
                 else self.ring.chain(plane_route_key(work.ctx)))
        tried = work.hops
        for name in chain:
            if not self._routable(name):
                continue
            work.owner = name
            work.hops = tried + 1
            work.stolen = False
            self._queues[name].append(work)
            telemetry.FLEET.count_failed_over(name)
            provenance.mark(work.ctx, **{
                ("drain_rehomed" if reason == "drain"
                 else "failed_over"): True})
            return
        if not work.future.done():
            work.future.set_exception(ConnectionError(
                "no healthy fleet member for shard"))

    async def _lane(self, name: str) -> None:
        from ..utils import provenance, telemetry, transient

        # Detached from the first request's trace (each unit re-adopts
        # its own below).
        telemetry.clear_context()
        member = self.members[name]
        while not self._closed:
            work = self._pop_work(name)
            if work is None:
                self._wake.clear()
                # A dispatch between the pop and the clear must not be
                # lost; a peer's backlog this lane cannot steal must not
                # spin it.
                if self._takeable(name):
                    continue
                await self._wake.wait()
                continue
            if work.future.done():
                continue                # its waiter gave up
            if (work.deadline is not None
                    and time.monotonic() >= work.deadline):
                telemetry.RESILIENCE.count_deadline_cancelled(1)
                work.future.set_exception(transient.DeadlineExceededError(
                    "deadline exceeded in fleet queue"))
                continue
            self._inflight[name] += 1
            provenance.mark(work.ctx, member=name,
                            **({"stolen": True} if work.stolen else {}))
            t_render = time.perf_counter()
            try:
                # A stolen render does not adopt the plane; owned and
                # failed-over work does.  The unit's remaining budget and
                # its traces re-enter here.
                with telemetry.group_trace(work.trace_ids):
                    if work.deadline is not None:
                        remaining_ms = max(
                            1.0, (work.deadline - time.monotonic()) * 1e3)
                        with transient.deadline_scope(remaining_ms):
                            data = await member.render(
                                work.ctx, adopt_cache=not work.stolen)
                    else:
                        data = await member.render(
                            work.ctx, adopt_cache=not work.stolen)
            except (ConnectionError, OSError) as e:
                if not member.remote and not isinstance(e, ConnectionError):
                    # A local OSError (a missing or truncated file) is
                    # this request's failure, never the member's death.
                    if not work.future.done():
                        work.future.set_exception(e)
                    continue
                if not isinstance(e, MemberDownError):
                    member.mark_down()
                    telemetry.FLIGHT.record("fleet.member-down",
                                            member=name,
                                            error=str(e)[:120])
                if not self.failover:
                    logger.warning("fleet member %s down (%s); failover "
                                   "disabled, failing its shard", name, e)
                    self._fail_queue(name, e)
                    if not work.future.done():
                        work.future.set_exception(e)
                    continue
                logger.warning("fleet member %s down (%s); failing its "
                               "shard over hash-ring-next", name, e)
                self._reassign(name)
                if work.hops < len(self.order) - 1:
                    self._route_failover(work)
                    self._wake.set()
                elif not work.future.done():
                    work.future.set_exception(e)
            except asyncio.CancelledError:
                # Teardown mid-render: the waiter maps this to a 500,
                # never a dropped connection.
                if not work.future.done():
                    work.future.set_exception(
                        RuntimeError("fleet router shut down"))
                raise
            except Exception as e:
                if not work.future.done():
                    work.future.set_exception(e)
            else:
                if work.trace_ids:
                    telemetry.record_span(
                        "fleet.hop", t_render,
                        (time.perf_counter() - t_render) * 1000.0,
                        trace_ids=work.trace_ids)
                if not work.future.done():
                    work.future.set_result(data)
                if work.stolen:
                    self._byte_putback(work, data)
            finally:
                self._inflight[name] -= 1

    # --------------------------------------------------------- accounting

    def shard_report(self) -> dict:
        """Raw-cache shard accounting over the in-process members: resident
        planes by member, and the content digests resident on more than
        one member, split into deliberate replicas of a promoted route and
        duplicate stagings (held at ~0).  Digests exist with
        ``raw-cache.digest-dedup`` on."""
        per_member = {}
        seen: Dict[str, int] = {}
        for name in self.order:
            member = self.members[name]
            per_member[name] = member.resident_planes()
            for d in member.resident_digests():
                seen[d] = seen.get(d, 0) + 1
        duplicates = replicated = 0
        if any(n > 1 for n in seen.values()):
            routes = self._local_digest_routes() if self._hot_ever else {}
            for d, n in seen.items():
                if n <= 1:
                    continue
                if routes.get(d) in self._hot_ever:
                    replicated += 1
                else:
                    duplicates += 1
        return {"members": per_member, "resident_digests": len(seen),
                "duplicate_digests": duplicates,
                "replicated_digests": replicated}

    def _local_digest_routes(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for name in self.order:
            cache = getattr(getattr(self.members[name], "services", None),
                            "raw_cache", None)
            if cache is None or not hasattr(cache, "snapshot_entries"):
                continue
            for entry in cache.snapshot_entries(0):
                if entry.get("digest"):
                    out[entry["digest"]] = entry.get("route")
        return out

    async def close(self) -> None:
        self._closed = True
        for task in self._lanes:
            task.cancel()
        if self._lanes:
            await asyncio.gather(*self._lanes, return_exceptions=True)
        self._lanes = []
        for task in list(self._putback_tasks):
            task.cancel()
        if self._putback_tasks:
            await asyncio.gather(*self._putback_tasks,
                                 return_exceptions=True)
        self._putback_tasks.clear()
        for queue in self._queues.values():
            while queue:
                work = queue.pop_raw()
                if not work.future.done():
                    work.future.set_exception(
                        RuntimeError("fleet router shut down"))


# ------------------------------------------------------ frontend handler

class FleetImageHandler:
    """The fleet's drop-in for ``ImageRegionHandler`` and
    ``SidecarImageHandler``: the byte cache first (combined role; a hit
    never sheds), then the peer byte fetch, then the session's fairness
    token, fleet-wide single-flight and fleet-wide admission, then the
    router.

    ``base_services`` (combined role) gives the shared byte caches and the
    ACL memo; a proxy fleet passes None (its sidecars own both) and
    coalesces per session.  ``fallback`` (``server.degraded``, proxy fleets
    only) serves when no member is left, never over a live member's
    verdict."""

    def __init__(self, router: FleetRouter, single_flight=None,
                 admission=None, base_services=None, fallback=None):
        self.router = router
        self.single_flight = single_flight
        self.admission = admission
        self.s = base_services
        self.fallback = fallback

    async def can_read(self, image_id: int,
                       session_key: Optional[str]) -> bool:
        """The read ACL of an image (the front's probe), as the members'
        handlers answer it."""
        from ..server.handler import check_can_read
        return await check_can_read(self.s, "Image", image_id, session_key)

    async def _cached(self, ctx) -> Optional[bytes]:
        if self.s is None:
            return None
        from ..server.errors import NotFoundError
        from ..utils import provenance, telemetry
        t0 = time.perf_counter()
        cached = await self.s.caches.image_region.get(ctx.cache_key)
        if cached is None:
            return None
        if not await self.can_read(ctx.image_id, ctx.omero_session_key):
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        telemetry.record_span("cache.hit", t0,
                              (time.perf_counter() - t0) * 1000.0)
        provenance.mark(ctx, tier="byte_cache")
        return cached

    async def render_image_region(self, ctx) -> bytes:
        from ..server.errors import NotFoundError, OverloadedError
        from ..server.pressure import shed_bulk_under_pressure
        from ..server.settings import render_identity_key
        from ..utils import provenance, telemetry, transient

        t0 = time.perf_counter()
        cached = await self._cached(ctx)
        if cached is not None:
            return cached
        if self.s is not None and not await self.can_read(
                ctx.image_id, ctx.omero_session_key):
            # Per caller, before the shared render is awaited.
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        peer_fetch = getattr(self.router, "fetch_peer_bytes", None)
        peer = await peer_fetch(ctx) if peer_fetch is not None else None
        if peer is not None:
            if self.s is not None:
                await self.s.caches.image_region.set(ctx.cache_key, peer)
            telemetry.record_span("cache.peer", t0,
                                  (time.perf_counter() - t0) * 1000.0)
            return peer
        admission = self.admission
        # The session's token, per caller and before coalescing.
        debit = (admission.admit_session(ctx) if admission is not None
                 else None)
        if debit is not None:
            provenance.mark(ctx, tokens=debit[1])

        async def produce() -> bytes:
            shed_bulk_under_pressure(ctx)
            t_admit = admission.admit() if admission is not None else None
            completed = False
            try:
                transient.check_deadline("fleet render")
                try:
                    data = await self.router.dispatch(ctx)
                except (ConnectionError, OverloadedError):
                    # Degraded mode only when no member is left.
                    if (self.fallback is None
                            or self.router.healthy_members()):
                        raise
                    telemetry.RESILIENCE.count_degraded_render()
                    provenance.mark(ctx, tier="degraded")
                    data = await self.fallback.render_image_region(ctx)
                completed = True
                return data
            finally:
                if admission is not None:
                    admission.release(t_admit, completed=completed)

        try:
            if self.single_flight is None:
                remaining = transient.remaining_ms()
                if remaining is None:
                    return await produce()
                try:
                    return await asyncio.wait_for(
                        produce(), timeout=max(0.0, remaining) / 1000.0)
                except asyncio.TimeoutError:
                    raise transient.DeadlineExceededError(
                        "deadline exceeded awaiting fleet render")
            key = render_identity_key(ctx)
            if self.s is None:
                # A proxy fleet cannot check the ACL: coalesce per session.
                key = f"{key}|{ctx.omero_session_key or ''}"
            data, coalesced = await self.single_flight.run(key, produce)
        except OverloadedError:
            if admission is not None:
                admission.refund_session(debit)
            raise
        if coalesced:
            telemetry.record_span("dedup.coalesced", t0,
                                  (time.perf_counter() - t0) * 1000.0)
            provenance.mark(ctx, coalesced=True)
        return data

    async def render_image_region_stream(self, ctx):
        """The chunked response's surface: the fleet's answer is one
        body."""
        yield await self.render_image_region(ctx)


# ---------------------------------------------------------- construction

def build_local_members(config, base_services, n: int,
                        device_sets: Optional[Sequence] = None
                        ) -> List[LocalMember]:
    """N in-process members over one host-side service stack: member 0 is
    the base stack; members 1..N-1 get their own renderer (a
    ``BatchingRenderer``, or the direct ``Renderer`` with the batcher off)
    and ``DeviceRawCache`` and share the pixel stores, byte caches,
    metadata, ACL memo and LUTs.

    ``device_sets[i]`` (a sequence of ``torch.device``) pins member i: its
    first device becomes ``pin_device`` and the renderer's and raw cache's
    device.  With none, every member takes the base renderer's device (the
    app's), as JAX's members take the process default device.  Member-level
    single-flight and admission are off: both live above the router.

    A ``lockstep`` member-0 renderer (``parallel.serve.MeshRenderer``)
    spans its whole mesh and is never pinned narrower; beside a mesh the
    other members render with the direct ``Renderer``, never a batcher
    (JAX ``:2518-2535``)."""
    import torch

    from ..io.devicecache import DeviceRawCache
    from ..server.batcher import BatchingRenderer
    from ..server.handler import (ImageRegionHandler, ImageRegionServices,
                                  Renderer)

    def devices_for(i: int) -> tuple:
        if not device_sets or i >= len(device_sets):
            return ()
        return tuple(torch.device(d) for d in device_sets[i] or ())

    cooldown = config.fleet.down_cooldown_s
    base_device = base_services.renderer.device
    lockstep = getattr(base_services.renderer, "lockstep", False)
    base_services.pin_device = (devices_for(0)[0]
                                if devices_for(0) and not lockstep
                                else None)
    if base_services.pin_device is not None:
        base_services.renderer.device = base_services.pin_device
    members = [LocalMember(
        "m0", ImageRegionHandler(base_services), services=base_services,
        down_cooldown_s=cooldown, byte_cache_prechecked=True,
        devices=devices_for(0))]
    b, rc = config.batcher, config.raw_cache
    for i in range(1, n):
        device = devices_for(i)[0] if devices_for(i) else base_device
        base_engine = getattr(base_services.renderer, "jpeg_engine", None)
        if b.enabled and not config.parallel.enabled:
            renderer = BatchingRenderer(
                device, max_batch=b.max_batch, linger_ms=b.linger_ms,
                pipeline_depth=b.pipeline_depth,
                device_lanes=b.device_lanes,
                jpeg_engine=(base_engine
                             if base_engine in ("sparse", "huffman")
                             else "sparse"),
                max_batch_limit=b.max_batch_limit,
                target_inflight=b.target_inflight)
            renderer.first_tile_out = config.wire.streaming
        else:
            engine = config.renderer.jpeg_engine
            if engine == "auto":
                engine = base_engine or "sparse"
            renderer = Renderer(device, jpeg_engine=engine)
        raw_cache = (DeviceRawCache(rc.max_bytes, device=device,
                                    digest_index=rc.digest_dedup)
                     if rc.enabled else None)
        services = ImageRegionServices(
            pixels_service=base_services.pixels_service,
            metadata=base_services.metadata,
            renderer=renderer,
            lut_provider=base_services.lut_provider,
            max_tile_length=base_services.max_tile_length,
            jpeg_host_max_px=base_services.jpeg_host_max_px,
            raw_cache=raw_cache,
            caches=base_services.caches,
            can_read_memo=base_services.can_read_memo,
            pin_device=devices_for(i)[0] if devices_for(i) else None)
        members.append(LocalMember(
            f"m{i}", ImageRegionHandler(services), services=services,
            down_cooldown_s=cooldown, byte_cache_prechecked=True,
            devices=devices_for(i)))
    return members
