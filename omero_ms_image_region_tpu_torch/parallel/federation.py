"""Cross-host fleet federation: one shard map across hosts.

Counterpart of the JAX package's ``parallel/federation.py``, with the same
names, wire fields, digests and decisions, so a port host and a JAX host
speak the same sidecar v3 ops.  The reference clusters its verticles
across JVMs with Vert.x and Hazelcast: each node joins one cluster whose
view decides who serves what.  The fleet (``parallel.fleet``) is that on
one host; this module spans hosts:

* **The manifest** (:class:`FleetManifest`): member names, the host each
  lives on, the ring seed and replica count, and the shard epoch
  (``version``).  Its BLAKE2b digest over canonical JSON is the agreement
  token: two processes with one digest give every ``plane_route_key`` the
  same owner.
* **Agreement at join** (``manifest_hello``): a joiner sends its manifest
  to every remote member.  Equal digests agree; a higher epoch on either
  side is a rollout in flight (the lower side records the newer manifest
  as pending and keeps routing its own until rolled); the same epoch with
  another digest is a refused join (:class:`FederationError`).
* **Gossip** (``member_gossip``): hosts swap member health and drain
  views, each observation versioned ``(incarnation, seq)``, so a drain or
  a death on one host reaches the others in one interval; wall clocks
  never order them.
* **Quorum** (:class:`QuorumTracker`): a host is quorate while it hears a
  strict majority of manifest hosts within ``suspect-after-s``.  A
  minority island fences: it serves what its own shards prove and refuses
  shard adoption, write-backs, promotions, autoscaler transitions, inbound
  transfers and rolls until the partition heals.
* **Epoch rolls** (``epoch_propose`` / ``epoch_commit``): a coordinator
  proposes the next manifest, needs a strict majority of host acks, then
  commits; routers swap rings only at commit (the roll hook).
* **Cross-host warm handoff** (``shard_transfer``): a drain whose
  successor is on another host ships the warm plane bytes, since the
  successor cannot re-read this host's pixel store.
* **Device pinning** (:func:`partition_local_devices`): the combined role
  splits this process's CUDA devices across its local members.
* **Shard-aware prefetch**: a predicted plane whose owner is remote is
  staged on the owner's host
  (:meth:`~.fleet.FleetRouter.remote_prestage_for_route`).

Topology: each host runs the combined role with a ``federation:`` block
naming every member fleet-wide; members on this host are built in-process,
the rest are :class:`~.fleet.RemoteMember` handles over their sidecar
addresses, all in manifest order, so the ring, the bulk pin and drain
victims agree everywhere.  A ``--role sidecar`` process with the block
installs the manifest, answers the ops and gossips with the other hosts.

Nothing here imports ``torch`` at module level (:func:`partition_local_devices`
imports it when it has to list the devices).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .fleet import HashRing

logger = logging.getLogger("omero_ms_image_region_tpu_torch.federation")

# Probe keys every agreement exchange verifies against the peer's own
# ring math: deterministic, spread across the key space.  Golden
# assignments holding on these is the fleet-wide shard-map contract.
PROBE_KEYS = tuple(f"fed-probe-{i:03d}" for i in range(16))


class FederationError(RuntimeError):
    """A refused join: same shard epoch, different manifest digest —
    serving with a split-brain shard map would double-stage every
    plane and undo the fleet's whole point."""


@dataclass(frozen=True)
class MemberSpec:
    """One fleet member's identity in the manifest: its fleet name,
    the host that owns its devices, and — for members reached from
    OTHER hosts — the sidecar address (unix path or host:port)."""

    name: str
    host: str
    address: str = ""

    def to_json(self) -> dict:
        return {"name": self.name, "host": self.host,
                "address": self.address}

    @classmethod
    def from_json(cls, doc: dict) -> "MemberSpec":
        return cls(name=str(doc["name"]), host=str(doc["host"]),
                   address=str(doc.get("address") or ""))


class FleetManifest:
    """The versioned, digest-agreed membership document.

    ``version`` is the SHARD EPOCH: any membership/ring change bumps
    it, and agreement compares epochs before digests — a peer carrying
    a higher epoch wins (ordered rollout), equal epochs must match
    exactly.  The digest is BLAKE2b over canonical (sorted-key,
    compact) JSON, so agreement is byte-math, never trust.
    """

    def __init__(self, members: Sequence[MemberSpec], version: int = 1,
                 ring_seed: str = "", replicas: int = 64):
        members = tuple(members)
        if not members:
            raise ValueError("federation manifest needs >= 1 member")
        names = [m.name for m in members]
        if len(set(names)) != len(names):
            raise ValueError("duplicate member names in federation "
                             "manifest")
        if int(version) < 1:
            raise ValueError("federation shard epoch (version) must "
                             "be >= 1")
        self.members: Tuple[MemberSpec, ...] = members
        self.version = int(version)
        self.ring_seed = str(ring_seed)
        self.replicas = max(1, int(replicas))

    # ------------------------------------------------------------ identity

    def canonical_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "ring_seed": self.ring_seed,
            "replicas": self.replicas,
            "members": [m.to_json() for m in self.members],
        }, sort_keys=True, separators=(",", ":"))

    def digest(self) -> str:
        return hashlib.blake2b(self.canonical_json().encode(),
                               digest_size=16).hexdigest()

    def to_json(self) -> dict:
        return json.loads(self.canonical_json())

    @classmethod
    def from_json(cls, doc: dict) -> "FleetManifest":
        return cls(
            members=[MemberSpec.from_json(m)
                     for m in (doc.get("members") or ())],
            version=int(doc.get("version", 1)),
            ring_seed=str(doc.get("ring_seed") or ""),
            replicas=int(doc.get("replicas", 64)))

    @classmethod
    def from_config(cls, fed) -> "FleetManifest":
        """Build from a validated ``federation:`` config block
        (``server.config.FederationConfig``)."""
        return cls(
            members=[MemberSpec(name=m["name"], host=m["host"],
                                address=m.get("address", ""))
                     for m in fed.members],
            version=fed.shard_epoch,
            ring_seed=fed.ring_seed,
            replicas=fed.hash_replicas)

    # -------------------------------------------------------------- lookup

    def names(self) -> List[str]:
        return [m.name for m in self.members]

    def host_of(self, name: str) -> str:
        """The host that owns the named member ("" when unknown) —
        the ``host`` dimension on ``fed.hop`` spans and decision
        records."""
        for m in self.members:
            if m.name == name:
                return m.host
        return ""

    def local_members(self, host: str) -> List[MemberSpec]:
        return [m for m in self.members if m.host == host]

    def remote_members(self, host: str) -> List[MemberSpec]:
        return [m for m in self.members if m.host != host]

    def ring(self) -> HashRing:
        """THE fleet-wide ring: every process with an agreeing manifest
        constructs this identically — golden ``plane_route_key``
        assignments hold across hosts by construction."""
        return HashRing(self.names(), replicas=self.replicas,
                        seed=self.ring_seed)

    def owners(self, keys: Sequence[str]) -> List[str]:
        ring = self.ring()
        return [ring.member(k) for k in keys]


# ------------------------------------------------- module-global install

# The process's ACTIVE manifest (the ``pressure.install`` idiom): the
# sidecar wire ops answer from here, so a sidecar process and its
# frontends share one source of truth per process.  The active
# manifest is immutable for the process life — the router, the
# prefetch routing and every staged plane's ownership were built from
# it; a newer epoch learned from a peer lands in ``_PENDING`` (loud on
# every status surface) and activates on the next process roll.
_MANIFEST: Optional[FleetManifest] = None
_PENDING: Optional[FleetManifest] = None
# This process's federation host identity (``federation.host``):
# stamped on hello/gossip answers so peers label clocks, spans and
# decision records without a reverse manifest lookup.
_SELF_HOST: str = ""
# This process's gossip INCARNATION (the SWIM idiom): bumped past
# wall-clock seconds at install so a restarted host's fresh state
# versions ABOVE its pre-crash ghost, and bumped past any stale
# higher-versioned claim a peer holds about our own members
# (self-refutation in local_view).  ``_LOCAL_SEQ`` bumps on every
# local member state change; observations carry ``(inc, seq)`` and
# merges compare those, never wall clocks.
_INCARNATION: int = 0
_LOCAL_SEQ: int = 0
# member name -> last (healthy, draining) this process published, so
# local_view knows when to bump _LOCAL_SEQ.
_LOCAL_LAST: Dict[str, tuple] = {}
# The router swap hook (set by the serving layer): called with the
# newly-activated manifest at epoch COMMIT — the only instant a live
# ring may change.
_ROLL_HOOK = None
_QUORUM: Optional["QuorumTracker"] = None


def install(manifest: FleetManifest,
            self_host: Optional[str] = None) -> None:
    global _MANIFEST, _SELF_HOST, _INCARNATION
    _MANIFEST = manifest
    # Strictly increasing across restarts AND within a process (the
    # max() arm covers frozen/mocked clocks): a rejoining host's first
    # gossip supersedes every pre-crash observation of its members.
    _INCARNATION = max(_INCARNATION + 1, int(time.time()))
    from ..utils import decisions, telemetry
    if self_host is not None:
        _SELF_HOST = self_host
        # Decision records from this process are now attributable in
        # a merged fleet timeline.
        decisions.LEDGER.configure(host=self_host)
    telemetry.FEDERATION.set_manifest(manifest.version,
                                      len(manifest.members))
    decisions.record("epoch", "installed", detail={
        "epoch": manifest.version, "digest": manifest.digest(),
        "members": len(manifest.members)})
    if _QUORUM is not None:
        _QUORUM.set_manifest(manifest)
    logger.info("federation manifest installed: epoch %d, %d members, "
                "digest %s", manifest.version, len(manifest.members),
                manifest.digest())


def current() -> Optional[FleetManifest]:
    return _MANIFEST


def self_host() -> str:
    return _SELF_HOST


def remote_host_of(name: str) -> str:
    """The federation host of member ``name`` when it lives on a
    DIFFERENT host than this process — "" for same-host members,
    unknown names, or when no manifest is installed.  The gate the
    router's ``fed.hop`` spans key on: a federation hop is cross-host
    by definition, and single-host fleets must not pay for (or fake)
    one."""
    if _MANIFEST is None:
        return ""
    host = _MANIFEST.host_of(name)
    if not host or host == _SELF_HOST:
        return ""
    return host


def set_pending(manifest: FleetManifest) -> None:
    """Record a NEWER epoch learned from a peer.  Never activates in
    place: the live router routes the manifest it was built from, and
    agreement answers must keep describing what this process actually
    routes — the pending epoch is the operator's signal to roll."""
    global _PENDING
    if _PENDING is None or manifest.version > _PENDING.version:
        _PENDING = manifest
        from ..utils import decisions
        decisions.record("epoch", "pending", detail={
            "pending_epoch": manifest.version,
            "pending_digest": manifest.digest(),
            "active_epoch": _MANIFEST.version if _MANIFEST else None})
        logger.warning(
            "federation manifest epoch %d is pending (active epoch "
            "%s) — roll this process to activate it",
            manifest.version,
            _MANIFEST.version if _MANIFEST else None)


def pending() -> Optional[FleetManifest]:
    return _PENDING


def uninstall() -> None:
    global _MANIFEST, _PENDING, _SELF_HOST, _ROLL_HOOK, _QUORUM
    global _LOCAL_SEQ
    _MANIFEST = None
    _PENDING = None
    _SELF_HOST = ""
    _ROLL_HOOK = None
    _QUORUM = None
    _LOCAL_SEQ = 0
    _LOCAL_LAST.clear()
    _HOST_CLOCKS.clear()


# ----------------------------------------------------- quorum membership

class QuorumTracker:
    """Strict-majority membership over the manifest's DISTINCT hosts.

    A host is *heard* while its last successful gossip/hello exchange
    (either direction) is younger than ``suspect_after_s``; the view
    is QUORATE while ``heard hosts (self included)`` is a strict
    majority of manifest hosts.  Losing quorum FENCES this process:
    :meth:`allow` refuses (and counts) every state-changing action in
    :data:`ACTIONS` — reads this host can prove from its own shards
    keep serving — and regaining quorum restores.  Transitions land in
    the decision ledger (kind=``quorum``, verdicts
    ``fenced``/``restored``) and on the flight ring
    (``quorum.fence``/``quorum.restore``); /readyz and
    /admin/federation annotate from :meth:`status`.

    Liveness is tracked on ``time.monotonic()`` — the whole point is
    immunity to wall clocks.  Remote hosts start as heard-now
    (innocent until ``suspect_after_s`` of silence): fencing a booting
    majority host for the crime of not having gossiped yet would turn
    every cold start into an outage.  Single-host manifests are
    always quorate (majority of 1)."""

    ACTIONS = ("adoption", "write_authority", "promotion",
               "autoscaler", "transfer", "roll")

    def __init__(self, manifest: FleetManifest, self_host: str,
                 suspect_after_s: float = 10.0,
                 clock=time.monotonic):
        self.self_host = str(self_host)
        self.suspect_after_s = max(0.1, float(suspect_after_s))
        self.clock = clock
        self.fenced = False
        self.fence_t: Optional[float] = None
        self.restore_t: Optional[float] = None
        self.refusals: Dict[str, int] = {}
        self._hosts: set = set()
        self._heard: Dict[str, float] = {}
        self.set_manifest(manifest)

    def set_manifest(self, manifest: FleetManifest) -> None:
        """Adopt a (possibly rolled) manifest's host set; hosts new to
        the membership start heard-now, departed hosts drop out of the
        denominator."""
        self._hosts = {m.host for m in manifest.members}
        now = self.clock()
        for host in self._hosts:
            if host != self.self_host:
                self._heard.setdefault(host, now)
        for host in list(self._heard):
            if host not in self._hosts:
                del self._heard[host]

    def observe(self, host: str) -> None:
        """One successful exchange with ``host`` (either direction —
        an inbound hello/gossip proves the link exactly as well as an
        answered outbound one)."""
        host = str(host or "")
        if host and host != self.self_host and host in self._hosts:
            self._heard[host] = self.clock()

    def reachable_hosts(self) -> List[str]:
        now = self.clock()
        return sorted(
            h for h, t in self._heard.items()
            if now - t <= self.suspect_after_s)

    def quorate(self) -> bool:
        return (1 + len(self.reachable_hosts())) * 2 > \
            max(1, len(self._hosts))

    def evaluate(self) -> bool:
        """Recompute the verdict and record fence/restore transitions.
        Cheap enough for per-dispatch callers (a set scan over <=
        manifest-host-count entries)."""
        from ..utils import decisions, telemetry
        reachable = self.reachable_hosts()
        quorate = (1 + len(reachable)) * 2 > max(1, len(self._hosts))
        telemetry.QUORUM.set_quorum(quorate, 1 + len(reachable),
                                    len(self._hosts))
        if quorate and self.fenced:
            self.fenced = False
            self.restore_t = self.clock()
            telemetry.QUORUM.count_transition("restored")
            telemetry.FLIGHT.record(
                "quorum.restore", host=self.self_host,
                reachable=1 + len(reachable),
                hosts=len(self._hosts))
            decisions.record("quorum", "restored", detail={
                "reachable": [self.self_host] + reachable,
                "hosts": sorted(self._hosts),
                "fenced_s": (round(self.restore_t - self.fence_t, 3)
                             if self.fence_t is not None else None),
                "refusals": dict(self.refusals)})
            logger.warning(
                "quorum restored: %d/%d hosts reachable (refused "
                "while fenced: %s)", 1 + len(reachable),
                len(self._hosts), dict(self.refusals) or "nothing")
        elif not quorate and not self.fenced:
            self.fenced = True
            self.fence_t = self.clock()
            telemetry.QUORUM.count_transition("fenced")
            telemetry.FLIGHT.record(
                "quorum.fence", host=self.self_host,
                reachable=1 + len(reachable),
                hosts=len(self._hosts))
            decisions.record("quorum", "fenced", detail={
                "reachable": [self.self_host] + reachable,
                "hosts": sorted(self._hosts),
                "suspect_after_s": self.suspect_after_s})
            logger.warning(
                "quorum LOST: only %d/%d hosts reachable — fencing "
                "(own-shard reads keep serving; adoption, write-backs,"
                " promotions, autoscaling and rolls refuse)",
                1 + len(reachable), len(self._hosts))
        return quorate

    def allow(self, action: str) -> bool:
        """May this state-changing ``action`` proceed?  False counts a
        refusal (telemetry + the restore record's tally) — callers
        skip/fail the action, they never raise from here."""
        if self.evaluate():
            return True
        if action in self.ACTIONS:
            from ..utils import telemetry
            telemetry.QUORUM.count_refusal(action)
            self.refusals[action] = self.refusals.get(action, 0) + 1
        return False

    def status(self) -> dict:
        """The /admin/federation ``quorum`` section (and the /readyz
        annotation material)."""
        self.evaluate()
        return {
            "quorate": not self.fenced,
            "fenced": self.fenced,
            "hosts": sorted(self._hosts),
            "reachable": [self.self_host] + self.reachable_hosts(),
            "suspect_after_s": self.suspect_after_s,
            "refusals": dict(self.refusals),
        }


def install_quorum(tracker: Optional[QuorumTracker]) -> None:
    global _QUORUM
    _QUORUM = tracker


def quorum_tracker() -> Optional[QuorumTracker]:
    return _QUORUM


def observe_host(host) -> None:
    """Feed one successful cross-host exchange into the quorum
    tracker (no-op when quorum is off)."""
    if _QUORUM is not None and host:
        _QUORUM.observe(str(host))


def is_fenced() -> bool:
    """Is this process a fenced minority island right now?  False
    when quorum tracking is off — every pre-quorum behavior is then
    bit-exact."""
    return _QUORUM is not None and not _QUORUM.evaluate()


def quorum_allow(action: str) -> bool:
    """Gate a state-changing action on quorum (True when tracking is
    off).  The fence sites: ring adoption / failover re-homes
    (``adoption``), byte-tier write-backs (``write_authority``),
    hot-key promotions (``promotion``), autoscaler transitions
    (``autoscaler``), inbound shard staging (``transfer``) and epoch
    rolls (``roll``)."""
    if _QUORUM is None:
        return True
    return _QUORUM.allow(action)


def quorum_status() -> Optional[dict]:
    return _QUORUM.status() if _QUORUM is not None else None


# -------------------------------------------------- orchestrated rolls

def set_roll_hook(hook) -> None:
    """Register the serving layer's ring-swap callback: called with
    the newly-activated :class:`FleetManifest` at epoch COMMIT (the
    only instant a live ring may change)."""
    global _ROLL_HOOK
    _ROLL_HOOK = hook


def activate_manifest(manifest: FleetManifest) -> bool:
    """Activate a committed epoch: swap the process-global manifest,
    clear a pending copy it supersedes, and invoke the roll hook so
    the live router swaps rings atomically.  Idempotent — activating
    the already-active (or an older) epoch is a no-op returning
    False."""
    global _MANIFEST, _PENDING
    mine = _MANIFEST
    if mine is not None and manifest.version <= mine.version:
        return False
    from ..utils import decisions, telemetry
    _MANIFEST = manifest
    if _PENDING is not None \
            and _PENDING.version <= manifest.version:
        _PENDING = None
    telemetry.FEDERATION.set_manifest(manifest.version,
                                      len(manifest.members))
    if _QUORUM is not None:
        _QUORUM.set_manifest(manifest)
    decisions.record("epoch", "installed", detail={
        "epoch": manifest.version, "digest": manifest.digest(),
        "members": len(manifest.members), "roll": True})
    hook = _ROLL_HOOK
    if hook is not None:
        try:
            hook(manifest)
        except Exception:
            logger.exception("epoch roll hook failed (epoch %d) — "
                             "manifest activated, ring swap did not "
                             "complete", manifest.version)
    logger.info("epoch %d activated by orchestrated roll (digest %s)",
                manifest.version, manifest.digest())
    return True


# ----------------------------------------------------- cross-host clocks

# host -> {"offset": local_perf - remote_perf, "rtt_ms", "ts"}.  The
# same midpoint anchoring the sidecar ``hello`` does per connection,
# lifted to per-HOST: every ``manifest_hello`` / ``member_gossip``
# answer carries the peer's ``time.perf_counter()``, the caller takes
# the send/recv midpoint as the instant that clock was read, and the
# difference maps remote span anchors into this process's timeline.
# Re-derived on every exchange, so drift is bounded by the gossip
# interval.
_HOST_CLOCKS: Dict[str, dict] = {}


def record_host_clock(host: str, t_send: float, t_recv: float,
                      remote_clock) -> Optional[float]:
    """Derive and store the per-host clock offset from one exchange.
    Returns the offset, or None when the peer answered without the
    anchor field (an older build — callers degrade to unanchored
    spans, never error)."""
    if not host or remote_clock is None:
        return None
    try:
        remote = float(remote_clock)
    except (TypeError, ValueError):
        return None
    offset = (t_send + t_recv) / 2.0 - remote
    _HOST_CLOCKS[str(host)[:64]] = {
        "offset": offset,
        "rtt_ms": round((t_recv - t_send) * 1000.0, 3),
        "ts": time.time(),
    }
    return offset


def host_clock_offset(host: str) -> Optional[float]:
    doc = _HOST_CLOCKS.get(host)
    return doc["offset"] if doc else None


def host_clocks() -> Dict[str, dict]:
    return {k: dict(v) for k, v in _HOST_CLOCKS.items()}


def anchor_remote_time(host: str, remote_t,
                       window: Tuple[float, float]) -> Optional[float]:
    """Map a remote ``perf_counter`` instant into this process's
    timeline, CLAMPED into ``window`` (the local [send, recv] bracket
    of the exchange that carried it) — the sidecar ``_graft_response``
    contract: a skewed or stale offset may place the child oddly
    WITHIN its parent's window, never outside it.  None when the host
    has no derived offset (unanchored degrade)."""
    off = host_clock_offset(host)
    if off is None or remote_t is None:
        return None
    try:
        t = float(remote_t) + off
    except (TypeError, ValueError):
        return None
    lo, hi = window
    return min(max(t, lo), hi)


# ------------------------------------------------------ wire-op handlers

def handle_manifest_hello(header: dict) -> dict:
    """Server side of the ``manifest_hello`` op (runs in the sidecar's
    request handler).  Compares the joiner's manifest against this
    process's installed one and answers the agreement verdict plus —
    when probe keys rode along — this process's OWN ring owner for
    each (the cross-process golden-assignment check).

    No manifest installed = a legacy / un-federated process: answers
    ``{"enabled": false}`` and the coordinator degrades (counts
    ``legacy``, serves without federation features on that peer)."""
    from ..utils import decisions, telemetry
    mine = _MANIFEST
    if mine is None:
        return {"enabled": False}
    # An inbound hello proves the sender's host is reachable exactly
    # as well as an answered outbound exchange would.
    observe_host(header.get("from_host"))
    doc: dict = {
        "enabled": True,
        "version": mine.version,
        "digest": mine.digest(),
        # Clock anchor (the sidecar ``hello`` idiom, per HOST): the
        # caller midpoints its send/recv around this read and derives
        # the offset that grafts our spans onto its waterfalls.
        "clock": time.perf_counter(),
        "host": _SELF_HOST,
    }
    theirs_doc = header.get("manifest")
    if isinstance(theirs_doc, dict):
        try:
            theirs = FleetManifest.from_json(theirs_doc)
        except (KeyError, TypeError, ValueError):
            theirs = None
        if theirs is None:
            doc["agreed"] = False
            doc["reason"] = "malformed"
            telemetry.FEDERATION.count_agreement("split-brain")
            decisions.record("manifest", "split-brain",
                             detail={"reason": "malformed"})
        elif theirs.digest() == mine.digest():
            doc["agreed"] = True
            telemetry.FEDERATION.count_agreement("agreed")
            decisions.record("manifest", "agreed",
                             detail={"epoch": mine.version})
        elif theirs.version > mine.version:
            # The joiner carries a NEWER shard epoch: a rolling config
            # update reached it first.  Record it PENDING — this
            # process keeps routing the epoch its router was built
            # from until the operator rolls it; answering "agreed" to
            # a map we are not routing would be the silent split-brain
            # this op exists to refuse.
            set_pending(theirs)
            doc["agreed"] = False
            doc["reason"] = "pending"
            doc["pending_version"] = theirs.version
            telemetry.FEDERATION.count_agreement("pending")
            decisions.record("manifest", "pending", detail={
                "epoch": mine.version,
                "pending_epoch": theirs.version})
        elif theirs.version < mine.version:
            # The joiner is behind: send ours so IT records the
            # pending epoch and its operator rolls it.
            doc["agreed"] = False
            doc["reason"] = "stale-epoch"
            doc["manifest"] = mine.to_json()
            telemetry.FEDERATION.count_agreement("stale")
            decisions.record("manifest", "stale", detail={
                "epoch": mine.version,
                "joiner_epoch": theirs.version})
        else:
            doc["agreed"] = False
            doc["reason"] = "split-brain"
            telemetry.FEDERATION.count_agreement("split-brain")
            decisions.record("manifest", "split-brain",
                             detail={"epoch": mine.version})
    probe_keys = header.get("probe_keys")
    if isinstance(probe_keys, list) and probe_keys:
        doc["owners"] = mine.owners([str(k) for k in probe_keys[:64]])
    return doc


# Gossip view: member name -> {"healthy": bool, "draining": bool,
# "inc": int, "seq": int, "ts": float}.  The HIGHEST ``(inc, seq)``
# observation wins on merge — logical versions, never wall clocks (a
# skewed-ahead peer could otherwise pin a stale verdict forever).
# ``ts`` survives for display only.  Legacy observations without
# ``inc`` compare as ``(0, ts)``: among themselves they keep the old
# newest-ts behavior, and ANY versioned observation supersedes them.
_GOSSIP_VIEW: Dict[str, dict] = {}


def _obs_version(obs: dict) -> tuple:
    """An observation's logical version for merge ordering."""
    try:
        inc = int(obs.get("inc", 0))
    except (TypeError, ValueError):
        inc = 0
    if inc > 0:
        try:
            return (inc, float(obs.get("seq", 0)))
        except (TypeError, ValueError):
            return (inc, 0.0)
    try:
        return (0, float(obs.get("ts", 0)))
    except (TypeError, ValueError):
        return (0, 0.0)


def local_view(router, self_host: str = "") -> Dict[str, dict]:
    """This process's authoritative member observations: LOCAL members'
    health/drain state straight from the router (a host knows its own
    members best), stamped with this process's ``(incarnation, seq)``
    — seq bumps on every state change, so a changed truth always
    versions above the last one we published.

    Self-refutation (the SWIM rejoin rule): if the merged view holds a
    HIGHER-versioned observation about one of our own members that
    disagrees with the live router state — a pre-restart ghost of
    ourselves, or a peer's stale relay — bump our incarnation above it
    so the fresh truth supersedes fleet-wide."""
    global _INCARNATION, _LOCAL_SEQ
    mine = _MANIFEST
    view: Dict[str, dict] = {}
    if router is None or mine is None:
        return view
    now = time.time()
    local = {m.name for m in mine.local_members(self_host)} \
        if self_host else set(router.order)
    for name in router.order:
        if name not in local:
            continue
        member = router.members.get(name)
        if member is None:
            continue
        state = (bool(member.healthy), bool(member.draining))
        if _LOCAL_LAST.get(name) != state:
            _LOCAL_LAST[name] = state
            _LOCAL_SEQ += 1
        held = _GOSSIP_VIEW.get(name)
        if held is not None \
                and _obs_version(held) > (_INCARNATION, _LOCAL_SEQ) \
                and (bool(held.get("healthy", True)),
                     bool(held.get("draining", False))) != state:
            _INCARNATION = max(_INCARNATION,
                               _obs_version(held)[0]) + 1
        obs = {"healthy": state[0],
               "draining": state[1],
               "inc": _INCARNATION,
               "seq": _LOCAL_SEQ,
               "ts": now}
        # Hot-key posture rides the gossip wire: how many promoted
        # routes this member serves replicas for (duck-typed — drill
        # routers may predate the hot tier), so peers can see a storm
        # concentrating on one host before its queues say so.
        hot_fn = getattr(router, "hot_owned", None)
        if hot_fn is not None:
            try:
                hot = int(hot_fn(name))
            except Exception:
                hot = 0
            if hot:
                obs["hot"] = hot
        view[name] = obs
    return view


def merge_view(view: dict) -> Dict[str, dict]:
    """Fold a peer's view into the process gossip state (highest
    ``(incarnation, seq)`` per member wins — see ``_obs_version``)
    and return the merged state.

    Names are validated against the ACTIVE manifest (the socket is
    unauthenticated-by-design like every sidecar op, and the merged
    view is re-broadcast in every gossip answer — an unvalidated name
    would live in this module-global forever and propagate
    fleet-wide), so the view is bounded by the membership.  With no
    manifest installed (bare tests), a hard cap stands in."""
    mine = _MANIFEST
    known = set(mine.names()) if mine is not None else None
    if isinstance(view, dict):
        for name, obs in view.items():
            if not isinstance(obs, dict):
                continue
            # Store and look up under the SAME (bounded) key, or an
            # over-long name would bypass the versioned merge.
            name = str(name)[:64]
            if known is not None:
                if name not in known:
                    continue
            elif name not in _GOSSIP_VIEW \
                    and len(_GOSSIP_VIEW) >= 256:
                continue
            held = _GOSSIP_VIEW.get(name)
            if held is None or _obs_version(obs) > _obs_version(held):
                stored = {
                    "healthy": bool(obs.get("healthy", True)),
                    "draining": bool(obs.get("draining", False)),
                    "ts": float(obs.get("ts", 0)),
                }
                version = _obs_version(obs)
                if version[0] > 0:
                    stored["inc"] = version[0]
                    stored["seq"] = int(version[1])
                try:
                    hot = int(obs.get("hot", 0))
                except (TypeError, ValueError):
                    hot = 0
                if hot > 0:
                    stored["hot"] = min(hot, 1 << 20)
                _GOSSIP_VIEW[name] = stored
    return dict(_GOSSIP_VIEW)


def handle_member_gossip(header: dict) -> dict:
    """Server side of ``member_gossip``: merge the sender's view, answer
    ours + the manifest identity (drift between gossiping peers is a
    mismatch the coordinator surfaces).  The answer also carries this
    host's clock anchor (re-derived offset every round — reconnect
    recovery for free) and its ``SloEngine`` window buckets, so the
    gossip wire doubles as the fleet-SLO export path with no extra
    round trips."""
    from ..utils import telemetry
    mine = _MANIFEST
    observe_host(header.get("from_host"))
    merged = merge_view(header.get("view") or {})
    doc: dict = {"enabled": mine is not None, "view": merged}
    if mine is not None:
        doc["version"] = mine.version
        doc["digest"] = mine.digest()
        doc["clock"] = time.perf_counter()
        doc["host"] = _SELF_HOST
        slo = telemetry.SLO.export_buckets()
        if slo:
            doc["slo"] = slo
        # Perf-sentinel piggyback, same posture as the SLO buckets:
        # this host's last tick summary rides the gossip answer so
        # every peer's /debug/sentinel sees the fleet drift picture
        # with no extra round trips.
        sen = telemetry.SENTINEL.export()
        if sen:
            doc["sentinel"] = sen
    return doc


def handle_epoch_propose(header: dict) -> dict:
    """Server side of ``epoch_propose`` (two-phase roll, phase 1):
    validate the proposed manifest, record it PENDING, and ack.
    Nothing activates here — the live router keeps routing the epoch
    it was built with until the commit.  Idempotent: re-proposing the
    version already pending (a coordinator that died mid-propose and
    resumed) acks again; proposing at-or-below the active epoch
    refuses ``stale`` unless it IS the active manifest
    (``already-active`` — a crash-resumed roll finding its work done).
    A fenced minority host refuses — it cannot know whether the
    majority already rolled past this proposal."""
    from ..utils import telemetry
    mine = _MANIFEST
    if mine is None:
        return {"enabled": False}
    observe_host(header.get("from_host"))
    doc: dict = {"enabled": True, "host": _SELF_HOST,
                 "clock": time.perf_counter()}
    try:
        proposed = FleetManifest.from_json(header.get("manifest") or {})
    except (KeyError, TypeError, ValueError):
        doc.update(ack=False, reason="malformed")
        return doc
    if is_fenced():
        quorum_allow("roll")         # count the refusal
        doc.update(ack=False, reason="fenced")
        return doc
    if proposed.version <= mine.version:
        if proposed.digest() == mine.digest():
            doc.update(ack=True, reason="already-active")
        else:
            doc.update(ack=False, reason="stale",
                       active_version=mine.version)
        return doc
    set_pending(proposed)
    telemetry.FLIGHT.record("epoch.propose", epoch=proposed.version,
                            digest=proposed.digest()[:12],
                            by=str(header.get("from_host") or "?"))
    doc.update(ack=True, reason="pending",
               pending_version=proposed.version)
    return doc


def handle_epoch_commit(header: dict) -> dict:
    """Server side of ``epoch_commit`` (two-phase roll, phase 2):
    digest-verify the committed manifest and ACTIVATE it — the one
    instant the ring swaps (via the registered roll hook).  Idempotent:
    committing the already-active epoch answers ``already-active``; an
    older epoch answers ``stale`` (a superseded roll's late commit
    must not regress the fleet).  The commit carries the FULL
    manifest, so a host that never saw the propose (rebooted between
    phases, or healed from a partition after the roll) still converges
    — this is also the anti-entropy catch-up the gossip loop pushes to
    stale peers."""
    from ..utils import telemetry
    mine = _MANIFEST
    if mine is None:
        return {"enabled": False}
    observe_host(header.get("from_host"))
    doc: dict = {"enabled": True, "host": _SELF_HOST,
                 "clock": time.perf_counter()}
    try:
        committed = FleetManifest.from_json(
            header.get("manifest") or {})
    except (KeyError, TypeError, ValueError):
        doc.update(ack=False, reason="malformed")
        return doc
    claimed = header.get("digest")
    if claimed is not None and str(claimed) != committed.digest():
        # The unauthenticated-socket posture: the doc must be
        # byte-exactly what the coordinator committed fleet-wide.
        doc.update(ack=False, reason="digest-mismatch")
        return doc
    if committed.version < mine.version:
        doc.update(ack=False, reason="stale",
                   active_version=mine.version)
        return doc
    if committed.version == mine.version:
        ok = committed.digest() == mine.digest()
        doc.update(ack=ok, reason="already-active" if ok
                   else "split-brain")
        return doc
    activate_manifest(committed)
    telemetry.FLIGHT.record("epoch.commit", epoch=committed.version,
                            digest=committed.digest()[:12],
                            by=str(header.get("from_host") or "?"))
    doc.update(ack=True, reason="installed",
               active_version=committed.version)
    return doc


def reset_gossip() -> None:
    """Test isolation."""
    global _LOCAL_SEQ
    _GOSSIP_VIEW.clear()
    _LOCAL_LAST.clear()
    _LOCAL_SEQ = 0


# ------------------------------------------------------- device pinning

def partition_local_devices(n_members: int,
                            devices: Optional[Sequence] = None
                            ) -> List[list]:
    """Partition this process's devices across ``n_members`` local
    members: contiguous, deterministic, the remainder to the earliest
    members (so member 0, the mesh and bulk lane, is never the short one).
    ``devices`` None lists the CUDA devices (``torch.device("cuda:i")``
    for ``i < torch.cuda.device_count()``).  Fewer devices than members
    leaves the tail members unpinned (the app's device) rather than
    pinning two members to one card: one H100 gives ``[[cuda:0], []]``."""
    if n_members < 1:
        raise ValueError("partition needs >= 1 member")
    if devices is None:
        import torch
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_dev = len(devices)
    if n_dev == 0:
        return [[] for _ in range(n_members)]
    base, extra = divmod(n_dev, n_members)
    out: List[list] = []
    i = 0
    for m in range(n_members):
        take = base + (1 if m < extra else 0)
        out.append(devices[i:i + take])
        i += take
    return out


# --------------------------------------------------------- construction

def build_federated_members(config, base_services, manifest,
                            client_factory, self_host: str):
    """The federated member list, in MANIFEST order: members on THIS
    host are in-process device-pinned lanes (the combined role), the
    rest are :class:`~.fleet.RemoteMember` handles over their sidecar
    addresses.  Every host building from an agreeing manifest produces
    the same order, so ring arcs, bulk pinning (order[0]) and drain
    victims agree fleet-wide.

    The FIRST local member wraps the base service stack (its renderer
    may be the lockstep ``MeshRenderer``, ``lockstep = True``: it spans its
    mesh and is never pinned narrower).  The CUDA devices are partitioned
    only when the app renders on CUDA; on the CPU every member takes the
    app's device."""
    import torch

    from .fleet import RemoteMember, build_local_members

    local_specs = manifest.local_members(self_host)
    if not local_specs:
        raise ValueError(
            f"federation.host {self_host!r} owns no manifest member — "
            f"a combined process must serve at least one")
    for spec in manifest.remote_members(self_host):
        if not spec.address:
            raise ValueError(
                f"federation member {spec.name!r} on host "
                f"{spec.host!r} has no address — this host "
                f"({self_host!r}) cannot reach it")
    if getattr(base_services.renderer, "lockstep", False) \
            and manifest.members[0].host != self_host:
        # The lockstep MeshRenderer lives HERE, but bulk/mesh work
        # pins to the fleet's first member (manifest order[0]) — on
        # another host.  Legal (that host serves bulk), but almost
        # certainly a mis-ordered manifest: the mesh host should come
        # first so full-plane jobs run on the mesh.
        logger.warning(
            "this host (%s) runs the lockstep mesh renderer but "
            "manifest member 0 (%s) lives on host %s — bulk/mesh "
            "work will pin there; list the mesh host's members first",
            self_host, manifest.members[0].name,
            manifest.members[0].host)
    base_device = getattr(base_services.renderer, "device", "cpu")
    on_cuda = torch.device(base_device).type == "cuda"
    device_sets = partition_local_devices(
        len(local_specs), None if on_cuda else [])
    locals_built = build_local_members(
        config, base_services, len(local_specs),
        device_sets=device_sets)
    by_name = {}
    for spec, built in zip(local_specs, locals_built):
        built.name = spec.name
        by_name[spec.name] = built
    members = []
    for spec in manifest.members:
        if spec.name in by_name:
            members.append(by_name[spec.name])
        else:
            client = client_factory(spec.address)
            # Stamp the destination HOST on the wire client: the
            # link-partition hook (utils.faultinject.partitioned)
            # keys on (self_host, peer_host), and un-stamped clients
            # — the front-door/proxy path — never match a rule.
            try:
                client.peer_host = spec.host
            except AttributeError:
                pass               # duck-typed drill clients
            members.append(RemoteMember(
                spec.name, client,
                down_cooldown_s=config.fleet.down_cooldown_s))
    return members


# ---------------------------------------------------------- coordinator

class FederationCoordinator:
    """The join and gossip loop of one process's federated router.

    ``agree()`` runs once at startup (and on demand): exchanges
    manifests with every remote member, verifies golden probe-key
    owners against each peer's own ring math, adopts newer epochs, and
    raises :class:`FederationError` on split-brain.  ``run()`` is the
    gossip tick loop — cross-host drain/death propagation plus
    manifest-drift detection."""

    def __init__(self, manifest: FleetManifest, self_host: str,
                 router=None, gossip_interval_s: float = 5.0,
                 handles: Optional[List] = None):
        self.manifest = manifest
        self.self_host = self_host
        self.router = router
        # Router-less gossipers (sidecar member processes): explicit
        # remote handles instead — every host must gossip ACTIVELY or
        # two non-routing hosts would never prove their link to each
        # other and a partition of the one router would fence them.
        self.handles = list(handles) if handles is not None else None
        self.gossip_interval_s = max(0.2, float(gossip_interval_s))
        # Deterministic per-host tick jitter (seeded: reproducible
        # schedules, like every chaos knob): +/-20% keeps an N-host
        # fleet's gossip bursts from synchronizing into a thundering
        # herd on one member.
        import random
        self._jitter_rng = random.Random(
            f"{self_host}:{manifest.ring_seed}:gossip-jitter")
        # name -> verdict of the last agreement exchange.
        self.agreement: Dict[str, str] = {}
        self.last_gossip: Dict[str, str] = {}

    def _remote_handles(self) -> List:
        if self.router is None:
            return list(self.handles) if self.handles else []
        return [self.router.members[n] for n in self.router.order
                if getattr(self.router.members[n], "remote", False)]

    def next_interval_s(self) -> float:
        """The next gossip sleep: the configured interval jittered
        uniformly within +/-20% (seeded per host, so tests can pin
        the schedule)."""
        return self.gossip_interval_s \
            * (0.8 + 0.4 * self._jitter_rng.random())

    def _refresh_manifest(self) -> None:
        """Adopt the process-global ACTIVE manifest when an epoch
        commit landed wire-side (handle_epoch_commit / a peer's
        anti-entropy push) and outran this coordinator's copy.
        Activation already swapped the ring at commit time, so the
        identity this coordinator gossips/agrees with must follow —
        otherwise a healed host keeps advertising the pre-roll digest
        forever and every round logs phantom drift."""
        active = current()
        if active is not None \
                and active.version > self.manifest.version:
            self.manifest = active

    async def agree(self, strict: bool = True) -> Dict[str, str]:
        """One agreement round with every remote member.  Returns the
        per-member verdict map; ``strict`` raises on split-brain only
        — every rolling-rollout verdict is tolerated and LOUD:

        * ``agreed`` — digest match, probe owners verified against
          the peer's own ring math;
        * ``pending`` — the peer is on an OLDER epoch and recorded
          ours as pending (its operator rolls it; a mid-roll fleet
          serves with both maps, each process honest about its own);
        * ``stale`` — WE are on the older epoch: the peer's newer
          manifest is recorded pending here, /readyz and
          /admin/federation say so until this process is rolled;
        * ``unreachable`` / ``legacy`` — tolerated (a dead or
          un-federated host must not block the survivors' boot);
        * ``split-brain`` — same epoch, different membership (or a
          peer whose ring math disagrees with its own digest): a
          refused join under ``strict``."""
        from ..utils import telemetry
        self._refresh_manifest()
        doc = self.manifest.to_json()
        my_owners = self.manifest.owners(list(PROBE_KEYS))
        verdicts: Dict[str, str] = {}
        for member in self._remote_handles():
            host = self.manifest.host_of(member.name)
            t_send = time.perf_counter()
            resp = await member.manifest_hello(
                doc, probe_keys=list(PROBE_KEYS))
            t_recv = time.perf_counter()
            telemetry.record_span(
                "fed.hop", t_send, (t_recv - t_send) * 1000.0,
                host=host, member=member.name, kind="hello")
            if isinstance(resp, dict):
                # Per-host clock anchor from the send/recv midpoint —
                # the sidecar hello idiom.  A peer without the field
                # (older build) simply derives no offset: its spans
                # stay unanchored, nothing errors.
                record_host_clock(resp.get("host") or host,
                                  t_send, t_recv, resp.get("clock"))
                observe_host(resp.get("host") or host)
            if resp is None:
                verdicts[member.name] = "unreachable"
                telemetry.FEDERATION.count_agreement("unreachable")
                continue
            if not resp.get("enabled"):
                verdicts[member.name] = "legacy"
                telemetry.FEDERATION.count_agreement("legacy")
                continue
            if resp.get("agreed"):
                # Digest agreement is necessary; the probe owners are
                # the sufficiency check — the peer's OWN ring hashed
                # every probe key to the member we did.
                owners = resp.get("owners")
                if owners is not None and owners != my_owners:
                    verdicts[member.name] = "split-brain"
                    telemetry.FEDERATION.count_agreement("split-brain")
                    continue
                verdicts[member.name] = "agreed"
                telemetry.FEDERATION.count_agreement("agreed")
                continue
            reason = resp.get("reason")
            if reason == "pending":
                # The peer (older epoch) recorded OUR manifest as its
                # pending epoch — a rollout in flight, its side.
                verdicts[member.name] = "pending"
                telemetry.FEDERATION.count_agreement("pending")
                continue
            if reason == "stale-epoch" \
                    and isinstance(resp.get("manifest"), dict):
                # WE are the older epoch: record the newer manifest
                # pending and keep serving the map this router was
                # BUILT with — activating mid-flight would diverge
                # what we advertise from what we route.
                try:
                    newer = FleetManifest.from_json(resp["manifest"])
                except (KeyError, TypeError, ValueError):
                    verdicts[member.name] = "split-brain"
                    telemetry.FEDERATION.count_agreement("split-brain")
                    continue
                if newer.version > self.manifest.version:
                    set_pending(newer)
                    verdicts[member.name] = "stale"
                    telemetry.FEDERATION.count_agreement("stale")
                    continue
                verdicts[member.name] = "split-brain"
                telemetry.FEDERATION.count_agreement("split-brain")
            else:
                verdicts[member.name] = "split-brain"
                telemetry.FEDERATION.count_agreement("split-brain")
        from ..utils import decisions
        for name, verdict in verdicts.items():
            decisions.record("manifest", verdict, member=name, detail={
                "host": self.manifest.host_of(name),
                "epoch": self.manifest.version})
        self.agreement = verdicts
        split = [n for n, v in verdicts.items() if v == "split-brain"]
        if split and strict:
            raise FederationError(
                f"federation manifest split-brain with {split}: same "
                f"shard epoch, different membership — refusing to "
                f"serve a forked shard map (bump federation.shard-"
                f"epoch with the corrected member list)")
        return verdicts

    async def gossip_once(self) -> Dict[str, str]:
        """One gossip round: push our local-member view to every
        remote member, merge their answers, and reflect what their
        hosts report about THEIR members onto our router handles —
        a drain ordered on host B walks routing off B's members here
        within one interval, before any request fails over."""
        from ..utils import telemetry
        self._refresh_manifest()
        view = local_view(self.router, self.self_host)
        merge_view(view)
        outcome: Dict[str, str] = {}
        my_digest = self.manifest.digest()
        # Our own host's window buckets join the fleet aggregate the
        # same way every peer's do — one ingest path, no special case.
        telemetry.FED_SLO.ingest(self.self_host,
                                 telemetry.SLO.export_buckets())
        telemetry.SENTINEL.ingest(self.self_host,
                                  telemetry.SENTINEL.export())
        for member in self._remote_handles():
            host = self.manifest.host_of(member.name)
            t_send = time.perf_counter()
            resp = await member.member_gossip(view)
            t_recv = time.perf_counter()
            telemetry.record_span(
                "fed.hop", t_send, (t_recv - t_send) * 1000.0,
                host=host, member=member.name, kind="gossip")
            if isinstance(resp, dict):
                # Re-derive the per-host clock anchor every round:
                # reconnects and drift heal within one interval.
                record_host_clock(resp.get("host") or host,
                                  t_send, t_recv, resp.get("clock"))
                observe_host(resp.get("host") or host)
                telemetry.FED_SLO.ingest(resp.get("host") or host,
                                         resp.get("slo"))
                telemetry.SENTINEL.ingest(resp.get("host") or host,
                                          resp.get("sentinel"))
            if resp is None or not resp.get("enabled", True):
                outcome[member.name] = "unreachable"
                telemetry.FEDERATION.count_gossip("unreachable")
                continue
            their_version = resp.get("version")
            if isinstance(their_version, int) \
                    and their_version < self.manifest.version \
                    and not is_fenced():
                # Anti-entropy catch-up: the peer runs an OLDER epoch
                # than the one this quorate host committed (it healed
                # from a partition, or rebooted between roll phases).
                # Re-push the commit — idempotent on the receiver —
                # so the fleet converges without operator action.
                await self._catchup(member, host)
            their_digest = resp.get("digest")
            pend = pending()
            if their_digest not in (None, my_digest):
                if pend is not None \
                        and their_digest == pend.digest():
                    # Known rollout in flight: the peer already runs
                    # the epoch we hold PENDING — not drift, just the
                    # roll this process is still waiting for.
                    pass
                else:
                    outcome[member.name] = "mismatch"
                    telemetry.FEDERATION.count_gossip("mismatch")
                    logger.warning(
                        "federation manifest drift detected gossiping "
                        "with %s (their digest %s != ours %s)",
                        member.name, their_digest, my_digest)
                    continue
            merged = merge_view(resp.get("view") or {})
            self._apply_remote_view(merged)
            outcome[member.name] = "ok"
            telemetry.FEDERATION.count_gossip("ok")
        from ..utils import decisions
        for name, verdict in outcome.items():
            if self.last_gossip.get(name) != verdict:
                # Convergence TRANSITIONS only (the flight-ring
                # posture): a steady fleet gossips every few seconds
                # and must not churn the ledger ring with "still ok".
                decisions.record("gossip", verdict, member=name,
                                 detail={
                                     "host": self.manifest.host_of(
                                         name)})
        self.last_gossip = outcome
        q = quorum_tracker()
        if q is not None:
            # The round's reachability verdict — fences and restores
            # transition HERE (and lazily at any gated action), within
            # one gossip interval of the link change.
            q.evaluate()
        return outcome

    async def _catchup(self, member, host: str) -> None:
        """Push our committed epoch to a stale peer (anti-entropy;
        best-effort — the next round retries)."""
        commit_fn = getattr(member, "epoch_commit", None)
        if commit_fn is None:
            return                   # duck-typed drill stubs
        try:
            resp = await commit_fn(self.manifest.to_json(),
                                    digest=self.manifest.digest())
        except Exception:
            return
        if isinstance(resp, dict) and resp.get("ack"):
            logger.info("anti-entropy: pushed epoch %d to %s (%s)",
                        self.manifest.version, member.name,
                        resp.get("reason"))

    async def roll_epoch(self, new_manifest: FleetManifest) -> dict:
        """Coordinator-driven two-phase epoch roll.

        Phase 1 (``epoch_propose``): offer the new manifest to one
        member per remote HOST; each validating host records it
        PENDING and acks.  A strict majority of manifest hosts (self
        counts) must ack, or the roll aborts with nothing activated
        anywhere — a minority can never advance the epoch.

        Phase 2 (``epoch_commit``): push the full manifest to every
        remote host (idempotent receivers), then activate locally (the
        registered roll hook swaps the live ring — the ONLY mid-flight
        ring change the router ever performs).  A coordinator that
        dies between phases leaves peers holding a pending manifest:
        re-running the same roll re-proposes idempotently, and a
        SUPERSEDING roll (higher version) simply outversions it.
        Hosts the commit missed converge through the gossip loop's
        anti-entropy push.

        Returns ``{"committed": bool, "acks": int, "hosts": int,
        "verdicts": {host: reason}}``."""
        from ..utils import decisions, telemetry
        if new_manifest.version <= self.manifest.version:
            raise ValueError(
                f"epoch roll must raise the version (active "
                f"{self.manifest.version}, proposed "
                f"{new_manifest.version})")
        if not quorum_allow("roll"):
            decisions.record("epoch", "failed", detail={
                "epoch": new_manifest.version, "reason": "fenced"})
            return {"committed": False, "acks": 0,
                    "hosts": 0, "verdicts": {},
                    "reason": "fenced"}
        doc = new_manifest.to_json()
        digest = new_manifest.digest()
        hosts = {m.host for m in self.manifest.members}
        # One propose per remote HOST (the manifest is process-global
        # on the receiver; a host's members share one process there).
        by_host: Dict[str, object] = {}
        for member in self._remote_handles():
            host = self.manifest.host_of(member.name)
            if host and host != self.self_host:
                by_host.setdefault(host, member)
        telemetry.FLIGHT.record("epoch.propose", epoch=doc["version"],
                                digest=digest[:12], by=self.self_host)
        decisions.record("epoch", "pending", detail={
            "pending_epoch": new_manifest.version,
            "pending_digest": digest, "roll": True,
            "phase": "propose"})
        verdicts: Dict[str, str] = {}
        acks = 1                      # self: the coordinator agrees
        for host, member in by_host.items():
            propose_fn = getattr(member, "epoch_propose", None)
            if propose_fn is None:
                verdicts[host] = "legacy"
                continue
            try:
                resp = await propose_fn(doc)
            except Exception:
                resp = None
            if not isinstance(resp, dict):
                verdicts[host] = "unreachable"
                continue
            observe_host(resp.get("host") or host)
            verdicts[host] = str(resp.get("reason") or (
                "ack" if resp.get("ack") else "refused"))
            if resp.get("ack"):
                acks += 1
        if acks * 2 <= len(hosts):
            decisions.record("epoch", "failed", detail={
                "epoch": new_manifest.version, "acks": acks,
                "hosts": len(hosts), "verdicts": verdicts})
            logger.warning(
                "epoch roll %d aborted: %d/%d host acks is not a "
                "strict majority (%s)", new_manifest.version, acks,
                len(hosts), verdicts)
            return {"committed": False, "acks": acks,
                    "hosts": len(hosts), "verdicts": verdicts}
        for host, member in by_host.items():
            commit_fn = getattr(member, "epoch_commit", None)
            if commit_fn is None:
                continue
            try:
                resp = await commit_fn(doc, digest=digest)
            except Exception:
                resp = None
            if isinstance(resp, dict):
                verdicts[host] = str(resp.get("reason")
                                     or verdicts.get(host, "?"))
        activate_manifest(new_manifest)
        self.manifest = new_manifest
        telemetry.FLIGHT.record("epoch.commit", epoch=doc["version"],
                                digest=digest[:12], by=self.self_host)
        decisions.record("epoch", "done", detail={
            "epoch": new_manifest.version, "acks": acks,
            "hosts": len(hosts), "verdicts": verdicts})
        logger.info("epoch roll %d committed (%d/%d host acks)",
                    new_manifest.version, acks, len(hosts))
        return {"committed": True, "acks": acks,
                "hosts": len(hosts), "verdicts": verdicts}

    def _apply_remote_view(self, merged: Dict[str, dict]) -> None:
        """Reflect peers' authoritative observations of THEIR OWN
        members onto our remote handles: drain state propagates both
        ways (set and cleared) UNDER the ``gossip`` intent only —
        drains THIS process ordered (operator ``/admin/drain``, an
        autoscaler scale-down holding the member in ``_scaled_down``)
        are this router's own decisions and must never be reverted by
        a peer that simply was not told about them.  Down-ness only
        marks (re-admission stays with the served-call/cooldown
        machinery — gossip must not revive a member its own host no
        longer vouches for)."""
        if self.router is None:
            return
        local = {m.name for m in
                 self.manifest.local_members(self.self_host)}
        for name, obs in merged.items():
            if name in local or name not in self.router.members:
                continue
            member = self.router.members[name]
            intent = getattr(member, "drain_intent", None)
            if member.draining and intent not in (None, "gossip"):
                # Our own drain (operator/autoscale): gossip is not
                # allowed to undo it — host B reporting "b1 not
                # draining" just means B was never told.
                continue
            draining = bool(obs.get("draining"))
            if member.draining != draining:
                member.draining = draining
                member.drain_intent = "gossip" if draining else None
                from ..utils import telemetry
                telemetry.FLIGHT.record("federation.gossip-drain",
                                        member=name,
                                        draining=draining)
            if not obs.get("healthy", True) and member.healthy:
                member.mark_down()

    def status(self) -> dict:
        """The /admin/federation + /readyz annotation document."""
        doc = {
            "host": self.self_host,
            "epoch": self.manifest.version,
            "digest": self.manifest.digest(),
            "members": [m.to_json() for m in self.manifest.members],
            "agreement": dict(self.agreement),
            "gossip": dict(self.last_gossip),
            "view": dict(_GOSSIP_VIEW),
            "clocks": host_clocks(),
        }
        pend = pending()
        if pend is not None and pend.version > self.manifest.version:
            # The operator's roll signal: a newer epoch exists in the
            # fleet and activates here on the next process restart
            # (or the next orchestrated roll's commit).
            doc["pending_epoch"] = pend.version
            doc["pending_digest"] = pend.digest()
        q = quorum_status()
        if q is not None:
            doc["quorum"] = q
        return doc

    def summary(self) -> str:
        agreed = sum(1 for v in self.agreement.values()
                     if v == "agreed")
        line = (f"epoch {self.manifest.version}, "
                f"{agreed}/{max(1, len(self.agreement))} peers agreed")
        pend = pending()
        if pend is not None and pend.version > self.manifest.version:
            line += f" (epoch {pend.version} pending roll)"
        q = quorum_status()
        if q is not None:
            line += (" — FENCED minority partition (own-shard reads "
                     "only)" if q["fenced"]
                     else f" — quorate "
                          f"{len(q['reachable'])}/{len(q['hosts'])}")
        return line

    async def run(self) -> None:
        """Gossip tick loop (the governor idiom; the app's robustness
        startup hook owns the task).  Each sleep is jittered +/-20%
        (seeded) so N hosts sharing an interval never synchronize
        their gossip bursts into a thundering herd on one member."""
        while True:
            await asyncio.sleep(self.next_interval_s())
            try:
                await self.gossip_once()
            except Exception:
                logger.warning("federation gossip round failed",
                               exc_info=True)
