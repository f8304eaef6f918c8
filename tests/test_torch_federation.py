"""The port's federation (``parallel.federation``) against the JAX package's.

Every comparison is exact: the federation has no floating-point output of
its own.  Each case runs the same seeded inputs through both packages on
the CPU:

* the manifest: canonical JSON and BLAKE2b digest byte for byte, and the
  owners of 1,000 route keys with a ring seed and without one;
* the wire handlers: ``manifest_hello`` (agreeing, a higher epoch, a lower
  one, a same-epoch fork, malformed, none installed), the coordinator's
  agreement verdicts and its ``FederationError``, ``member_gossip``'s
  versioned merge and ``local_view`` over a seeded run of views with stale
  incarnations, ``epoch_propose`` / ``epoch_commit`` (re-propose and
  re-commit idempotent) and a two-phase ``roll_epoch``;
* the ``QuorumTracker`` on one virtual clock: verdicts, ``allow`` for
  every action, status, transitions, refusals and their records;
* ``partition_local_devices`` for 1-5 members over 0-8 devices, and the
  link partitions (``faultinject.partitioned``);
* the fences: a JAX router and a port router fenced on one schedule make
  the same adoption, promotion, write-back and failover decisions;
* the wire: a JAX ``run_sidecar`` and a port one in the test's loop answer
  the five federation ops alike when driven by the JAX ``RemoteMember``,
  and the port's ``RemoteMember`` gets the same answers from the JAX one;
* a one-host federated app from ``create_app(config, "cpu")``: bodies,
  serving members, ``/admin/federation`` and the ``/readyz`` check equal
  to the JAX app's, apart from timing fields;
* the drill (JAX's ``TestMultihostSmoke`` shape): two port sidecar
  processes on hosts B and C and a federated front on host A agree (each
  process's own ring), survive C's death and drain A's member to B over
  ``shard_transfer``;
* a ``fleet.sockets`` frontend's merged ``/debug/flightrecorder`` and
  ``/debug/decisions`` over its members' rings.
"""

import asyncio
import importlib
import json
import os
import random
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.server.sidecar import (
    SidecarClient as JaxClient)
from omero_ms_image_region_tpu.server.sidecar import (
    run_sidecar as jax_run_sidecar)
from omero_ms_image_region_tpu_torch.server import sidecar
from omero_ms_image_region_tpu_torch.server.app import (build_front,
                                                        create_app)
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = {"jax": "omero_ms_image_region_tpu",
         "port": "omero_ms_image_region_tpu_torch"}


def _mods(pkg):
    """``pkg``'s federation, fleet, telemetry, decisions and faultinject."""
    base = NAMES[pkg]
    return types.SimpleNamespace(**{
        name: importlib.import_module(f"{base}.{path}")
        for name, path in (("fed", "parallel.federation"),
                           ("fleet", "parallel.fleet"),
                           ("tel", "utils.telemetry"),
                           ("dec", "utils.decisions"),
                           ("fi", "utils.faultinject"),
                           ("ctx", "server.ctx"))})


PKGS = {pkg: _mods(pkg) for pkg in NAMES}


def _reset():
    for m in PKGS.values():
        m.tel.reset()
        m.dec.LEDGER.reset()
        m.fed.uninstall()
        m.fed.reset_gossip()
        m.fi.PARTITIONS.clear()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fed"))
    rng = np.random.default_rng(7)
    planes = rng.integers(0, 60000, size=(2, 1, 256, 256)).astype(np.uint16)
    build_pyramid(planes, os.path.join(root, "1"), chunk=(64, 64),
                  n_levels=1)
    return root


def _specs(fed, hosts=("hostA", "hostB", "hostC"), per=2):
    return [fed.MemberSpec(f"{h[-1].lower()}{i}", h,
                           "" if h == hosts[0] else f"/tmp/{h}-{i}.sock")
            for h in hosts for i in range(per)]


def _manifest(pkg, version=1, seed="fed", replicas=64, **kw):
    fed = PKGS[pkg].fed
    return fed.FleetManifest(_specs(fed, **kw), version=version,
                             ring_seed=seed, replicas=replicas)


def _no_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def _flight(pkg, prefixes):
    return _no_ts(e for e in PKGS[pkg].tel.FLIGHT.snapshot()
                  if e["kind"].startswith(prefixes))


def _both(fn):
    """``fn(pkg)`` for both packages, each from a clean state."""
    out = {}
    for pkg in ("jax", "port"):
        _reset()
        out[pkg] = fn(pkg)
    return out


# ------------------------------------------------------------ the manifest

@pytest.mark.parametrize("seed, version, replicas", [
    ("", 1, 64), ("rack-7", 3, 16), ("ünï|code", 2, 64)])
def test_the_manifest_digest_and_owners_equal_jax(seed, version, replicas):
    mine = _manifest("port", version, seed, replicas)
    theirs = _manifest("jax", version, seed, replicas)
    assert mine.canonical_json() == theirs.canonical_json()
    assert mine.digest() == theirs.digest()
    assert mine.to_json() == theirs.to_json()
    assert (PKGS["port"].fed.FleetManifest.from_json(theirs.to_json())
            .digest() == theirs.digest())
    keys = [f"route-{i:04d}" for i in range(1000)]
    assert mine.owners(keys) == theirs.owners(keys)
    assert mine.ring().chain("route-0007") == theirs.ring().chain(
        "route-0007")
    assert PKGS["port"].fed.PROBE_KEYS == PKGS["jax"].fed.PROBE_KEYS
    assert ([m.to_json() for m in mine.remote_members("hostA")]
            == [m.to_json() for m in theirs.remote_members("hostA")])


def test_the_manifest_from_config_and_its_checks_equal_jax():
    raw = {"federation": {"enabled": True, "host": "hostA",
                          "shard-epoch": 4, "ring-seed": "cfg",
                          "hash-replicas": 32,
                          "members": [{"name": "a0", "host": "hostA"},
                                      {"name": "b0", "host": "hostB",
                                       "address": "10.0.0.2:8476"}]}}
    mine = PKGS["port"].fed.FleetManifest.from_config(
        AppConfig.from_dict(raw).federation)
    theirs = PKGS["jax"].fed.FleetManifest.from_config(
        JaxConfig.from_dict(raw).federation)
    assert mine.canonical_json() == theirs.canonical_json()
    errors = []
    for args in ([], [("a", "h"), ("a", "h")], [("a", "h")]):
        for pkg in ("jax", "port"):
            fed = PKGS[pkg].fed
            try:
                fed.FleetManifest([fed.MemberSpec(n, h) for n, h in args],
                                  version=0 if len(args) == 1 else 1)
            except ValueError as e:
                errors.append((pkg, str(e)))
    assert [e for p, e in errors if p == "port"] == [
        e for p, e in errors if p == "jax"]
    assert len(errors) == 6


# --------------------------------------------------------- manifest_hello

def _hello_run(pkg):
    m = PKGS[pkg]
    out = [m.fed.handle_manifest_hello({"manifest": {}})]
    m.fed.install(_manifest(pkg, version=2), self_host="hostB")
    probes = list(m.fed.PROBE_KEYS)
    cases = [_manifest(pkg, version=2).to_json(),            # agreeing
             _manifest(pkg, version=3, seed="next").to_json(),   # higher
             _manifest(pkg, version=1).to_json(),            # lower
             _manifest(pkg, version=2, per=1).to_json(),     # fork
             {"members": [{"name": "x"}]}]                   # malformed
    for doc in cases:
        answer = m.fed.handle_manifest_hello(
            {"manifest": doc, "from_host": "hostA", "probe_keys": probes})
        answer.pop("clock", None)
        out.append(answer)
    pend = m.fed.pending()
    out.append((pend.version, pend.digest()) if pend else None)
    out.append(m.fed.current().digest())
    out.append(_no_ts(m.dec.LEDGER.snapshot()))
    out.append(m.tel.FEDERATION.metric_lines())
    return out


def test_manifest_hello_answers_equal_jax():
    runs = _both(_hello_run)
    assert runs["port"] == runs["jax"]
    answers = runs["port"]
    assert answers[0] == {"enabled": False}
    assert [a.get("reason", "agreed") for a in answers[1:6]] == [
        "agreed", "pending", "stale-epoch", "split-brain", "malformed"]
    assert answers[1]["owners"] == _manifest("jax", 2).owners(
        list(PKGS["jax"].fed.PROBE_KEYS))


class _Peer:
    """A remote handle whose answers are scripted (no wire)."""

    remote = True

    def __init__(self, name, hello=None, gossip=None, propose=None,
                 commit=None):
        self.name = name
        self._answers = {"hello": hello, "gossip": gossip,
                         "propose": propose, "commit": commit}
        self.calls = []
        self.draining = False
        self.drain_intent = None
        self.healthy = True

    def _answer(self, op, *args):
        self.calls.append(op)
        answer = self._answers[op]
        return answer(*args) if callable(answer) else answer

    async def manifest_hello(self, doc, probe_keys=None):
        return self._answer("hello", doc, probe_keys)

    async def member_gossip(self, view):
        return self._answer("gossip", view)

    async def epoch_propose(self, doc):
        return self._answer("propose", doc)

    async def epoch_commit(self, doc, digest=""):
        return self._answer("commit", doc, digest)

    def mark_down(self):
        self.healthy = False


def _agree_run(pkg):
    m = PKGS[pkg]
    mine = _manifest(pkg, version=2)
    m.fed.install(mine, self_host="hostA")
    owners = mine.owners(list(m.fed.PROBE_KEYS))
    newer = _manifest(pkg, version=5, seed="new").to_json()
    peers = [
        _Peer("b0", {"enabled": True, "agreed": True, "owners": owners}),
        _Peer("b1", {"enabled": True, "agreed": False, "reason": "pending"}),
        _Peer("c0", {"enabled": True, "agreed": False,
                     "reason": "stale-epoch", "manifest": newer}),
        _Peer("c1", None),
        _Peer("d0", {"enabled": False}),
    ]
    coord = m.fed.FederationCoordinator(mine, "hostA", handles=peers)
    out = [asyncio.run(coord.agree(strict=True)), coord.summary(),
           m.fed.pending().digest()]
    forged = _Peer("b0", {"enabled": True, "agreed": True,
                          "owners": list(reversed(owners))})
    fork = _Peer("b1", {"enabled": True, "agreed": False,
                        "reason": "split-brain"})
    coord = m.fed.FederationCoordinator(mine, "hostA",
                                        handles=[forged, fork])
    try:
        asyncio.run(coord.agree(strict=True))
        out.append("joined")
    except m.fed.FederationError as e:
        out.append(("FederationError", str(e)))
    out.append(asyncio.run(coord.agree(strict=False)))
    out.append(_no_ts(m.dec.LEDGER.snapshot()))
    out.append(m.tel.FEDERATION.metric_lines())
    return out


def test_the_coordinator_agrees_and_refuses_a_fork_as_jax():
    runs = _both(_agree_run)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == {"b0": "agreed", "b1": "pending",
                               "c0": "stale", "c1": "unreachable",
                               "d0": "legacy"}
    assert runs["port"][3][0] == "FederationError"


# ------------------------------------------------------- gossip and views

class _Clock:
    """A module ``time`` on one virtual clock."""

    def __init__(self, t=1000.0):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _gossip_run(pkg, monkeypatch, seed):
    m = PKGS[pkg]
    clock = _Clock()
    monkeypatch.setattr(m.fed, "time", clock)
    m.fed.install(_manifest(pkg), self_host="hostA")
    monkeypatch.setattr(m.fed, "_INCARNATION", 5000)
    names = ["a0", "a1", "b0", "b1", "c0", "c1"]
    members = {n: types.SimpleNamespace(healthy=True, draining=False)
               for n in names}
    router = types.SimpleNamespace(order=names, members=members,
                                   hot_owned=lambda n: len(n) % 2)
    rng = random.Random(seed)
    out = []
    for _ in range(120):
        clock.t += rng.choice((0.0, 0.5, 3.0))
        move = rng.random()
        if move < 0.45:
            view = {}
            for _ in range(rng.randint(1, 4)):
                name = rng.choice(names + ["zz", "a0" * 40])
                kind = rng.random()
                if kind < 0.1:
                    view[name] = "not-a-dict"
                    continue
                obs = {"healthy": rng.random() < 0.7,
                       "draining": rng.random() < 0.2,
                       "ts": round(clock.t - rng.choice((0, 5, 50)), 1)}
                if kind > 0.3:        # versioned, some stale, some ahead
                    obs["inc"] = rng.choice((4999, 5000, 5001, 6000))
                    obs["seq"] = rng.randint(0, 6)
                if rng.random() < 0.2:
                    obs["hot"] = rng.choice((0, 3, "x"))
                view[name] = obs
            out.append(m.fed.merge_view(view))
        elif move < 0.75:
            name = rng.choice(names[:2])
            if rng.random() < 0.5:
                members[name].healthy = not members[name].healthy
            else:
                members[name].draining = not members[name].draining
            view = m.fed.local_view(router, "hostA")
            out.append((view, m.fed._INCARNATION, m.fed._LOCAL_SEQ))
            m.fed.merge_view(view)
        else:
            answer = m.fed.handle_member_gossip(
                {"view": m.fed.local_view(router, "hostA"),
                 "from_host": rng.choice(("hostB", "hostC", ""))})
            out.append(answer)
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_gossip_merge_and_local_view_equal_jax(monkeypatch, seed):
    runs = {}
    for pkg in ("jax", "port"):
        _reset()
        runs[pkg] = _gossip_run(pkg, monkeypatch, seed)
    assert runs["port"] == runs["jax"]
    assert any(isinstance(o, tuple) and o[1] > 5000 for o in runs["port"])


def _gossip_once_run(pkg):
    m = PKGS[pkg]
    mine = _manifest(pkg, version=2)
    m.fed.install(mine, self_host="hostA")
    pend = _manifest(pkg, version=3, seed="p")
    m.fed.set_pending(pend)
    names = [s.name for s in mine.members]
    members = {n: _Peer(n) for n in names}
    for n in ("a0", "a1"):
        members[n].remote = False
    members["b1"].draining, members["b1"].drain_intent = True, "operator"
    router = types.SimpleNamespace(order=names, members=members)
    peer_view = {"b0": {"healthy": True, "draining": True, "inc": 7,
                        "seq": 1, "ts": 1.0},
                 "b1": {"healthy": True, "draining": False, "inc": 7,
                        "seq": 1, "ts": 1.0},
                 "c0": {"healthy": False, "draining": False, "inc": 7,
                        "seq": 2, "ts": 1.0}}
    answers = {"b0": {"enabled": True, "version": 2,
                      "digest": mine.digest(), "view": peer_view},
               "b1": {"enabled": True, "version": 1,
                      "digest": _manifest(pkg, 1).digest(), "view": {}},
               "c0": {"enabled": True, "version": 3,
                      "digest": pend.digest(), "view": {}},
               "c1": None}
    for n, a in answers.items():
        members[n]._answers["gossip"] = a
        members[n]._answers["commit"] = {"ack": True, "reason": "installed"}
    coord = m.fed.FederationCoordinator(mine, "hostA", router=router)
    outcome = asyncio.run(coord.gossip_once())
    return [outcome, {n: (p.draining, p.drain_intent, p.healthy, p.calls)
                      for n, p in members.items()},
            _no_ts(m.dec.LEDGER.snapshot()),
            m.tel.FEDERATION.metric_lines(),
            _flight(pkg, ("federation.",))]


def test_a_gossip_round_reflects_peers_as_jax():
    runs = _both(_gossip_once_run)
    assert runs["port"] == runs["jax"]
    outcome, members = runs["port"][:2]
    assert outcome == {"b0": "ok", "b1": "mismatch", "c0": "ok",
                       "c1": "unreachable"}
    assert members["b0"][:2] == (True, "gossip")       # drain reflected
    assert members["b1"][:2] == (True, "operator")     # ours, kept
    assert members["c0"][2] is False                   # marked down
    assert "commit" in members["b1"][3]                # anti-entropy


# ---------------------------------------------------------------- quorum

def _quorum_run(pkg, seed):
    m = PKGS[pkg]
    clock = _Clock(0.0)
    manifest = _manifest(pkg, hosts=("hA", "hB", "hC", "hD", "hE"), per=1)
    tracker = m.fed.QuorumTracker(manifest, "hA", suspect_after_s=2.0,
                                  clock=clock.monotonic)
    m.fed.install_quorum(tracker)
    rng = random.Random(seed)
    out = []
    for step in range(150):
        move = rng.random()
        if move < 0.3:
            m.fed.observe_host(rng.choice(("hB", "hC", "hD", "hE", "hZ",
                                           "hA", "")))
        elif move < 0.55:
            clock.t += rng.choice((0.5, 1.0, 2.5))
        elif move < 0.85:
            action = rng.choice(m.fed.QuorumTracker.ACTIONS + ("other",))
            out.append((step, action, m.fed.quorum_allow(action),
                        m.fed.is_fenced()))
        elif move < 0.9:
            hosts = rng.choice((("hA", "hB", "hC"),
                                ("hA", "hB", "hC", "hD", "hE"), ("hA",)))
            tracker.set_manifest(_manifest(pkg, hosts=hosts, per=1))
        else:
            out.append((step, m.fed.quorum_status()))
    out.append(m.tel.QUORUM.metric_lines())
    out.append(_no_ts(m.dec.LEDGER.snapshot()))
    out.append(_flight(pkg, ("quorum.",)))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_the_quorum_tracker_fences_and_restores_as_jax(seed):
    runs = _both(lambda pkg: _quorum_run(pkg, seed))
    assert runs["port"] == runs["jax"]
    verdicts = {r[3] for r in runs["port"] if len(r) == 4}
    assert verdicts == {True, False}


# ----------------------------------------------------------- epoch rolls

def _epoch_run(pkg):
    m = PKGS[pkg]
    v1 = _manifest(pkg, version=1)
    m.fed.install(v1, self_host="hostB")
    rolled = []
    m.fed.set_roll_hook(lambda man: rolled.append(man.digest()))
    v2 = _manifest(pkg, version=2, seed="two")
    fork1 = _manifest(pkg, version=1, per=1)
    fork2 = _manifest(pkg, version=2, per=1)
    steps = [
        ("propose", {"manifest": v2.to_json(), "from_host": "hostA"}),
        ("propose", {"manifest": v2.to_json(), "from_host": "hostA"}),
        ("propose", {"manifest": v1.to_json()}),
        ("propose", {"manifest": fork1.to_json()}),
        ("propose", {"manifest": {"members": 3}}),
        ("commit", {"manifest": v2.to_json(), "digest": "0" * 32}),
        ("commit", {"manifest": v2.to_json(), "digest": v2.digest(),
                    "from_host": "hostA"}),
        ("commit", {"manifest": v2.to_json(), "digest": v2.digest()}),
        ("commit", {"manifest": v1.to_json()}),
        ("commit", {"manifest": fork2.to_json()}),
        ("propose", {"manifest": v2.to_json()}),
    ]
    out = []
    for op, header in steps:
        handle = (m.fed.handle_epoch_propose if op == "propose"
                  else m.fed.handle_epoch_commit)
        answer = handle(header)
        answer.pop("clock", None)
        pend = m.fed.pending()
        out.append((op, answer, m.fed.current().version,
                    pend.version if pend else None))
    # A fenced receiver refuses the propose.
    clock = _Clock(0.0)
    tracker = m.fed.QuorumTracker(m.fed.current(), "hostB",
                                  suspect_after_s=1.0, clock=clock.monotonic)
    clock.t = 5.0
    m.fed.install_quorum(tracker)
    answer = m.fed.handle_epoch_propose(
        {"manifest": _manifest(pkg, version=9).to_json()})
    answer.pop("clock", None)
    out.append(answer)
    out.append(rolled)
    out.append(_no_ts(m.dec.LEDGER.snapshot()))
    out.append(_flight(pkg, ("epoch.",)))
    return out


def test_epoch_propose_and_commit_answer_as_jax():
    runs = _both(_epoch_run)
    assert runs["port"] == runs["jax"]
    reasons = [step[1].get("reason") for step in runs["port"][:11]]
    assert reasons == ["pending", "pending", "already-active", "stale",
                       "malformed", "digest-mismatch", "installed",
                       "already-active", "stale", "split-brain",
                       "already-active"]
    assert runs["port"][11]["reason"] == "fenced"
    assert len(runs["port"][12]) == 1          # the hook ran once


def _roll_run(pkg):
    m = PKGS[pkg]
    mine = _manifest(pkg, version=1)
    m.fed.install(mine, self_host="hostA")
    rolled = []
    m.fed.set_roll_hook(lambda man: rolled.append(man.version))
    peers = [_Peer("b0", propose={"ack": True, "reason": "pending"},
                   commit={"ack": True, "reason": "installed"}),
             _Peer("b1"),
             _Peer("c0", propose=None)]
    coord = m.fed.FederationCoordinator(mine, "hostA", handles=peers)
    out = [asyncio.run(coord.roll_epoch(_manifest(pkg, 2, seed="r2")))]
    peers[0]._answers["propose"] = {"ack": False, "reason": "stale"}
    out.append(asyncio.run(coord.roll_epoch(_manifest(pkg, 3))))
    try:
        asyncio.run(coord.roll_epoch(_manifest(pkg, 2)))
    except ValueError as e:
        out.append(str(e))
    out += [rolled, coord.manifest.version, [p.calls for p in peers],
            _no_ts(m.dec.LEDGER.snapshot())]
    return out


def test_a_two_phase_roll_commits_on_a_majority_as_jax():
    runs = _both(_roll_run)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0]["committed"] is True
    assert runs["port"][1]["committed"] is False
    assert runs["port"][3] == [2]


# ------------------------------------------- devices and link partitions

def test_partition_local_devices_equal_jax():
    for n in range(1, 6):
        for d in range(0, 9):
            devices = [f"cuda:{i}" for i in range(d)]
            assert (PKGS["port"].fed.partition_local_devices(n, devices)
                    == PKGS["jax"].fed.partition_local_devices(n, devices))
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="partition needs >= 1 member"):
            PKGS[pkg].fed.partition_local_devices(0, [])
    import torch
    if not torch.cuda.is_available():
        # No card: every local member takes the app's device.
        assert PKGS["port"].fed.partition_local_devices(2) == [[], []]


def _partition_run(pkg):
    fi = PKGS[pkg].fi
    out = []
    for args in (("hA", "hB", "drop", False), ("hB", "hC", "deny", True),
                 ("hA", "hA", "drop", False), ("hA", "hB", "cut", False),
                 ("", "hB", "drop", False)):
        try:
            fi.PARTITIONS.add(args[0], args[1], mode=args[2],
                              bidirectional=args[3])
            out.append("added")
        except ValueError as e:
            out.append(str(e))
    hosts = ("hA", "hB", "hC", "")
    out.append([fi.partitioned(a, b) for a in hosts for b in hosts])
    fi.PARTITIONS.remove("hC", "hB", bidirectional=True)
    out.append(fi.PARTITIONS.snapshot())
    out.append(PKGS[pkg].tel.QUORUM.metric_lines())
    return out


def test_link_partitions_equal_jax():
    runs = _both(_partition_run)
    assert runs["port"] == runs["jax"]
    assert runs["port"][5].count("drop") == 1
    assert runs["port"][5].count("deny") == 2


# -------------------------------------------------------------- fences

class _Owner:
    """A fleet member stub: health, drain flags and a byte tier."""

    def __init__(self, name, remote):
        self.name = name
        self.remote = remote
        self.healthy = True
        self.draining = False
        self.drain_intent = None
        self.puts = []

    async def byte_put(self, key, value, tier="region"):
        self.puts.append((key, tier))
        return True

    async def shard_manifest(self, limit=0):
        return []

    async def prestage_manifest(self, entries):
        return 0


def _fence_run(pkg):
    m = PKGS[pkg]
    clock = _Clock(0.0)
    tracker = m.fed.QuorumTracker(_manifest(pkg), "hostA",
                                  suspect_after_s=2.0,
                                  clock=clock.monotonic)
    m.fed.install_quorum(tracker)
    members = [_Owner(n, remote=n != "m0") for n in ("m0", "m1", "m2")]
    hotkey = types.SimpleNamespace(enabled=True, threshold=3.0,
                                   decay_s=1e6, max_replicas=2, top_k=8,
                                   demote_fraction=0.5)
    router = m.fleet.FleetRouter(members, hotkey=hotkey)
    router._heat.clock = clock.monotonic
    params = {"imageId": "1", "theZ": "0", "theT": "0",
              "tile": "0,0,0,64,64", "m": "c", "format": "png"}
    ctx = m.ctx.ImageRegionCtx.from_params(params)
    route = m.fleet.plane_route_key(ctx)
    chain = router.ring.chain(route)
    out = []

    async def phase():
        loop = asyncio.get_running_loop()
        res = {"fenced": m.fed.is_fenced()}
        router.members[chain[0]].healthy = False
        res["walk"] = router._walk_chain(chain)
        router.members[chain[0]].healthy = True
        for _ in range(4):
            router._observe_heat(route)
        res["hot"] = router.is_hot_route(route)
        router.shed_replicas()
        work = m.fleet._Work(m.ctx.ImageRegionCtx.from_params(params),
                             loop.create_future(), "m1", None)
        router._byte_putback(work, b"bytes")
        work2 = m.fleet._Work(m.ctx.ImageRegionCtx.from_params(params),
                              loop.create_future(), "m0", None)
        router._route_failover(work2)
        res["failover"] = (str(work2.future.exception())
                           if work2.future.done() else work2.owner)
        router._route_failover(work2, reason="drain")
        res["drain_rehome"] = work2.owner
        await asyncio.sleep(0)
        res["puts"] = [len(x.puts) for x in members]
        await router.close()
        return res

    clock.t = 10.0                     # no other host heard: fenced
    out.append(asyncio.run(phase()))
    for host in ("hostB", "hostC"):
        m.fed.observe_host(host)       # heard again: restored
    router = m.fleet.FleetRouter(members, hotkey=hotkey)
    router._heat.clock = clock.monotonic
    out.append(asyncio.run(phase()))
    out.append(m.fed.quorum_status())
    out.append(m.tel.QUORUM.metric_lines())
    return out, chain


def test_fenced_routers_decide_as_jax():
    runs = _both(_fence_run)
    assert runs["port"] == runs["jax"]
    (fenced, restored, status, _), chain = runs["port"]
    assert fenced["fenced"] and not restored["fenced"]
    assert fenced["walk"] == chain[0] and restored["walk"] != chain[0]
    assert not fenced["hot"] and restored["hot"]
    assert fenced["failover"].startswith("fenced minority partition")
    assert fenced["puts"] == [0, 0, 0] and restored["puts"][1] == 1
    assert status["refusals"] == {"adoption": 2, "promotion": 2,
                                  "write_authority": 1}


# ------------------------------------------------------------- the wire

def _sidecar_raw(data_dir, host="hostB"):
    return {"data-dir": data_dir, "watchdog": {"enabled": False},
            "sentinel": {"enabled": False},
            "renderer": {"cpu-fallback-max-px": 0},
            "raw-cache": {"prefetch": False},
            "federation": {
                "enabled": True, "host": host, "quorum": True,
                "gossip-interval-s": 3600, "ring-seed": "wire",
                "members": [{"name": "a0", "host": "hostA",
                             "address": "/nonexistent/a0.sock"},
                            {"name": "b0", "host": "hostB",
                             "address": "/nonexistent/b0.sock"}]}}


async def _federation_ops(member, fed):
    """The five ops through ``member`` (a JAX or port ``RemoteMember``),
    as plain data with the clock anchors dropped."""
    v1 = _wire_manifest(fed, 1)
    v2 = _wire_manifest(fed, 2)
    out = []

    def keep(doc):
        if isinstance(doc, dict):
            doc = {k: v for k, v in doc.items() if k != "clock"}
        out.append(doc)

    keep(await member.manifest_hello(v1.to_json(),
                                     probe_keys=list(fed.PROBE_KEYS)))
    keep(await member.manifest_hello(v2.to_json()))
    keep(await member.member_gossip(
        {"a0": {"healthy": False, "draining": True, "inc": 9, "seq": 1,
                "ts": 5.0}}))
    keep(await member.epoch_propose(v2.to_json()))
    keep(await member.epoch_commit(v2.to_json(), digest="f" * 32))
    keep(await member.epoch_commit(v2.to_json(), digest=v2.digest()))
    keep(await member.epoch_commit(v2.to_json(), digest=v2.digest()))
    for extra in ({"action": "add", "src": "hostB", "dst": "hostA",
                   "mode": "deny", "bidirectional": True},
                  {"action": "show"}, {"action": "explode"},
                  {"action": "clear"}):
        status, body = await member.client.call("partition", {},
                                                extra=extra)
        keep((status, json.loads(bytes(body)) if status == 200 else None))
    keep(await member.manifest_hello(v2.to_json(),
                                     probe_keys=list(fed.PROBE_KEYS)))
    return out


def _wire_manifest(fed, version):
    return fed.FleetManifest(
        [fed.MemberSpec("a0", "hostA", "/nonexistent/a0.sock"),
         fed.MemberSpec("b0", "hostB", "/nonexistent/b0.sock")],
        version=version, ring_seed="wire" if version == 1 else "wire-2")


async def _serving(run, sock):
    holder: dict = {}
    task = asyncio.create_task(run(holder))
    for _ in range(600):
        if task.done():
            raise AssertionError(f"sidecar died: {task.exception()!r}")
        if os.path.exists(sock):
            return task
        await asyncio.sleep(0.05)
    raise AssertionError("sidecar never bound its socket")


def _drive(run, sock, client_pkg):
    async def go():
        task = await _serving(run, sock)
        m = PKGS[client_pkg]
        client = (JaxClient(sock) if client_pkg == "jax"
                  else sidecar.SidecarClient(sock))
        member = m.fleet.RemoteMember("b0", client)
        # The caller is host B's own process in both runs.
        m.fed._SELF_HOST = "hostB"
        try:
            return await _federation_ops(member, m.fed)
        finally:
            await client.close()
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
    return asyncio.run(go())


def test_the_wire_ops_answer_both_clients_as_jax(data_dir, tmp_path):
    raw = _sidecar_raw(data_dir)
    runs = {}
    for name, server, client_pkg in (("jax", "jax", "jax"),
                                     ("port", "port", "jax"),
                                     ("port_client", "jax", "port")):
        _reset()
        sock = str(tmp_path / f"{name}.sock")
        if server == "jax":
            run = (lambda h, s=sock: jax_run_sidecar(
                JaxConfig.from_dict(dict(raw)), s, services_out=h))
        else:
            run = (lambda h, s=sock: sidecar.run_sidecar(
                AppConfig.from_dict(dict(raw)), s, services_out=h,
                device="cpu"))
        runs[name] = _drive(run, sock, client_pkg)
    assert runs["port"] == runs["jax"]
    assert runs["port_client"] == runs["jax"]
    answers = runs["port"]
    assert answers[0]["agreed"] is True and answers[0]["host"] == "hostB"
    assert answers[1]["reason"] == "pending"
    assert answers[2]["view"]["a0"]["draining"] is True
    assert [a.get("reason") for a in answers[3:7]] == [
        "pending", "digest-mismatch", "installed", "already-active"]
    assert answers[7][1]["rules"] == [
        {"src": "hostA", "dst": "hostB", "mode": "deny"},
        {"src": "hostB", "dst": "hostA", "mode": "deny"}]
    assert answers[9][0] == 400 and answers[10][1]["rules"] == []
    assert answers[11]["agreed"] is True and answers[11]["version"] == 2


def test_a_partition_rule_fails_the_client_as_a_dead_wire():
    """A rule from this host to the client's peer host keeps the frame
    home (``ConnectionError`` before any connect); the ``partition`` op
    itself is exempt; an unstamped client is never partitioned."""
    async def go():
        m = PKGS["port"]
        m.fed._SELF_HOST = "hostA"
        m.fi.PARTITIONS.add("hostA", "hostB")
        client = sidecar.SidecarClient("/nonexistent/peer.sock",
                                       breaker=None, retry=None)
        client.peer_host = "hostB"
        out = []
        for op in ("member_gossip", "partition"):
            try:
                await client.call(op, {})
                out.append("sent")
            except ConnectionError as e:
                # The dead-wire error, caused by the partition.
                out.append(str(e.__cause__ or e))
        client.peer_host = ""
        try:
            await client.call("ping", {})
        except (ConnectionError, OSError) as e:
            out.append(type(e).__name__)
        await client.close()
        return out

    out = asyncio.run(go())
    assert out[0] == "link partitioned (drop): hostA -> hostB"
    assert "partitioned" not in out[1] and "partitioned" not in out[2]
    assert PKGS["port"].tel.QUORUM.metric_lines()[-1] == \
        'imageregion_partition_blocked_total{mode="drop"} 1'


# --------------------------------------------------------------- the app

def _app_raw(data_dir):
    return {"data-dir": data_dir,
            "renderer": {"cpu-fallback-max-px": 0},
            "raw-cache": {"prefetch": False},
            "telemetry": {"provenance-header": True},
            "sentinel": {"tick-interval-s": 3600},
            "federation": {
                "enabled": True, "host": "hostA", "quorum": True,
                "gossip-interval-s": 3600, "ring-seed": "app",
                "members": [{"name": "a0", "host": "hostA"},
                            {"name": "a1", "host": "hostA"}]}}


BASE = "/webgateway/render_image_region/1/0/0"
CH = "c=1|0:60000$FF0000,2|0:60000$00FF00&m=c"


def _member(headers) -> str:
    for part in headers.get("X-Image-Region-Provenance", "").split("; "):
        if part.startswith("member="):
            return part[len("member="):]
    return "-"


def _exchange(raw, requests):
    from aiohttp.test_utils import TestClient, TestServer

    async def run(app):
        out = []
        async with TestClient(TestServer(app)) as client:
            for url in requests:
                r = await client.get(url)
                out.append((r.status, r.headers.copy(), await r.read()))
        return out

    _reset()
    jax = asyncio.run(run(jax_app(JaxConfig.from_dict(dict(raw)))))
    assert PKGS["jax"].fed.current() is None       # uninstalled at cleanup
    _reset()
    port = asyncio.run(run(create_app(AppConfig.from_dict(dict(raw)),
                                      "cpu")))
    assert PKGS["port"].fed.current() is None
    return jax, port


def _timeless(doc):
    """``/admin/federation`` without its timing fields (the host clocks
    and the quorum's reachable-now list are live readings)."""
    doc = dict(doc)
    doc.pop("clocks", None)
    return doc


def test_a_one_host_federated_app_serves_and_reports_as_jax(data_dir):
    from urllib.parse import quote
    tiles = [f"{BASE}?tile=0,{x},{y},64,64&{CH}&format=png"
             for x in range(3) for y in range(2)]
    requests = tiles + ["/admin/federation", "/admin/federation?agree=1",
                        "/readyz",
                        "/debug/explain?path=" + quote(tiles[0], safe=""),
                        "/admin/drain"]
    jax, port = _exchange(_app_raw(data_dir), requests)
    assert [s for s, _, _ in port] == [s for s, _, _ in jax]
    n = len(tiles)
    for (js, jh, jb), (ps, ph, pb) in zip(jax[:n], port[:n]):
        assert ps == js == 200
        assert pb == jb
        assert _member(ph) == _member(jh)
    assert {_member(h) for _, h, _ in port[:n]} == {"a0", "a1"}
    for i in (n, n + 1):
        mine, theirs = json.loads(port[i][2]), json.loads(jax[i][2])
        assert _timeless(mine) == _timeless(theirs)
        assert mine["quorum"]["quorate"] is True
    mine, theirs = json.loads(port[n + 2][2]), json.loads(jax[n + 2][2])
    assert mine["checks"]["federation"] == theirs["checks"]["federation"]
    assert mine["checks"]["federation"].startswith("epoch 1, 0/1 peers")
    mine, theirs = json.loads(port[n + 3][2]), json.loads(jax[n + 3][2])
    assert mine["federation"] == theirs["federation"]


def test_a_federated_app_without_a_card_fails_loudly(data_dir):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        build_front(AppConfig.from_dict(_app_raw(data_dir)), "cuda")


# ------------------------------------------------------------- the drill

def _spawn(tmp_path, data_dir, host, sock, members):
    import yaml
    cfg = {"data-dir": data_dir, "batcher": {"enabled": False},
           "raw-cache": {"enabled": True, "prefetch": False},
           "renderer": {"cpu-fallback-max-px": 0},
           "sentinel": {"enabled": False}, "watchdog": {"enabled": False},
           "image-region-cache": {"enabled": True},
           "federation": {"enabled": True, "host": host,
                          "ring-seed": "drill", "gossip-interval-s": 3600,
                          "members": members}}
    path = str(tmp_path / f"{host}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
         "--role", "sidecar", "--sidecar-socket", sock, "--config", path,
         "--device", "cpu"], env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _wait_socket(proc, sock, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"sidecar exited {proc.returncode}"
        if os.path.exists(sock):
            return
        time.sleep(0.1)
    raise AssertionError(f"no socket {sock} in {timeout_s} s")


def test_two_sidecar_processes_agree_survive_a_death_and_drain(
        data_dir, tmp_path):
    socks = {h: str(tmp_path / f"{h}.sock") for h in ("hostB", "hostC")}
    members = [{"name": "a0", "host": "hostA"},
               {"name": "b0", "host": "hostB", "address": socks["hostB"]},
               {"name": "c0", "host": "hostC", "address": socks["hostC"]}]
    procs = {h: _spawn(tmp_path, data_dir, h, s, members)
             for h, s in socks.items()}
    try:
        for h, proc in procs.items():
            _wait_socket(proc, socks[h])
        raw = {"data-dir": data_dir, "batcher": {"enabled": False},
               "raw-cache": {"enabled": True, "prefetch": False},
               "renderer": {"cpu-fallback-max-px": 0},
               "sentinel": {"enabled": False},
               "telemetry": {"provenance-header": True},
               "fleet": {"down-cooldown-s": 30.0},
               "federation": {"enabled": True, "host": "hostA",
                              "ring-seed": "drill",
                              "gossip-interval-s": 3600,
                              "members": members}}
        asyncio.run(_drill(AppConfig.from_dict(raw), procs))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)


async def _drill(config, procs):
    m = PKGS["port"]
    front = build_front(config, "cpu")
    router, coord = front.router, front.federation
    handler = front.handler
    manifest = coord.manifest
    try:
        # 1. Agreement, each process's owners from its own ring.
        assert await coord.agree(strict=True) == {"b0": "agreed",
                                                  "c0": "agreed"}
        probes = list(m.fed.PROBE_KEYS)
        for name in ("b0", "c0"):
            answer = await router.members[name].manifest_hello(
                manifest.to_json(), probe_keys=probes)
            assert answer["owners"] == manifest.owners(probes)

        def ctx(x, y):
            return ImageRegionCtx.from_params({
                "imageId": "1", "theZ": "0", "theT": "0", "m": "c",
                "format": "png", "tile": f"0,{x},{y},32,32",
                "c": "1|0:60000$FF0000,2|0:60000$00FF00"})

        tiles = [(x, y) for x in range(4) for y in range(4)]
        bodies, owners = {}, {}
        for t in tiles:
            owners[t] = router.owner_of(ctx(*t))
            bodies[t] = await handler.render_image_region(ctx(*t))
        assert set(owners.values()) == {"a0", "b0", "c0"}

        # 2. Host C's process dies: its shard fails over, no error.
        procs["hostC"].kill()
        procs["hostC"].wait(timeout=10)
        for t in tiles:
            assert await handler.render_image_region(ctx(*t)) == bodies[t]
        assert not router.members["c0"].healthy
        assert m.tel.FLEET.totals()["failed_over"] >= 1

        # 3. Drain a0: its warm planes ship to b0 over shard_transfer.
        doc = await router.drain_member("a0", settle_timeout_s=10.0)
        assert doc["planes"] >= 1 and doc["prestaged"] >= 1
        assert m.tel.FEDERATION.shard_transfers == doc["prestaged"]
        for t in tiles:
            assert await handler.render_image_region(ctx(*t)) == bodies[t]
        router.undrain_member("a0")
    finally:
        await router.close()
        for client in front.clients():
            await client.close()
        front.close()


def test_a_frontend_fleet_merges_every_members_rings(data_dir, tmp_path):
    """A ``fleet.sockets`` frontend's ``/debug/flightrecorder`` and
    ``/debug/decisions`` hold every member's ring (``members``) and one
    merge by time (``ring``, ``ledger``), each event and record stamped
    with its member, this process's as ``frontend`` (JAX
    ``:1756-1863``)."""
    socks = [str(tmp_path / f"m{i}.sock") for i in range(2)]
    raw = _sidecar_raw(data_dir)
    raw.pop("federation")

    async def go():
        tasks = [await _serving(lambda h, s=s: sidecar.run_sidecar(
            AppConfig.from_dict(dict(raw)), s, services_out=h,
            device="cpu"), s) for s in socks]
        front = build_front(AppConfig.from_dict({
            "data-dir": data_dir, "sidecar": {"role": "frontend"},
            "sentinel": {"enabled": False},
            "fleet": {"enabled": True, "sockets": socks}}), "cpu")
        try:
            m = PKGS["port"]
            m.tel.FLIGHT.record("fleet.steal", by="m0", owner="m1")
            m.dec.record("drain", "done", member="m1", detail={})
            for i in range(2):
                await front.observed("render_image_region", "GET", {
                    "imageId": "1", "theZ": "0", "theT": "0", "m": "c",
                    "format": "png", "tile": f"0,{i},0,32,32",
                    "c": "1|0:60000$FF0000"}, {}, {})
            flight = front.flight_doc(
                members=await front.member_docs("flightrecorder"))
            ledger = front.decisions_doc(await front.member_docs(
                "decisions"))
            return flight, ledger
        finally:
            await front.router.close()
            for c in front.clients():
                await c.close()
            front.close()
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    flight, ledger = asyncio.run(go())
    assert sorted(flight["members"]) == ["m0", "m1"]
    assert flight["sidecar"] == flight["members"]["m0"]
    assert all("member" in e for e in flight["ring"])
    assert [e["ts"] for e in flight["ring"]] == sorted(
        e["ts"] for e in flight["ring"])
    assert len(flight["ring"]) == len(flight["events"]) + sum(
        len(r["events"]) for r in flight["members"].values())
    assert any(e["kind"] == "fleet.steal" and e["member"] == "frontend"
               for e in flight["ring"])
    assert sorted(ledger["members"]) == ["m0", "m1"]
    # The in-loop sidecars share this process's ledger: the record comes
    # back once from each member's ring, each keeping the member it names.
    assert [r["member"] for r in ledger["ledger"]
            if r["kind"] == "drain"] == ["m1"] * 3
    assert len(ledger["ledger"]) == len(ledger["records"]) + sum(
        len(r["ring"]) for r in ledger["members"].values())
