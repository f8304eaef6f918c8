"""The port's config loader and CLI against the JAX package's.

``conf/config.example.yaml`` loads in the port; the settings the port
serves get the values the JAX ``AppConfig.from_dict`` gives them (the
OMERO deployment's keys too: ``session-store`` type, uri and required,
``metadata-service``, ``omero.data.dir``, ``raw-cache.prefetch`` and
``sessions``, ``loadmodel``, ``autoscaler`` and ``federation``); a
switched-off ``federation`` or ``autoscaler`` section has its values
checked with the JAX loader's messages, and a federation switched on its
manifest checks; an unported setting away from its JAX default, or an
unknown key in a served section, is refused with its name; without
``asyncpg`` and ``redis`` both apps degrade alike, with the same warning
or the same ``ValueError``; and
``python -m omero_ms_image_region_tpu_torch.server --config FILE`` parses
its flags over the file and serves, with the file's HTTP parse limits.
"""

import dataclasses
import os
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu_torch.server import config as port_config
from omero_ms_image_region_tpu_torch.server.__main__ import parse_args
from omero_ms_image_region_tpu_torch.server.config import AppConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "conf", "config.example.yaml")
CUSTOM = {
    "port": 9191, "worker_pool_size": 3, "data-dir": "/srv/images",
    "max-initial-line-length": 2048, "max-header-size": 4096,
    "max-headers": 64, "cache-control-header": "private, max-age=60",
    "logging": {"level": "DEBUG", "backup-count": 2},
    "omero.server": {"omero.pixeldata.max_tile_length": "1024",
                     "omero.script_repo_root": "/luts"},
    "omero.web": {"session_cookie_name": "sid"},
    "session-store": {"type": "static", "required": True},
    "batcher": {"max-batch": 4, "linger-ms": 5, "pipeline-depth": 2,
                "device-lanes": 1},
    "single-flight": {"enabled": False},
    "raw-cache": {"max-bytes": 1 << 30, "digest-dedup": False},
    "renderer": {"cpu-fallback-max-px": 0, "jpeg-engine": "sparse",
                 "prewarm": ["4x1024", "3x512@90:uint8"]},
    "telemetry": {"access-log": False, "ready-max-queue-depth": 8,
                  "provenance-header": True},
    "http-cache": {"epoch": "release-7", "max-age-s": 30,
                   "vary-acl": False},
    "watchdog": {"interval-s": 0.5, "stall-factor": 4,
                 "stall-min-s": 3, "escalate-after": 3},
    "fault-tolerance": {"request-deadline-ms": 2500,
                        "admission-max-queue": 16,
                        "shed-retry-after-s": 2},
    "fault-injection": {"seed": 3, "freeze-rate": 0.5, "freeze-ms": 10,
                        "freeze-max": 2, "device-error-rate": 0.1},
}
OMERO = {
    "omero.server": {"omero.data.dir": "/OMERO"},
    "session-store": {"type": "postgres", "required": True,
                      "uri": "postgresql://omero@db/omero"},
    "metadata-service": {"type": "postgres",
                         "dsn": "postgresql://omero@db/omero"},
    "raw-cache": {"prefetch": False, "digest-dedup": False},
    "sessions": {"enabled": True, "bucket-refill-per-s": 2,
                 "bucket-burst": 3, "max-tracked": 64,
                 "prefetch-lookahead": 3},
}


def _served(port, jax, path="") -> list:
    """(setting, port value, JAX value) for every field of the port's
    config, the JAX config's field of the same name beside it."""
    out = []
    for f in dataclasses.fields(port):
        if f.name == "unserved":
            continue
        mine, theirs = getattr(port, f.name), getattr(jax, f.name)
        if dataclasses.is_dataclass(mine):
            out += _served(mine, theirs, f"{path}{f.name}.")
        else:
            out.append((path + f.name, mine, theirs))
    return out


@pytest.mark.parametrize("source", ["example", "custom", "omero"])
def test_served_settings_match_jax(source):
    if source == "example":
        port, jax = AppConfig.from_yaml(EXAMPLE), JaxConfig.from_yaml(EXAMPLE)
        # The example switches on the three byte caches, which the port
        # serves: nothing is left unserved, and the cache settings (among
        # all the others below) equal the JAX loader's.
        assert port.unserved == ()
        assert (dataclasses.asdict(port.caches)
                == dataclasses.asdict(jax.caches))
        assert (port.caches.image_region and port.caches.pixels_metadata
                and port.caches.shape_mask)
    else:
        raw = CUSTOM if source == "custom" else OMERO
        port, jax = AppConfig.from_dict(raw), JaxConfig.from_dict(raw)
        assert port.unserved == ()
    for name, mine, theirs in _served(port, jax):
        assert mine == theirs, name


def test_defaults_match_jax_but_the_digest_dedup():
    diffs = [(n, m, t) for n, m, t in _served(AppConfig.from_dict({}),
                                               JaxConfig.from_dict({}))
             if m != t]
    assert diffs == [("raw_cache.digest_dedup", False, True)]


def test_unported_defaults_are_the_jax_defaults():
    """The last section the port once refused, the federation, is served
    with JAX's defaults, field for field."""
    jax = JaxConfig()
    port = AppConfig()
    assert (dataclasses.asdict(port.federation)
            == dataclasses.asdict(jax.federation))
    assert not hasattr(port_config, "_UNPORTED")
    assert jax.caches.redis_uri is None
    assert jax.metadata_backend == "local"


@pytest.mark.parametrize("raw, name", [
    ({"federation": {"gossip-interval-s": 2.0, "seeds": ["hostB"]}},
     "federation.seeds"),
    # Served sections refuse a key they do not know (the JAX loader
    # ignores it).
    ({"sessions": {"enabled": True, "enabled-for": "all"}},
     "sessions.enabled"),
    ({"sidecar": {"role": "split", "socket": "/tmp/s", "workers": 2}},
     "sidecar.workers"),
    ({"renderer": {"kernel": "pallas"}}, "renderer.kernel"),
    ({"fault-tolerance": {"degraded-mode": True, "cpu-threads": 4}},
     "fault-tolerance.cpu-threads"),
    ({"fault-injection": {"seed": 1, "partition-rate": 0.5}},
     "fault-injection.partition-rate"),
    ({"session-store": {"type": "redis", "uri": "redis://h", "db": 2}},
     "session-store."),
    ({"metadata-service": {"type": "postgres", "dsn": "postgres://h",
                           "pool-size": 8}},
     "metadata-service."),
    ({"parallel": {"chan-parallel": 2, "pod-timeout-s": 5}},
     "parallel.pod-timeout-s"),
    ({"wire": {"ring-bytes": 0, "compression": "lz4"}}, "wire.compression"),
    ({"workloads": {"unknown-key": 1}}, "workloads.unknown-key"),
])
def test_an_unported_setting_is_refused_by_name(raw, name):
    JaxConfig.from_dict(raw)                 # a valid JAX config
    with pytest.raises(ValueError, match="^" + name.replace(".", r"\.")):
        AppConfig.from_dict(raw)


@pytest.mark.parametrize("raw, refused", [
    # The direct renderer's bitpack engine (K6), and, as in JAX, its
    # refusal with the batcher on.
    ({"renderer": {"jpeg-engine": "bitpack"}, "batcher": {"enabled": False}},
     None),
    ({"renderer": {"jpeg-engine": "bitpack"}},
     "renderer.jpeg-engine 'bitpack' is only supported by the direct "
     "(unbatched) renderer"),
    # Queue-pressure growth and the backlog split.
    ({"batcher": {"target-inflight": 2}}, None),
    ({"batcher": {"max-batch": 4, "max-batch-limit": 32,
                  "target-inflight": 3}}, None),
    ({"batcher": {"target-inflight": 0}},
     "batcher.target-inflight must be >= 1"),
    # The qos bulk cost (interactive-weight is stored for the fleet).
    ({"qos": {"enabled": True}}, None),
    ({"qos": {"enabled": True, "bulk-cost": 2.5, "interactive-weight": 8}},
     None),
    ({"qos": {"bulk-cost": 0.5}}, "qos.bulk-cost must be >= 1"),
    # The fleet, its hot-plane replication, its drains and the peer byte
    # fetch.
    ({"fleet": {"enabled": True, "members": 2}}, None),
    ({"fleet": {"enabled": True, "members": 3, "lane-width": 1,
                "steal-min-backlog": 0, "hash-replicas": 16,
                "failover": False, "down-cooldown-s": 0.5}}, None),
    ({"fleet": {"enabled": True, "sockets": ["/tmp/a.sock", "h:9"]},
      "sidecar": {"role": "frontend"}}, None),
    ({"fleet": {"enabled": True, "members": 1}},
     "fleet.enabled requires members >= 2 or a fleet.sockets list"),
    ({"fleet": {"lane-width": 0}}, "fleet.lane-width must be >= 1"),
    ({"hotkey": {"threshold": 6.0}}, None),
    ({"hotkey": {"enabled": True, "max-replicas": 3, "decay-s": 5,
                 "top-k": 8, "demote-fraction": 0.25}}, None),
    ({"hotkey": {"max-replicas": 1}}, "hotkey.max-replicas must be >= 2"),
    ({"hotkey": {"demote-fraction": 1.0}},
     "hotkey.demote-fraction must be in (0, 1)"),
    ({"drain": {"fail-readyz": True}}, None),
    ({"drain": {"prestage": False, "prestage-max-planes": 8,
                "settle-timeout-s": 2}}, None),
    ({"drain": {"settle-timeout-s": 0}},
     "drain.settle-timeout-s must be > 0"),
    ({"http-cache": {"peer-fetch": False, "peer-timeout-ms": 50}}, None),
    ({"http-cache": {"peer-timeout-ms": 0}},
     "http-cache.peer-timeout-ms must be > 0"),
    ({"sidecar": {"role": "frontend"}},
     "sidecar.role 'frontend' requires sidecar.socket (or an enabled "
     "fleet.sockets list)"),
    # The load model and the autoscaler, with the JAX loader's
    # cross-section errors.
    ({"autoscaler": {"interval-s": 4.0}}, None),
    ({"loadmodel": {"viewers": 10}}, None),
    ({"loadmodel": {"seed": 7, "skew": 1.5, "image-population": 40,
                    "bulk-fraction": 0.1, "diurnal-amplitude": 0.0}}, None),
    ({"fleet": {"enabled": True, "members": 3},
      "autoscaler": {"enabled": True, "floor": 2, "ceiling": 3,
                     "cooldown-s": 3, "hold-ticks": 1,
                     "lane-capacity-tps": 10}}, None),
    ({"fleet": {"enabled": True, "sockets": ["/tmp/a.sock", "/tmp/b.sock"]},
      "sidecar": {"role": "frontend"},
      "autoscaler": {"enabled": True, "unit-config": "/etc/sc.yaml"}}, None),
    ({"autoscaler": {"enabled": True}},
     "autoscaler.enabled requires a fleet topology"),
    ({"fleet": {"enabled": True, "members": 2},
      "autoscaler": {"enabled": True, "floor": 3}},
     "autoscaler.floor (3) exceeds the provisioned fleet size (2 members)"),
    ({"autoscaler": {"queue-low-per-lane": 3.0}},
     "autoscaler.queue-low-per-lane must be in [0, queue-high-per-lane)"),
    ({"loadmodel": {"bulk-fraction": 0.6, "mask-fraction": 0.6}},
     "loadmodel bulk-fraction + mask-fraction + pyramid-fraction + "
     "animation-fraction must sum to <= 1"),
])
def test_a_lifted_setting_loads_as_in_jax(raw, refused):
    """Each setting this port once refused loads in both loaders with the
    same fields, or fails both with the JAX loader's message."""
    if refused is not None:
        for loader in (JaxConfig, AppConfig):
            with pytest.raises(ValueError, match="^" + re.escape(refused)):
                loader.from_dict(raw)
        return
    port, jax = AppConfig.from_dict(raw), JaxConfig.from_dict(raw)
    for name, mine, theirs in _served(port, jax):
        # The one default that differs on purpose (see the test above).
        if name != "raw_cache.digest_dedup":
            assert mine == theirs, name
    assert port.unserved == ()


@pytest.mark.parametrize("raw", [
    {"fleet": {"enabled": False, "members": 4}},     # switched off: inert
    {"wire": {"streaming": False}},                  # a feature off
    {"sentinel": {"enabled": False}},
    {"raw-cache": {"prefetch": False}},
    {"pyramid": {"enabled": False, "chunk": 512}},
])
def test_switching_off_a_missing_feature_loads(raw):
    JaxConfig.from_dict(raw)
    AppConfig.from_dict(raw)


@pytest.mark.parametrize("raw, error", [
    ({"federation": {"enabled": False, "quorum": True}},
     "federation.quorum requires federation.enabled (quorum is a verdict "
     "over manifest hosts)"),
    ({"federation": {"enabled": False, "hash-replicas": 0}},
     "federation.hash-replicas must be >= 1"),
    ({"autoscaler": {"enabled": False, "floor": 0}},
     "autoscaler.floor must be >= 1 (the fleet must always keep a "
     "servable member)"),
    ({"autoscaler": {"enabled": False, "unit-config": "x"}},
     "autoscaler.unit-config manages sidecar unit processes — it requires "
     "the fleet.sockets topology"),
    # The federation switched on: JAX's manifest checks, in its order.
    ({"federation": {"enabled": True, "host": "hA",
                     "members": [{"name": "a0", "host": "hA"}]}},
     "federation.enabled requires >= 2 members (one host needs no "
     "federation — use fleet.members)"),
    ({"federation": {"enabled": True, "host": "hA",
                     "members": [{"name": "a0", "host": "hA"},
                                 {"name": "a0", "host": "hB"}]}},
     "federation.members names must be unique fleet-wide"),
    ({"federation": {"enabled": True, "host": "hZ",
                     "members": [{"name": "a0", "host": "hA"},
                                 {"name": "b0", "host": "hB"}]}},
     "federation.host 'hZ' owns no manifest member (hosts: ['hA', 'hB']); "
     "set federation.host explicitly, or name manifest hosts by "
     "cluster.host_identity() — the default when the key is omitted"),
    ({"fleet": {"enabled": True, "sockets": ["/tmp/s0"]},
      "federation": {"enabled": True, "host": "hA",
                     "members": [{"name": "a0", "host": "hA"},
                                 {"name": "b0", "host": "hB"}]}},
     "federation.enabled and fleet.sockets are mutually exclusive — the "
     "manifest IS the membership; list remote members with addresses in "
     "federation.members instead"),
    ({"federation": {"enabled": True, "host": "hA",
                     "members": [{"name": "a0", "host": "hA"},
                                 {"name": "b0"}]}},
     "federation.members[1] must be a mapping with at least name and host"),
    ({"autoscaler": {"enabled": True, "floor": 3},
      "federation": {"enabled": True, "host": "hA",
                     "members": [{"name": "a0", "host": "hA"},
                                 {"name": "b0", "host": "hB"}]}},
     "autoscaler.floor (3) exceeds the provisioned fleet size (2 "
     "members)"),
])
def test_a_switched_off_section_is_checked_as_in_jax(raw, error):
    """A section switched off still has its values checked, with the JAX
    loader's message, in both loaders."""
    for loader in (JaxConfig, AppConfig):
        with pytest.raises(ValueError) as e:
            loader.from_dict(raw)
        assert str(e.value) == error


def _example_leaves():
    import yaml

    with open(EXAMPLE) as f:
        example = yaml.safe_load(f)
    return example, [(section, key) for section in
                     ("federation", "autoscaler", "loadmodel")
                     for key in example[section]]


@pytest.mark.parametrize("section, key", _example_leaves()[1],
                         ids=lambda v: v)
def test_each_leaf_of_the_elastic_sections_loads_as_in_jax(section, key):
    """``conf/config.example.yaml`` with one leaf of ``federation``,
    ``autoscaler`` or ``loadmodel`` changed (a flipped boolean, or 0, -1,
    0.5 and a bogus string), the sections as the example has them
    (``federation`` and ``autoscaler`` switched off): the port loads what
    JAX loads, ``federation.enabled: true`` among it, and refuses the rest
    with JAX's exception and message."""
    import copy

    example = _example_leaves()[0]
    value = example[section][key]
    for changed in ([not value] if isinstance(value, bool)
                    else [0, -1, 0.5, "bogus"]):
        raw = copy.deepcopy(example)
        raw[section][key] = changed
        outcomes = []
        for loader in (JaxConfig, AppConfig):
            try:
                loaded = loader.from_dict(raw)
                outcomes.append(("loaded", dataclasses.asdict(
                    getattr(loaded, section))))
            except Exception as e:
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[1] == outcomes[0], (key, changed)


@pytest.mark.parametrize("raw, outcome", [
    # A store that cannot be built refuses the start when sessions are
    # required (the default for redis and postgres) ...
    ({"session-store": {"type": "redis", "uri": "redis://h"}},
     "session enforcement is on but the redis package is unavailable"),
    ({"session-store": {"type": "postgres", "uri": "postgresql://h"}},
     "session enforcement is on but no async postgres driver "
     "(asyncpg/psycopg) is available"),
    ({"session-store": {"type": "postgres"}},
     "session enforcement is on but session-store.type is 'postgres' "
     "with no uri"),
    ({"session-store": {"type": "memcached"}},
     "invalid session-store.type 'memcached'"),
    ({"session-store": {"required": True}},
     "session-store.required is true but no session-store.type"),
    # ... and serves without sessions, with a warning, when they are not.
    ({"session-store": {"type": "redis", "uri": "redis://h",
                        "required": False}},
     "the redis package is unavailable; sessions disabled"),
    ({"session-store": {"type": "postgres", "uri": "postgresql://h",
                        "required": False}},
     "no async postgres driver (asyncpg/psycopg) is available; sessions "
     "disabled"),
])
def test_missing_drivers_degrade_as_in_jax(raw, outcome, caplog,
                                            monkeypatch):
    """Without ``redis``, ``asyncpg`` and ``psycopg`` (each hidden from
    import) both apps' session-store factories refuse or warn alike."""
    import logging

    from omero_ms_image_region_tpu.server import app as jax_app
    from omero_ms_image_region_tpu_torch.server import app as port_app

    for module in ("redis", "redis.asyncio", "asyncpg", "psycopg"):
        monkeypatch.setitem(sys.modules, module, None)
    results = []
    for make, config in ((jax_app._make_session_store,
                          JaxConfig.from_dict(raw)),
                         (port_app.make_session_store,
                          AppConfig.from_dict(raw))):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            try:
                store = make(config)
                results.append(("warned", store,
                                [r.getMessage() for r in caplog.records]))
            except ValueError as e:
                results.append(("refused", str(e)))
    assert results[0] == results[1]
    if results[0][0] == "refused":
        assert results[0][1].startswith(outcome)
    else:
        assert results[0][1] is None and results[0][2] == [outcome]


def test_postgres_metadata_without_asyncpg_keeps_the_local_service(
        tmp_path, caplog, monkeypatch):
    """``metadata-service.type: postgres`` without ``asyncpg``: both apps
    start, warn alike and serve from the local metadata service."""
    import asyncio
    import logging

    from aiohttp.test_utils import TestServer

    from omero_ms_image_region_tpu.server.app import create_app as jax_app
    from omero_ms_image_region_tpu_torch.server.app import (
        build_services, create_app)
    from omero_ms_image_region_tpu_torch.server.handler import (
        ImageRegionHandler)
    from omero_ms_image_region_tpu_torch.services.metadata import (
        LocalMetadataService)

    monkeypatch.setitem(sys.modules, "asyncpg", None)
    raw = {"data-dir": str(tmp_path),
           "metadata-service": {"type": "postgres",
                                "dsn": "postgresql://h/omero"}}
    handler = ImageRegionHandler(build_services(AppConfig.from_dict(raw),
                                                "cpu"))
    port_app = create_app(AppConfig.from_dict(raw), "cpu", handler=handler)

    async def start(app):
        server = TestServer(app)
        await server.start_server()
        await server.close()

    warnings = []
    for app in (jax_app(JaxConfig.from_dict(raw)), port_app):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            asyncio.run(start(app))
        warnings.append([r.getMessage() for r in caplog.records
                         if "metadata-service" in r.getMessage()])
    assert warnings[0] == warnings[1] == [
        "metadata-service.type is 'postgres' but asyncpg is unavailable; "
        "using the local backend"]
    assert isinstance(handler.s.metadata, LocalMetadataService)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_from_a_config_file_with_flag_overrides(tmp_path):
    data = tmp_path / "data"
    planes = np.random.default_rng(2).integers(
        0, 60000, size=(1, 1, 32, 32)).astype(np.uint16)
    build_pyramid(planes, str(data / "3"), chunk=(32, 32), n_levels=1)
    conf = tmp_path / "config.yaml"
    conf.write_text("port: 1\ndata-dir: /nowhere\n"
                    "max-initial-line-length: 300\n"
                    "http-cache:\n    epoch: r2\n"
                    "fault-tolerance:\n    request-deadline-ms: 100\n")
    port = _free_port()
    argv = ["--config", str(conf), "--port", str(port), "--data-dir",
            str(data), "--device", "cpu", "--request-deadline-ms", "0"]
    config, device = parse_args(argv)
    assert (config.port, config.data_dir, device) == (port, str(data),
                                                      "cpu")
    assert config.http.max_initial_line_length == 300
    assert config.fault_tolerance.request_deadline_ms == 0
    assert config.http_cache.epoch == "r2"

    proc = subprocess.Popen(
        [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
         *argv], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(300):
            try:
                urllib.request.urlopen(base + "/healthz", timeout=1)
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                time.sleep(0.1)
        r = urllib.request.urlopen(
            base + "/webgateway/render_image/3/0/0?format=png", timeout=30)
        assert r.status == 200 and r.headers["ETag"].startswith('"ir1-r2-')
        # The request-line bound reached aiohttp: a longer line is a 400.
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                base + "/webgateway/render_image/3/0/0?q=" + "9" * 400,
                timeout=30)
        assert ei.value.code == 400
    finally:
        proc.terminate()
        proc.wait(timeout=30)
