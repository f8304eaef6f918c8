"""The port's frontend/sidecar split and chunked responses against the JAX
package's, on the CPU.

* both default apps answer a render GET as an HTTP chunked response with
  the same body (and an ``http.firstByte`` span in the port), and with one
  ``Content-Length`` body under ``wire.streaming: false``;
* a port frontend over a port sidecar (``run_sidecar`` in the same event
  loop, on a unix socket) serves the JAX combined app's bytes, streamed or
  not; its ``/readyz`` pings the sidecar, its ``/metrics`` carries the
  breaker's gauges and the sidecar's series (``process="sidecar"``), its
  ``/debug/flightrecorder`` the sidecar's ring;
* with no sidecar: 503 with ``Retry-After`` (as the JAX frontend answers),
  the breaker opens and ``/readyz`` says ``unreachable``;
* ``fault-tolerance.degraded-mode``: the port frontend's degraded bytes
  are the JAX frontend's (linear family, exact), with the same headers and
  provenance tier (``degraded``); a ``p=`` GET answers 503 with
  ``Retry-After``; ``/readyz`` stays 200 (``degraded-mode: active``);
* ``SidecarSupervisor`` spawns a stand-in child again when it dies;
* ``--role split`` (one subprocess): the frontend serves, its supervised
  sidecar child is killed and comes back, the frontend serves again;
* the config loads the moved ``sidecar``, ``wire``, ``fault-tolerance``,
  ``fault-injection`` and ``watchdog`` keys as the JAX loader does and
  refuses the values it refuses.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.utils import telemetry as jax_telemetry
from omero_ms_image_region_tpu_torch.server import sidecar
from omero_ms_image_region_tpu_torch.server.app import create_app
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.utils import telemetry

REPO = Path(__file__).resolve().parent.parent
IMG = 4
BASE = f"/webgateway/render_image_region/{IMG}/0/0"
LINEAR = {"c": "1|100:50000$FF0000,2|0:60000$00FF00", "m": "c"}
QUERIES = [dict(LINEAR, tile="0,0,0,64,64", format="png"),
           dict(LINEAR, region="16,8,80,72", format="jpeg")]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sidecar")
    planes = np.random.default_rng(17).integers(
        0, 60000, size=(2, 1, 96, 128)).astype(np.uint16)
    build_pyramid(planes, str(root / str(IMG)), chunk=(32, 32), n_levels=1)
    return str(root)


def _raw(data_dir, **sections) -> dict:
    return dict({"data-dir": data_dir, "watchdog": {"enabled": False},
                 "sentinel": {"enabled": False},
                 "raw-cache": {"prefetch": False},
                 "telemetry": {"provenance-header": True}}, **sections)


async def _gets(app, queries, path=BASE):
    async with TestClient(TestServer(app)) as client:
        out = []
        for q in queries:
            r = await client.get(path, params=q)
            out.append((r.status, r.headers.copy(), await r.read()))
        return out


def _jax_bytes(data_dir, queries, **sections):
    return asyncio.run(_gets(jax_app(JaxConfig.from_dict(
        _raw(data_dir, **sections))), queries))


@pytest.mark.parametrize("streaming", [True, False])
def test_render_gets_chunked_in_both_default_apps(data_dir, streaming):
    sections = {"wire": {"streaming": streaming}}
    telemetry.reset()
    port = asyncio.run(_gets(create_app(AppConfig.from_dict(
        _raw(data_dir, **sections)), "cpu"), QUERIES))
    jax = _jax_bytes(data_dir, QUERIES, **sections)
    for (status, headers, body), (j_status, j_headers, j_body) in zip(
            port, jax):
        assert status == j_status == 200
        assert body == j_body and len(body) > 100
        chunked = headers.get("Transfer-Encoding") == "chunked"
        assert chunked == streaming
        assert ("Content-Length" in headers) == (not streaming)
        assert j_headers.get("Transfer-Encoding") == headers.get(
            "Transfer-Encoding")
        assert headers["ETag"] == j_headers["ETag"]
    first_byte = [t for t in telemetry.TRACES.recent()
                  if t.span_ms("http.firstByte") is not None]
    assert len(first_byte) == (len(QUERIES) if streaming else 0)


async def _port_sidecar(config, sock):
    task = asyncio.create_task(sidecar.run_sidecar(config, sock,
                                                   device="cpu"))
    for _ in range(400):
        if task.done():
            raise AssertionError(f"sidecar died: {task.exception()!r}")
        if os.path.exists(sock):
            return task
        await asyncio.sleep(0.05)
    raise AssertionError("the sidecar socket never appeared")


async def _stop(task):
    task.cancel()
    try:
        await task
    except (asyncio.CancelledError, Exception):
        pass


@pytest.mark.parametrize("streaming", [True, False])
def test_port_frontend_over_port_sidecar_serves_jax_bytes(
        data_dir, tmp_path, streaming):
    sock = str(tmp_path / "s.sock")
    sections = {"wire": {"streaming": streaming}}
    front_raw = _raw(data_dir, sidecar={"role": "frontend", "socket": sock},
                     **sections)

    async def scenario():
        side = await _port_sidecar(AppConfig.from_dict(
            _raw(data_dir, **sections)), sock)
        try:
            app = create_app(AppConfig.from_dict(front_raw), "cpu")
            async with TestClient(TestServer(app)) as client:
                out = []
                for q in QUERIES:
                    r = await client.get(BASE, params=q)
                    out.append((r.status, r.headers.copy(), await r.read()))
                ready = await client.get("/readyz")
                ready = (ready.status, await ready.json())
                metrics = await (await client.get("/metrics")).text()
                flight = await (await client.get(
                    "/debug/flightrecorder")).json()
                head = await client.head(BASE, params=QUERIES[0])
                return out, ready, metrics, flight, head.status
        finally:
            await _stop(side)

    out, ready, metrics, flight, head = asyncio.run(scenario())
    jax = _jax_bytes(data_dir, QUERIES, **sections)
    for (status, headers, body), (_, j_headers, j_body) in zip(out, jax):
        assert status == 200 and body == j_body
        assert headers["ETag"] == j_headers["ETag"]
        assert (headers.get("Transfer-Encoding") == "chunked") == streaming
    assert ready == (200, {"status": "ready", "checks": {
        "sidecar": "ok", "prewarm": "complete", "queue": "ok"}})
    assert "imageregion_breaker_state 0" in metrics
    assert 'imageregion_rawcache_misses{process="sidecar"}' in metrics
    assert flight["sidecar"] is not None and "events" in flight["sidecar"]
    assert head == 200


def test_dead_sidecar_is_503_and_opens_the_breaker(data_dir, tmp_path):
    sock = str(tmp_path / "never.sock")
    raw = _raw(data_dir, sidecar={"role": "frontend", "socket": sock},
               **{"fault-tolerance": {"retry-max-attempts": 1,
                                      "breaker-failure-threshold": 2,
                                      "breaker-reset-s": 60}})

    async def scenario(app):
        async with TestClient(TestServer(app)) as client:
            out = []
            for _ in range(3):
                r = await client.get(BASE, params=QUERIES[0])
                out.append((r.status, r.headers.get("Retry-After"),
                            await r.text()))
            ready = await client.get("/readyz")
            metrics = await (await client.get("/metrics")).text()
            return out, ready.status, await ready.json(), metrics

    out, ready, doc, metrics = asyncio.run(scenario(create_app(
        AppConfig.from_dict(raw), "cpu")))
    j_out, j_ready, j_doc, _ = asyncio.run(scenario(jax_app(
        JaxConfig.from_dict(raw))))
    assert [(s, ra) for s, ra, _ in out] == [(s, ra) for s, ra, _ in j_out]
    assert [s for s, _, _ in out] == [503, 503, 503]
    assert "circuit breaker open" in out[2][2]
    assert ready == j_ready == 503
    assert doc["checks"] == j_doc["checks"] == {"breaker": "open",
                                                "sidecar": "unreachable"}
    assert "imageregion_breaker_state 2" in metrics
    assert "imageregion_breaker_opens_total 1" in metrics
    assert "# sidecar metrics unavailable" in metrics


def test_degraded_mode_serves_the_jax_degraded_bytes(data_dir, tmp_path):
    sock = str(tmp_path / "never.sock")
    raw = _raw(data_dir, sidecar={"role": "frontend", "socket": sock},
               **{"fault-tolerance": {"retry-max-attempts": 1,
                                      "degraded-mode": True}})
    queries = QUERIES + [dict(LINEAR, tile="0,1,1,32,32", format="png",
                              flip="h")]
    proj = dict(LINEAR, p="intmax|0:0", format="png")

    async def scenario(app):
        async with TestClient(TestServer(app)) as client:
            out = []
            for q in queries:
                r = await client.get(BASE, params=q)
                out.append((r.status, r.headers.copy(), await r.read()))
            rp = await client.get(BASE, params=proj)
            ready = await client.get("/readyz")
            return (out, (rp.status, rp.headers.get("Retry-After")),
                    ready.status, (await ready.json())["checks"])

    telemetry.reset()
    jax_telemetry.reset()
    out, p_status, ready, checks = asyncio.run(scenario(create_app(
        AppConfig.from_dict(raw), "cpu")))
    j_out, j_p_status, j_ready, j_checks = asyncio.run(scenario(jax_app(
        JaxConfig.from_dict(raw))))
    keys = ("ETag", "Cache-Control", "Vary", "Last-Modified",
            "Content-Type", "Transfer-Encoding")
    for (status, headers, body), (j_status, j_headers, j_body) in zip(
            out, j_out):
        assert status == j_status == 200
        assert body == j_body
        assert {k: headers.get(k) for k in keys} == \
            {k: j_headers.get(k) for k in keys}
    # Each fallback is counted, the refused projection's too, as in JAX.
    assert telemetry.RESILIENCE.degraded_renders == len(queries) + 1 \
        == jax_telemetry.RESILIENCE.degraded_renders
    assert p_status == j_p_status and p_status[0] == 503 \
        and int(p_status[1]) >= 1
    assert ready == j_ready == 200
    assert checks == j_checks
    assert checks["degraded-mode"] == "active"
    # The provenance records name the degraded tier (the access line's
    # ``prov`` and the counters), in both packages.
    assert telemetry.PROVENANCE.totals() == {"degraded": len(queries)} \
        == jax_telemetry.PROVENANCE.totals()


class _FakeProc:
    """A ``Popen`` stand-in whose ``wait`` returns once it is killed."""

    def __init__(self):
        import threading
        self._dead = threading.Event()
        self.returncode = None

    def kill(self):
        self.returncode = -9
        self._dead.set()

    terminate = kill

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        if not self._dead.wait(timeout):
            raise subprocess.TimeoutExpired("fake", timeout)
        return self.returncode


def test_supervisor_spawns_a_dead_child_again():
    spawned = []

    def spawn():
        spawned.append(_FakeProc())
        return spawned[-1]

    telemetry.reset()
    sup = sidecar.SidecarSupervisor(spawn, base_backoff_s=0.01,
                                    max_backoff_s=0.05)
    first = sup.start()
    try:
        first.kill()
        deadline = time.monotonic() + 10
        while sup.restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sup.restarts == 1 and len(spawned) == 2
        assert sup.proc is spawned[1] and sup.proc.poll() is None
        assert telemetry.RESILIENCE.supervisor_restarts == 1
    finally:
        sup.stop(timeout_s=5)
    assert spawned[1].poll() is not None      # stop terminates the child


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str, timeout: float = 30.0):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_split_role_restarts_its_sidecar(data_dir, tmp_path):
    """``--role split`` on the CPU: a 200 through the spawned sidecar; the
    child killed, the supervisor spawns it again and the next GET is a
    200 with the same bytes."""
    import urllib.parse

    sock, port = str(tmp_path / "split.sock"), _free_port()
    conf = tmp_path / "split.yaml"
    conf.write_text(json.dumps({
        "watchdog": {"enabled": False}, "sentinel": {"enabled": False},
        "raw-cache": {"prefetch": False},
        "fault-tolerance": {"supervisor-max-backoff-s": 1}}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
         "--role", "split", "--sidecar-socket", sock, "--config", str(conf),
         "--data-dir", data_dir, "--port", str(port), "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    path = BASE + "?" + urllib.parse.urlencode(QUERIES[0])
    try:
        deadline = time.monotonic() + 60
        status = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status, first = _get(port, path)
                break
            except OSError:
                time.sleep(0.2)
        assert status == 200, proc.stderr.read() if proc.poll() else status
        child = subprocess.run(
            ["pgrep", "-f", "--", f"--sidecar-socket {sock}"],
            capture_output=True, text=True).stdout.split()
        child = [int(p) for p in child if int(p) != proc.pid]
        assert len(child) == 1
        os.kill(child[0], signal.SIGKILL)
        deadline = time.monotonic() + 60
        again = None
        while time.monotonic() < deadline:
            status, body = _get(port, path)
            if status == 200:
                again = body
                break
            time.sleep(0.2)
        assert again == first
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    leftover = subprocess.run(
        ["pgrep", "-f", "--", f"--sidecar-socket {sock}"],
        capture_output=True, text=True).stdout.split()
    assert leftover == []


MOVED = {
    "sidecar": {"role": "frontend", "socket": "127.0.0.1:8476"},
    "wire": {"coalesce-max-frames": 8, "coalesce-max-bytes": 65536,
             "ring-bytes": 0, "ring-min-body-bytes": 1024,
             "streaming": False, "chunk-max-bytes": 8192},
    "fault-tolerance": {"breaker-failure-threshold": 3,
                        "breaker-reset-s": 2.5, "retry-max-attempts": 4,
                        "retry-base-backoff-ms": 10.0,
                        "retry-max-backoff-ms": 200.0,
                        "degraded-mode": True, "supervise": False,
                        "supervisor-max-backoff-s": 5.0},
    "fault-injection": {"seed": 3, "wire-drop-rate": 0.1,
                        "wire-truncate-rate": 0.2, "wire-delay-rate": 0.3,
                        "wire-delay-ms": 4.0, "die-after-requests": 7},
    "watchdog": {"wire-hang-s": 12.0},
}


def test_config_loads_the_moved_keys_as_jax():
    port, jax = AppConfig.from_dict(MOVED), JaxConfig.from_dict(MOVED)
    for section in ("sidecar", "wire", "fault_tolerance",
                    "fault_injection", "watchdog"):
        assert vars(getattr(port, section)) == vars(getattr(jax, section)), \
            section


@pytest.mark.parametrize("raw", [
    {"sidecar": {"role": "proxy", "socket": "/tmp/s"}},
    {"sidecar": {"role": "frontend"}},
    {"wire": {"coalesce-max-frames": 0}},
    {"wire": {"coalesce-max-bytes": 100}},
    {"wire": {"ring-bytes": 4096}},
    {"wire": {"ring-min-body-bytes": 0}},
    {"wire": {"chunk-max-bytes": 1024}},
    {"fault-tolerance": {"breaker-failure-threshold": 0}},
    {"fault-tolerance": {"retry-max-attempts": 0}},
    {"fault-injection": {"seed": 1, "wire-drop-rate": 1.5}},
    {"fault-injection": {"seed": 1, "wire-delay-ms": -1}},
    {"fault-injection": {"seed": 1, "die-after-requests": -1}},
    {"watchdog": {"wire-hang-s": -1}},
])
def test_config_refuses_what_jax_refuses(raw):
    with pytest.raises(ValueError) as jax_err:
        JaxConfig.from_dict(raw)
    with pytest.raises(ValueError) as port_err:
        AppConfig.from_dict(raw)
    assert str(port_err.value).split(" ")[0] == \
        str(jax_err.value).split(" ")[0]
