"""The port's ``parallel.cluster`` (joining ``torch.distributed``, one
process per GPU) and the ``--role pod-worker`` command.

* Standalone: ``initialize`` with no coordinator and no
  ``torch.distributed`` environment leaves the process alone (the (1, 1)
  mesh); ``host_identity`` is the host name; ``local_batch_slice`` covers
  the whole batch on a one-row mesh; a mesh wider than the world size is
  refused by name (``tests/test_cluster.py``'s cases in port form).
* The command: JAX's two argument errors of ``--role pod-worker``, and a
  pod of two processes over gloo on the CPU (a leader serving HTTP with
  ``parallel.chan-parallel: 2`` and a ``--role pod-worker``) whose JPEG
  equals the JAX package's mesh app's; the leader's SIGTERM announces
  the shutdown, which ends the worker.
"""

import asyncio
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu_torch.parallel import cluster
from omero_ms_image_region_tpu_torch.parallel import mesh as M
from omero_ms_image_region_tpu_torch.server.__main__ import _parse

from torch_workload_apps import CH, IMG, write_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 60.0


def test_initialize_standalone_is_noop(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    cluster.initialize(device="cpu")
    assert not cluster.joined()
    assert (cluster.world_size(), cluster.rank()) == (1, 0)
    assert cluster.host_identity() == socket.gethostname()


def test_global_mesh_spans_the_one_process():
    mesh = cluster.global_mesh(chan_parallel=1, device="cpu")
    assert mesh.size == 1 and set(mesh.axis_names) == {"data", "chan"}
    assert mesh.shape == {"data": 1, "chan": 1}
    assert mesh.ranks.tolist() == [[0]] and mesh.position == (0, 0)


def test_local_batch_slice_single_process_covers_all():
    mesh = cluster.global_mesh(device="cpu")
    assert cluster.local_batch_slice(mesh, 3) == slice(0, 3)
    grid = [[0], [1]]
    second_row = M.Mesh(grid, mesh.device, 1, collective=False)
    assert cluster.local_batch_slice(second_row, 6) == slice(3, 6)
    with pytest.raises(ValueError, match="not divisible by data"):
        cluster.local_batch_slice(second_row, 7)


def test_a_mesh_wider_than_the_world_is_refused():
    with pytest.raises(ValueError, match="only 1 device.*pod-worker"):
        cluster.global_mesh(n_devices=8, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        cluster.global_mesh(chan_parallel=2, device="cpu")


def test_an_explicit_coordinator_needs_its_rank():
    with pytest.raises(ValueError, match="num-processes and process-id"):
        cluster.initialize("127.0.0.1:1", num_processes=2, device="cpu")


@pytest.mark.parametrize("yaml, message", [
    ("parallel:\n    enabled: false\n",
     "--role pod-worker requires parallel.enabled"),
    ("parallel:\n    enabled: true\n    process-id: 0\n",
     "--role pod-worker must not be process-id 0"),
], ids=["parallel_off", "process_0"])
def test_pod_worker_argument_errors(tmp_path, capsys, yaml, message):
    conf = tmp_path / "c.yaml"
    conf.write_text(yaml)
    with pytest.raises(SystemExit):
        _parse(["--config", str(conf), "--role", "pod-worker"])
    assert message in capsys.readouterr().err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(root, http_port, store_port, process_id) -> str:
    return (f"port: {http_port}\ndata-dir: {root}\n"
            f"renderer:\n    cpu-fallback-max-px: 0\n"
            f"parallel:\n    enabled: true\n    chan-parallel: 2\n"
            f"    coordinator-address: 127.0.0.1:{store_port}\n"
            f"    num-processes: 2\n    process-id: {process_id}\n")


def _kill(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)


def test_a_pod_of_two_processes_serves_and_shuts_down(tmp_path):
    root = write_tree(str(tmp_path / "data"))
    http_port, store_port = _free_port(), _free_port()
    confs = []
    for rank in (0, 1):
        conf = tmp_path / f"pod{rank}.yaml"
        conf.write_text(_config(root, http_port, store_port, rank))
        confs.append(str(conf))
    cmd = [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
           "--device", "cpu", "--config"]
    leader = subprocess.Popen(cmd + [confs[0]], cwd=REPO,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
    worker = subprocess.Popen(cmd + [confs[1], "--role", "pod-worker"],
                              cwd=REPO, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
    url = (f"/webgateway/render_image_region/{IMG}/0/0"
           f"?tile=0,0,0,256,256&{CH}&format=jpeg")
    try:
        deadline = time.monotonic() + LIMIT_S
        while True:
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{http_port}/healthz", timeout=1)
                break
            except OSError:
                assert leader.poll() is None, leader.stderr.read().decode()
                assert worker.poll() is None, worker.stderr.read().decode()
                assert time.monotonic() < deadline, "the pod never came up"
                time.sleep(0.1)
        r = urllib.request.urlopen(f"http://127.0.0.1:{http_port}{url}",
                                   timeout=LIMIT_S)
        body = r.read()
        assert r.status == 200
        leader.terminate()
        assert leader.wait(timeout=LIMIT_S) is not None
        # The shutdown announcement ends the worker.
        assert worker.wait(timeout=LIMIT_S) == 0, \
            worker.stderr.read().decode()
        log = worker.stderr.read().decode()
        assert "pod follower: shutdown after 1 groups" in log
    finally:
        _kill(leader)
        _kill(worker)

    from aiohttp.test_utils import TestClient, TestServer

    async def jax_body():
        config = JaxConfig.from_dict({
            "data-dir": root, "renderer": {"cpu-fallback-max-px": 0},
            "parallel": {"enabled": True, "chan-parallel": 2,
                         "n-devices": 2}})
        async with TestClient(TestServer(jax_app(config))) as client:
            resp = await client.get(url)
            return await resp.read()
    assert body == asyncio.run(jax_body())
