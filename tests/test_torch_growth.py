"""The port's queue-pressure batch growth, backlog split and ``qos`` bulk
cost against the JAX package's.

* JAX's and the port's ``BatchingRenderer`` fed one scripted backlog of
  one key (the group render stubbed, on the CPU, no linger) pop the same
  sequence of group sizes: a backlog that doubles the batch after
  ``GROW_STREAK`` full groups, and ``target-inflight: 3`` splitting a
  backlog across the open streams (with growth past it).
* Both apps with ``qos: {enabled: true, bulk-cost: 4}`` and sessions on
  shed a bulk request (a full plane) from a bucket that still holds
  tokens, with the same Retry-After, admit the same session's tile, and
  put the same ``imageregion_qos_shed_total`` line on ``/metrics``.
"""

import asyncio

import numpy as np
import pytest

from omero_ms_image_region_tpu.ops.render import (
    pack_settings as jax_pack_settings)
from omero_ms_image_region_tpu.flagship import flagship_rdef as jax_rdef
from omero_ms_image_region_tpu.server.batcher import (
    BatchingRenderer as JaxBatcher)
from omero_ms_image_region_tpu_torch.flagship import flagship_rdef
from omero_ms_image_region_tpu_torch.ops.render import pack_settings
from omero_ms_image_region_tpu_torch.server.batcher import BatchingRenderer

from torch_workload_apps import IMG, exchange, write_tree


def _group_sizes(renderer, settings, n: int) -> list:
    """Queue ``n`` renders of one key at once and pop them with every
    group held until the dispatcher can pop no more (all pipeline slots
    taken, or the queue empty), then released one at a time, oldest
    first.  Returns the sizes of the groups in pop order."""
    sizes, gates = [], []

    async def held_group(render, group, slots, key=()):
        sizes.append(len(group))
        gate = asyncio.Event()
        gates.append(gate)
        await gate.wait()
        for p in group:
            p.future.set_result(None)
        slots.release()

    renderer._run_group = held_group
    raw = np.zeros((1, 16, 16), np.uint16)

    async def run():
        tasks = [asyncio.ensure_future(renderer.render(raw, settings))
                 for _ in range(n)]
        released = 0
        while not all(t.done() for t in tasks):
            await asyncio.sleep(0.02)        # the dispatcher pops all it can
            if released < len(gates):
                gates[released].set()
                released += 1
        await asyncio.gather(*tasks)
        await renderer.close()
    asyncio.run(run())
    return sizes


@pytest.mark.parametrize("n, target_inflight, want", [
    # 4 full groups that leave a queue, then the batch is 16.
    (80, 1, [8, 8, 8, 8, 16, 16, 16]),
    # The split: 20 queued over 3 open streams, then 13 over 2.
    (20, 3, [7, 7, 6]),
    # A long backlog with the split on still grows.
    (100, 3, [8, 8, 8, 8, 16, 16, 16, 16, 4]),
])
def test_batchers_pop_the_same_group_sizes(n, target_inflight, want):
    jax_sizes = _group_sizes(
        JaxBatcher(max_batch=8, linger_ms=0.0, pipeline_depth=4,
                   target_inflight=target_inflight),
        jax_pack_settings(jax_rdef(1)), n)
    port = BatchingRenderer("cpu", max_batch=8, linger_ms=0.0,
                            pipeline_depth=4,
                            target_inflight=target_inflight)
    port_sizes = _group_sizes(port, pack_settings(flagship_rdef(1)), n)
    assert port_sizes == jax_sizes == want
    assert port.max_batch == (8 if n <= 20 else 16)


def test_growth_settings_reach_the_default_apps_batcher(tmp_path):
    from omero_ms_image_region_tpu_torch.server.app import build_services
    from omero_ms_image_region_tpu_torch.server.config import AppConfig

    services = build_services(AppConfig.from_dict({
        "data-dir": str(tmp_path),
        "batcher": {"max-batch": 4, "max-batch-limit": 12,
                    "pipeline-depth": 2, "target-inflight": 3}}), "cpu")
    b = services.renderer
    assert (b.max_batch, b.max_batch_limit, b.target_inflight) == (4, 12, 2)


def test_qos_bulk_cost_sheds_alike(tmp_path):
    """3 tokens a session, 4 for a bulk request, hardly refilled: the
    session's full-plane GET is shed (Retry-After: the one missing token
    over the refill rate) while its tile GET is served; another
    session's full plane is shed too; /metrics counts two bulk sheds."""
    root = write_tree(str(tmp_path))
    raw = {"data-dir": root, "session-store": {"type": "static"},
           "sessions": {"enabled": True, "bucket-refill-per-s": 0.001,
                        "bucket-burst": 3},
           "qos": {"enabled": True, "bulk-cost": 4}}
    plane = (f"/webgateway/render_image/{IMG}/0/0?c=1|0:60000$FF0000&m=c"
             f"&format=png")
    tile = (f"/webgateway/render_image_region/{IMG}/0/0?tile=0,1,0,32,32"
            f"&c=1|0:60000$FF0000&m=c&format=png")
    hog, other = {"Cookie": "sessionid=hog"}, {"Cookie": "sessionid=b"}
    requests = [("GET", plane, hog), ("GET", tile, hog),
                ("GET", plane, other), ("GET", "/metrics", {})]
    jax, port = exchange(raw, requests)
    for (_, url, _), want, got in zip(requests[:-1], jax, port):
        assert (got[0], got[2]) == (want[0], want[2]), url
        assert got[1].get("Retry-After") == want[1].get("Retry-After")
    assert [r[0] for r in port[:-1]] == [503, 200, 503]
    assert port[0][1]["Retry-After"] == "1000"
    for _, _, body in (jax[-1], port[-1]):
        assert b'imageregion_qos_shed_total{class="bulk"} 2' in body
