"""A two-process pod of the port on the CPU (gloo): a leader serving through
``MeshRenderer`` and a ``run_pod_follower`` rank, against the JAX package's
mesh on the same inputs.

* ``chan = 2`` (mesh (1, 2)): each rank computes the partial of its
  channel slice (C=3 padded to 4), the partials are all-gathered over the
  row and packed in shard order.
* ``data = 2`` (mesh (2, 1)): each rank renders its rows of the group
  (3 tiles padded to 4), all-gathered over the column
  (``replicate_output``).

Each group of 3 tiles with mixed settings (a packed group, then a JPEG
group) equals JAX's mesh output for the same inputs (``make_mesh(2,
chan)``).  The leader's close announces the shutdown, which ends the
follower after the same number of groups.  ``jpeg-engine: auto`` takes the
pod's minimum link rate (patched per rank).  Each test picks its port by
``bind(0)``, joins its processes with a hard limit and kills them on
timeout, failing: nothing may hang a worker.
"""

import asyncio
import multiprocessing
import queue as queue_mod
import socket

import numpy as np
import pytest

from omero_ms_image_region_tpu.parallel.mesh import make_mesh as jax_mesh
from omero_ms_image_region_tpu.parallel.serve import (
    MeshRenderer as JaxMeshRenderer)

import torch_pod_worker

LIMIT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pod(chan: int, engine: str):
    """Both ranks' results; kills the ranks and fails past LIMIT_S."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=torch_pod_worker.run,
                         args=(rank, port, chan, engine, results),
                         daemon=True) for rank in (0, 1)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            got = results.get(timeout=LIMIT_S)
            out[got["rank"]] = got
    except queue_mod.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert sorted(out) == [0, 1], f"the pod did not finish in {LIMIT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return out


def _jax_outputs(chan: int, engine: str):
    tiles, settings = torch_pod_worker.group_inputs()
    renderer = JaxMeshRenderer(jax_mesh(2, chan_parallel=chan),
                               linger_ms=50.0, jpeg_engine=engine)

    async def go():
        f32 = [t.astype(np.float32) for t in tiles]
        packed = await asyncio.gather(*(renderer.render(t, s)
                                        for t, s in zip(f32, settings)))
        jpegs = await asyncio.gather(*(
            renderer.render_jpeg(t, s, 85, t.shape[2], t.shape[1])
            for t, s in zip(f32, settings)))
        await renderer.close()
        return [np.asarray(p) for p in packed], list(jpegs)
    return asyncio.new_event_loop().run_until_complete(go())


@pytest.mark.parametrize("chan, engine, shape, rows", [
    (2, "sparse", {"data": 1, "chan": 2}, [slice(0, 4), slice(0, 4)]),
    (1, "huffman", {"data": 2, "chan": 1}, [slice(0, 2), slice(2, 4)]),
], ids=["chan2", "data2"])
def test_pod_matches_jax_mesh(chan, engine, shape, rows):
    out = _run_pod(chan, engine)
    lead, follower = out[0], out[1]
    want_packed, want_jpegs = _jax_outputs(chan, engine)
    for got, want in zip(lead["packed"], want_packed):
        np.testing.assert_array_equal(got, want)
    assert lead["jpegs"] == want_jpegs
    # Two groups each, the follower ended by the shutdown announcement.
    assert lead["groups"] == follower["groups"] == 2
    # The lockstep restrictions of a multi-process mesh.
    assert (lead["lanes"], lead["depth"], lead["growth"]) == (1, 1, False)
    for rank in (0, 1):
        assert out[rank]["shape"] == shape
        assert out[rank]["identity"] == f"proc{rank}"
        assert out[rank]["rows"] == rows[rank]
        # The pod's minimum link rate (5 MB/s on rank 1) picks huffman.
        assert out[rank]["auto"] == "huffman"
