"""One rank of a two-process pod on the CPU (gloo), for
``tests/test_torch_pod.py``: started by ``multiprocessing`` (spawn), it
imports the port alone, never JAX.

Rank 0 is the leader: it serves one packed group and one JPEG group of
three tiles with mixed settings through a ``MeshRenderer`` and closes it
(the shutdown announcement).  Rank 1 runs ``run_pod_follower`` until that
announcement.  Both first resolve ``jpeg-engine: auto`` with the pod, their
link rates patched per rank.  Each puts its results on the queue.
"""

import asyncio

import numpy as np

# Patched link rates (MB/s) by rank: the pod's minimum is below the
# crossover, so every rank picks the Huffman engine.
RATES = {0: 500.0, 1: 5.0}
EDGE = 256          # bucket-exact tiles: the Huffman engine may serve them


def group_inputs(C: int = 3):
    """Three tiles and their mixed settings (numpy), from a seed: other
    windows, a reversed channel each, one with a LUT-free colour swap."""
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.ops.render import pack_settings

    tiles = synthetic_wsi_tiles(np.random.default_rng(21), 3, C, EDGE, EDGE)
    tiles = list(tiles // 8 + 15000)
    settings = []
    for i in range(3):
        rdef = flagship_rdef(C)
        for k, cb in enumerate(rdef.channel_bindings):
            cb.input_start = 14000.0 + 300.0 * i
            cb.input_end = 22000.0 + 1500.0 * i - 200.0 * k
            cb.reverse_intensity = k == i
        settings.append(pack_settings(rdef))
    return tiles, settings


async def _lead(renderer, tiles, settings):
    packed = await asyncio.gather(*(renderer.render(t, s)
                                    for t, s in zip(tiles, settings)))
    jpegs = await asyncio.gather(*(
        renderer.render_jpeg(t, s, 85, t.shape[2], t.shape[1])
        for t, s in zip(tiles, settings)))
    await renderer.close()
    return packed, jpegs


def run(rank: int, port: int, chan: int, engine: str, queue) -> None:
    import torch
    import torch.distributed as dist

    from omero_ms_image_region_tpu_torch.parallel import cluster
    from omero_ms_image_region_tpu_torch.parallel.serve import (
        MeshRenderer, run_pod_follower)
    from omero_ms_image_region_tpu_torch.utils import linkprobe

    torch.set_num_threads(1)
    linkprobe.measure_fetch_mb_s = lambda **kw: RATES[rank]
    cluster.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = cluster.global_mesh(chan_parallel=chan, device="cpu")
    auto = linkprobe.resolve_auto_engine("cpu")
    out = {"rank": rank, "auto": auto, "shape": mesh.shape,
           "identity": cluster.host_identity(),
           "rows": cluster.local_batch_slice(mesh, 4)}
    if rank == 0:
        renderer = MeshRenderer(mesh, linger_ms=50.0, jpeg_engine=engine)
        packed, jpegs = asyncio.run(_lead(renderer, *group_inputs()))
        out.update(packed=[np.asarray(p) for p in packed], jpegs=jpegs,
                   groups=renderer.batches_dispatched,
                   lanes=renderer.device_lanes,
                   depth=renderer.pipeline_depth,
                   growth=renderer._growth_enabled)
    else:
        out["groups"] = run_pod_follower(mesh, jpeg_engine=engine)
    queue.put(out)
    dist.destroy_process_group()
