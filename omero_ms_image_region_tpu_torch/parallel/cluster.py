"""Multi-process deployment: joining ``torch.distributed`` and the global mesh.

Counterpart of the JAX package's ``parallel/cluster.py``.  JAX runs one
process per host, which drives every local chip, and joins them with
``jax.distributed``.  The PyTorch idiom is one process per GPU, and so is
the port's deployment:

* **Positions.**  A mesh position (``parallel.mesh``) is one rank of the
  default process group, and each rank owns ``cuda:<local rank>``
  (``LOCAL_RANK``, else the rank modulo the host's visible GPUs).  Rank 0
  is the serving leader (``create_app``); every other rank runs ``python
  -m omero_ms_image_region_tpu_torch.server --role pod-worker`` with the
  same ``parallel`` keys and its own ``process-id``
  (``parallel.serve.run_pod_follower``).
* **Backend.**  ``init_process_group("cpu:gloo,cuda:nccl")``: the step's
  collectives on device tensors ride NCCL; the pod channel's host arrays
  and the link probe's rates ride gloo, as JAX's ``broadcast_one_to_all``
  and ``process_allgather`` carry host numpy.  On the CPU (``device
  "cpu"``, the tests) gloo carries both.
* **Joining.**  ``parallel.coordinator-address`` (``host:port`` or
  ``tcp://host:port``), ``num-processes`` and ``process-id`` are the
  ``tcp://`` init method, the world size and the rank; a join that fails
  with them raises.  Without a coordinator the ``torch.distributed``
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  as ``torchrun`` sets them) is tried; with none, or when that join fails,
  the process stays standalone, as JAX's does, and serves the (1, 1) mesh
  on its one device.

Differences by design from JAX (ROADMAP Queue 3): a mesh wider than the
world size is refused by name (one ``--role pod-worker`` per extra GPU),
and there is no fallback to a virtual host (CPU) mesh: on the card fewer
GPUs than asked for is an error.

A pod::

    # leader, GPU 0 (serves HTTP)
    python -m omero_ms_image_region_tpu_torch.server --config pod.yaml
    # each other GPU, with process-id 1 .. N-1 in its own config
    python -m omero_ms_image_region_tpu_torch.server --config pod1.yaml \\
        --role pod-worker

    parallel: {enabled: true, chan-parallel: 2,
               coordinator-address: "10.0.0.1:29500", num-processes: 2,
               process-id: 0}
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Union

import torch

from .mesh import Mesh, joined, local_device, make_mesh, rank, \
    resolve_devices, world_size

__all__ = ["initialize", "host_identity", "global_mesh",
           "local_batch_slice", "joined", "rank", "world_size"]

_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _backend(device: torch.device) -> str:
    return "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Union[str, torch.device] = "cuda") -> None:
    """Join the default process group (idempotent).

    With ``coordinator_address`` the join is explicit and a failure
    raises.  Without one, the ``torch.distributed`` environment is used
    when a launcher set it; with none (or a failed join) the process stays
    standalone.  On the card this process's GPU becomes the current
    device, so NCCL binds it."""
    import torch.distributed as dist

    if joined():
        return
    dev = torch.device(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("parallel.coordinator-address requires "
                             "num-processes and process-id")
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        dist.init_process_group(_backend(dev), init_method=init,
                                world_size=int(num_processes),
                                rank=int(process_id))
    elif all(k in os.environ for k in _ENV_KEYS):
        try:
            dist.init_process_group(_backend(dev), init_method="env://")
        except (ValueError, RuntimeError):
            return        # no reachable group: a standalone service
    else:
        return
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(dev))


def host_identity() -> str:
    """A stable identity for this process (``federation.host`` defaults,
    diagnostics): ``proc<rank>`` once joined, else the host name."""
    if joined():
        return f"proc{rank()}"
    return socket.gethostname()


def global_mesh(chan_parallel: int = 1, n_devices: Optional[int] = None,
                device: Union[str, torch.device] = "cuda") -> Mesh:
    """The ``(data, chan)`` mesh over every rank of the group (the one
    standalone process: (1, 1)).  ``n_devices`` must be the world size:
    a wider mesh is refused, with the advice to launch one pod-worker per
    extra GPU.  Collective when joined (the mesh's subgroups)."""
    ranks = resolve_devices(n_devices, device)
    return make_mesh(len(ranks), chan_parallel=chan_parallel,
                     devices=ranks, device=device)


def local_batch_slice(mesh: Mesh, global_batch: int) -> slice:
    """This process's rows of a global batch of ``global_batch`` tiles:
    its data row's run (the whole batch on a one-row mesh)."""
    return mesh.rows(global_batch)
