"""Mesh-sharded render steps on ``torch.distributed``: tiles data-parallel,
channels tensor-parallel.

Counterpart of the JAX package's ``parallel/mesh.py``.  A mesh is a
``(data, chan)`` grid of mesh positions, one rank of the default process
group each, one GPU each (``parallel.cluster`` says how the ranks come
up):

* ``data``: the tiles of a group are split into ``data`` equal runs of
  rows, one per grid row: pure data parallelism.
* ``chan``: a tile's channels are split into ``chan`` equal slices, one per
  grid column.  Each position computes the partial RGB composite of its
  slice (K12a, ``ops.render.composite_partial``), the partials are
  all-gathered over the row's ``chan`` subgroup, and K12b
  (``ops.render.composite_pack``) sums them in shard order, rounds, clips
  and packs.  That replaces JAX's ``psum`` over ``chan``: an ordered sum
  is the same on every rank and at every world size, where NCCL's ring
  all-reduce sums in an order of its own (``kernels/csrc/mesh.cu``).
  At ``chan = 1`` (one card's mesh, the default) the ``psum`` is the
  identity and no partial is made: a position renders its rows whole with
  K1 or K2 (``ops.render.render_tile_batch_packed``), the same bytes in
  one launch that moves a third of K12a's and K12b's.

A step is called on every rank of the mesh with that rank's shard of the
group (:func:`shard_batch` / :func:`shard_batch_batched`: its rows and its
channel slice, on its device) and returns that rank's rows, or with
``replicate_output`` the whole group, all-gathered over the column's
``data`` subgroup.  The JPEG steps run the port's K3 and then K4a (sparse)
or K5 (Huffman, the fixed tables, as JAX's mesh) on the position's rows
after the pack.  A standalone process (no process group) is the (1, 1)
mesh: no collective runs.

Differences by design from JAX: a position is a process, so ``n_devices``
must equal the world size (a wider mesh is refused by name: launch one
``--role pod-worker`` per extra GPU); there is no fallback to a virtual
host (CPU) mesh: a mesh on the card with fewer GPUs than asked for is an
error.  The collectives of one mesh are taken one at a time in a process
(``Mesh.lock``: a communicator is not for concurrent use from two
threads).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Union

import numpy as np
import torch

from ..io.staging import pinned_copy
from ..ops.jpegenc import (huffman_pack, huffman_spec_arrays,
                           packed_to_jpeg_coefficients, sparse_pack,
                           spec_tensor)
from ..ops import render as render_ops

_SETTINGS = ("window_start", "window_end", "family", "coefficient",
             "reverse")


def _dist():
    import torch.distributed as dist
    return dist


def joined() -> bool:
    """Has this process joined a ``torch.distributed`` process group?"""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return _dist().get_world_size() if joined() else 1


def rank() -> int:
    return _dist().get_rank() if joined() else 0


def local_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """This process's device: the CPU when asked for, else
    ``cuda:<local rank>`` (``LOCAL_RANK`` when the launcher sets it, else
    the rank modulo the visible GPUs; standalone, the current GPU).
    Raises when CUDA is asked for and there is none: never a CPU mesh."""
    import os

    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported mesh device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "parallel: CUDA requested but torch.cuda.is_available() is "
            "False; a mesh on the card never falls back to the CPU (pass "
            "device='cpu' to run the plain PyTorch path)")
    if device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if joined():
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def resolve_devices(n_devices: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda") -> List[int]:
    """The mesh positions of an ``n_devices``-wide mesh: the ranks of the
    process group (one GPU each), ``[0]`` standalone.

    More positions than ranks is refused: one process drives one GPU, so
    a wider mesh needs one more ``--role pod-worker`` per extra GPU.  On
    the card this also checks that this process has its GPU; there is no
    virtual host mesh to fall back to."""
    local_device(device)
    world = world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {world} "
            f"device(s) are available: a mesh position is one process of "
            f"the group with one GPU; launch one --role pod-worker per "
            f"extra GPU (parallel.num-processes = n-devices)")
    if n_devices is not None and n_devices < world:
        raise ValueError(
            f"parallel.n-devices {n_devices} is less than the world size "
            f"{world}: every process of the group holds one mesh position")
    return list(range(world))


class Mesh:
    """A ``(data, chan)`` grid of ranks and this process's place in it.

    ``shape`` is ``{"data": D, "chan": C}`` as in JAX; ``ranks[d, c]`` is
    the rank at data row ``d`` and chan column ``c``; ``device`` this
    rank's device.  Joined to a process group, building a mesh is
    collective: every rank creates the same row (``chan``) and column
    (``data``) subgroups in the same order.  ``collective=False`` makes a
    mesh of this process alone, with no subgroup (one tile's dense
    fallback on the leader)."""

    axis_names = ("data", "chan")

    def __init__(self, ranks: np.ndarray, device: torch.device,
                 this_rank: int = 0, collective: bool = True):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.device = device
        self.rank = this_rank
        where = np.argwhere(self.ranks == this_rank)
        if len(where) != 1:
            raise ValueError(f"rank {this_rank} holds no single position "
                             f"of the mesh {self.ranks.tolist()}")
        self.position = tuple(int(v) for v in where[0])
        # One collective at a time on this mesh's communicators.
        self.lock = threading.Lock()
        self.chan_group = self.data_group = None
        if collective and joined():
            dist = _dist()
            d, c = self.position
            for row in range(self.ranks.shape[0]):
                group = dist.new_group(self.ranks[row].tolist())
                if row == d:
                    self.chan_group = group
            for col in range(self.ranks.shape[1]):
                group = dist.new_group(self.ranks[:, col].tolist())
                if col == c:
                    self.data_group = group

    @property
    def shape(self) -> dict:
        return {"data": int(self.ranks.shape[0]),
                "chan": int(self.ranks.shape[1])}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def rows(self, batch: int) -> slice:
        """This position's rows of a ``batch`` (a multiple of ``data``)."""
        data = self.shape["data"]
        if batch % data:
            raise ValueError(f"global batch {batch} not divisible by data "
                             f"axis {data}")
        per = batch // data
        return slice(self.position[0] * per, (self.position[0] + 1) * per)

    def channels(self, channels: int) -> slice:
        """This position's channel slice of ``channels`` (a multiple of
        ``chan``)."""
        chan = self.shape["chan"]
        if channels % chan:
            raise ValueError(f"{channels} channels not divisible by chan "
                             f"axis {chan}; pad with inert channels")
        per = channels // chan
        return slice(self.position[1] * per, (self.position[1] + 1) * per)

    def _gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """[n, *t.shape]: ``t`` of each rank of ``group`` in rank order."""
        dist = _dist()
        n = dist.get_world_size(group)
        t = t.contiguous()
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        with self.lock:
            gather(out, t, group=group)
        return out.view((n,) + tuple(t.shape))

    def gather_chan(self, partial: torch.Tensor) -> torch.Tensor:
        """The row's partials [chan, *partial.shape], in column order."""
        if self.chan_group is None:
            return partial[None]
        return self._gather(partial, self.chan_group)

    def gather_data(self, rows: torch.Tensor) -> torch.Tensor:
        """The column's rows concatenated along dim 0, in row order."""
        if self.data_group is None:
            return rows
        out = self._gather(rows, self.data_group)
        return out.reshape((-1,) + tuple(rows.shape[1:]))


def make_mesh(n_devices: Optional[int] = None, chan_parallel: int = 1,
              devices=None, device: Union[str, torch.device] = "cuda"
              ) -> Mesh:
    """Build a ``(data, chan)`` mesh over the process group's ranks.

    ``chan_parallel`` positions cooperate on one tile's channels; the rest
    replicate that group over the batch.  ``devices`` (the ranks, default
    :func:`resolve_devices`) and JAX's errors."""
    if devices is None:
        devices = resolve_devices(n_devices, device)
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only "
            f"{len(devices)} device(s) are available")
    if chan_parallel < 1 or n_devices % chan_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by "
            f"chan_parallel={chan_parallel}")
    grid = np.asarray(devices[:n_devices]).reshape(
        n_devices // chan_parallel, chan_parallel)
    return Mesh(grid, local_device(device), rank())


# ---------------------------------------------------------------- steps

def _composite_step_batched(mesh: Mesh, raw, window_start, window_end,
                            family, coefficient, reverse, cd_start, cd_end,
                            tables) -> torch.Tensor:
    """This position's shard -> its rows packed, i32[Bl, H, W]: K12a on
    its channel slice, the row's partials all-gathered, K12b; at chan 1
    the whole composite by K1/K2, with no partial."""
    args = (raw, window_start, window_end, family, coefficient, reverse,
            cd_start, cd_end, tables)
    if mesh.shape["chan"] == 1:
        return render_ops.render_tile_batch_packed(*args)
    partial = render_ops.composite_partial(*args)
    return render_ops.composite_pack(mesh.gather_chan(partial))


def _shared_to_batched(raw, args):
    """Shared [Cl] settings and [Cl, ...] tables of the shared-settings
    steps, repeated over this shard's tiles (the batched step's form)."""
    B = raw.shape[0]

    def tile(t):
        return t[None].expand((B,) + tuple(t.shape)).contiguous()

    (window_start, window_end, family, coefficient, reverse, cd_start,
     cd_end, tables) = args
    return (tile(window_start), tile(window_end), tile(family),
            tile(coefficient), tile(reverse), cd_start, cd_end,
            tile(tables))


def render_step_sharded(mesh: Mesh):
    """The mesh-sharded render with settings shared by the batch:
    ``step(*shard_batch(mesh, raw, settings)) -> i32[Bl, H, W]``, this
    position's rows of the packed RGBA (u32 bits)."""
    def step(raw, *args):
        return _composite_step_batched(mesh, raw,
                                       *_shared_to_batched(raw, args))
    return step


def _jpeg_wire(mesh: Mesh, packed, quality: int, cap: Optional[int],
               engine: str, cap_words: Optional[int],
               replicate_output: bool) -> torch.Tensor:
    """Packed rows -> their JPEG wire rows (K3, then K4a or K5), all-
    gathered over ``data`` with ``replicate_output``."""
    from ..ops.jpegenc import default_sparse_cap, default_words_cap

    _, H, W = packed.shape
    y, cb, cr = packed_to_jpeg_coefficients(packed, quality)
    if engine == "huffman":
        words = (cap_words if cap_words is not None
                 else default_words_cap(H, W))
        wire = huffman_pack(y, cb, cr, words,
                            spec_tensor(huffman_spec_arrays(),
                                        packed.device), H // 16, W // 16)
    else:
        wire = sparse_pack(y, cb, cr, cap if cap is not None
                           else default_sparse_cap(H, W))
    return mesh.gather_data(wire) if replicate_output else wire


def render_jpeg_step_sharded(mesh: Mesh, quality: int = 85,
                             cap: Optional[int] = None):
    """The full mesh-sharded serving step with shared settings: raw tiles
    -> sparse JPEG wire rows u8[Bl, width] (``ops.jpegenc.sparse_pack``'s
    layout) of this position's tiles."""
    def step(raw, *args):
        packed = _composite_step_batched(mesh, raw,
                                         *_shared_to_batched(raw, args))
        return _jpeg_wire(mesh, packed, quality, cap, "sparse", None, False)
    return step


def render_step_sharded_batched(mesh: Mesh, replicate_output: bool = False):
    """Mesh-sharded render with per-tile settings -> i32[Bl, H, W], or with
    ``replicate_output`` the whole group's i32[B, H, W] on every rank (an
    all-gather over ``data``: what a pod's leader serves from, and what
    keeps every process's decisions alike)."""
    def step(*args):
        out = _composite_step_batched(mesh, *args)
        return mesh.gather_data(out) if replicate_output else out
    return step


def render_jpeg_step_sharded_batched(mesh: Mesh, quality: int = 85,
                                     cap: Optional[int] = None,
                                     engine: str = "sparse",
                                     cap_words: Optional[int] = None,
                                     replicate_output: bool = False):
    """Mesh-sharded serving step with per-tile settings: raw tiles -> JPEG
    wire rows, this position's or (``replicate_output``) the whole
    group's.  ``engine`` is ``"sparse"`` (``sparse_pack`` rows) or
    ``"huffman"`` (``huffman_pack`` rows coded with the fixed tables)."""
    if engine not in ("sparse", "huffman"):
        raise ValueError(f"mesh jpeg engine must be 'sparse' or "
                         f"'huffman', got {engine!r}")

    def step(*args):
        packed = _composite_step_batched(mesh, *args)
        return _jpeg_wire(mesh, packed, quality, cap, engine, cap_words,
                          replicate_output)
    return step


# ---------------------------------------------------------------- shards

def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host array or a tensor as a contiguous tensor on ``device``
    (uint16 kept, moved as its int16 view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint16:
            return x.view(torch.int16).to(device).contiguous().view(
                torch.uint16)
        return x.to(device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _raw_to_device(raw, device: torch.device) -> torch.Tensor:
    """Raw planes on ``device`` in their storage dtype: a host array
    through a pinned buffer (``io.staging.pinned_copy``) on the current
    stream, a tensor already on the card by a copy of its slice."""
    if isinstance(raw, torch.Tensor):
        return _to_device(raw, device)
    return pinned_copy(np.ascontiguousarray(raw), device)


def shard_batch_batched(mesh: Mesh, raw, stacked: dict) -> tuple:
    """This position's shard of a group with per-tile stacked settings
    (``stacked``: [B, C] settings and [B, C, ...] tables, the batcher's
    group form; B a multiple of ``data``, C of ``chan``), on its device:
    the argument tuple of the batched steps."""
    rows = mesh.rows(raw.shape[0])
    chans = mesh.channels(raw.shape[1])
    dev = mesh.device
    return (_raw_to_device(raw[rows, chans], dev),
            *(_to_device(stacked[k][rows, chans], dev) for k in _SETTINGS),
            int(stacked["cd_start"]), int(stacked["cd_end"]),
            _to_device(stacked["tables"][rows, chans], dev))


def shard_batch(mesh: Mesh, raw, settings: dict) -> tuple:
    """This position's shard of a batch and its shared packed settings
    (``ops.render.pack_settings``' dict, channels padded to a multiple of
    ``chan``), on its device: the argument tuple of the shared-settings
    steps."""
    rows = mesh.rows(raw.shape[0])
    chans = mesh.channels(raw.shape[1])
    dev = mesh.device
    return (_raw_to_device(raw[rows, chans], dev),
            *(_to_device(settings[k][chans], dev) for k in _SETTINGS),
            int(settings["cd_start"]), int(settings["cd_end"]),
            _to_device(settings["tables"][chans], dev))
