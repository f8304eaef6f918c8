"""Mesh-sharded serving: the micro-batcher dispatching over a mesh.

Counterpart of the JAX package's ``parallel/serve.py``.
:class:`MeshRenderer` keeps the micro-batcher's queueing and bucketing
(a drop-in for ``server.batcher.BatchingRenderer``) but runs every
coalesced group through the mesh steps of ``parallel.mesh``: tiles
data-parallel across the mesh, channels tensor-parallel, each position's
partial composite (K12a) all-gathered over ``chan`` and packed in shard
order (K12b), then K3 and K4a (sparse wire) or K5 (Huffman wire) on the
position's rows.  At ``chan = 1`` (one card) a group renders by K1 or K2
instead, with no partial; the bytes are the same.

Group padding makes the fixed mesh shapes hold: the batch pads up to a
multiple of ``data`` (repeating the last tile) and the channels up to a
multiple of ``chan`` with inert channels (window 0..1, zero raw and zero
tables: they add nothing to the composite).

Pods: only the leader (rank 0) has a request stream.  Before each dispatch
it replicates the group to the other ranks over the pod channel
(:class:`_PodChannel`, a broadcast over gloo), and every rank (the others
in :func:`run_pod_follower`, ``--role pod-worker``) runs the same
dispatch.  The outputs are all-gathered inside the step
(``replicate_output``), so every rank takes the same overflow decisions
and the launch sequences stay in lockstep.

Differences by design from JAX: the pod channel carries the raw tile in
its storage dtype (uint8, uint16 or float32, named by a header word; every
array crosses as its bytes) where JAX sends float32, so the port's pods never mix with
JAX's; and the build store keeps serving the mesh kernels' library (JAX
keeps its mesh programs out of its executable cache because they are
bound to a topology; the port's K12 library is not).  The Huffman wire
codes with the fixed tables, as JAX's mesh does.
"""

from __future__ import annotations

import asyncio
import datetime
import logging
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops.jpegenc import (_CAP_MEMO, blocks_per_tile, compact_huffman_rows,
                           compact_sparse_rows, default_sparse_cap,
                           default_words_cap, fetch_rows,
                           finish_huffman_batch, finish_sparse_to_jpegs,
                           packed_to_jpeg_coefficients, row_header_i32)
from ..ops import render as render_ops
from ..server.batcher import BatchingRenderer, _Pending, _shape_label
from ..utils import telemetry
from ..utils.stopwatch import REGISTRY, stopwatch
from .mesh import (_SETTINGS, Mesh, rank,
                   render_jpeg_step_sharded_batched,
                   render_step_sharded_batched, shard_batch_batched,
                   world_size)

logger = logging.getLogger(__name__)


def _pad_group(raw, stacked: dict, data: int, chan: int):
    """Pad [B, C, H, W] raw (numpy or tensor) and its stacked settings to
    a batch that ``data`` divides (the last tile repeated) and channels
    that ``chan`` divides (inert channels)."""
    B, C = raw.shape[:2]
    Bp = -(-B // data) * data
    Cp = -(-C // chan) * chan
    host = isinstance(raw, np.ndarray)
    if Bp != B:
        reps = [raw[-1:]] * (Bp - B)
        raw = (np.concatenate([raw] + reps, axis=0) if host
               else _cat([raw] + reps, 0))
        stacked = {k: (np.concatenate([v] + [v[-1:]] * (Bp - B), axis=0)
                       if getattr(v, "ndim", 0) else v)
                   for k, v in stacked.items()}
    if Cp != C:
        pad_c = Cp - C
        zeros_shape = (Bp, pad_c) + tuple(raw.shape[2:])
        raw = (np.concatenate([raw, np.zeros(zeros_shape, raw.dtype)],
                              axis=1) if host
               else _cat([raw, _zeros_like_storage(raw, zeros_shape)], 1))

        def padc(v, fill):
            ext = np.full((Bp, pad_c) + v.shape[2:], fill, v.dtype)
            return np.concatenate([v, ext], axis=1)

        stacked = dict(stacked)
        stacked["window_start"] = padc(stacked["window_start"], 0.0)
        stacked["window_end"] = padc(stacked["window_end"], 1.0)
        stacked["family"] = padc(stacked["family"], 0)
        stacked["coefficient"] = padc(stacked["coefficient"], 1.0)
        stacked["reverse"] = padc(stacked["reverse"], 0)
        stacked["tables"] = padc(stacked["tables"], 0.0)
    return raw, stacked


def _cat(parts, dim: int) -> torch.Tensor:
    """``torch.cat`` of raw tensors (uint16 through its int16 view)."""
    u16 = parts[0].dtype == torch.uint16
    out = torch.cat([p.view(torch.int16) if u16 else p for p in parts], dim)
    return out.view(torch.uint16) if u16 else out


def _zeros_like_storage(raw: torch.Tensor, shape) -> torch.Tensor:
    if raw.dtype == torch.uint16:
        return torch.zeros(shape, dtype=torch.int16,
                           device=raw.device).view(torch.uint16)
    return torch.zeros(shape, dtype=raw.dtype, device=raw.device)


# ------------------------------------------------------ pod replication

# Header words of the pod channel (leader -> followers).
_POD_HDR = 16
_POD_SHUTDOWN, _POD_RENDER, _POD_JPEG = 0, 1, 2
# The raw tile's dtype in header word 10, and how it crosses gloo.
_RAW_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
              np.dtype(np.float32): 2}
_RAW_DTYPES = {v: k for k, v in _RAW_CODES.items()}
# A follower waits for the leader's next group this long at most (an idle
# pod is not a fault); the step's collectives keep the default timeout.
_POD_TIMEOUT = datetime.timedelta(days=7)


class _PodChannel:
    """Group replication for a pod.

    Every rank of a pod must launch the same collectives in the same
    order, but only the leader (rank 0) has requests.  Before each group
    the leader broadcasts a fixed header of 16 int32 words and then the
    group's arrays (one ``dist.broadcast`` each, over a gloo group of its
    own whose timeout is an idle pod's); the followers rebuild the group
    and run the same dispatch.  Built collectively, on every rank, in the
    same place of the start-up sequence.

    Header: kind, B, C, H, W, quality, engine id (0 sparse, 1 huffman),
    tables ndim (3 ramp, 4 LUT), cd_start, cd_end, raw dtype code."""

    def __init__(self):
        import torch.distributed as dist

        self._dist = dist
        self.group = dist.new_group(backend="gloo", timeout=_POD_TIMEOUT)

    def _bcast(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` from rank 0, into ``arr``'s shape and dtype here; it
        crosses as its bytes (gloo has no 16-bit integer type)."""
        arr = np.ascontiguousarray(arr)
        t = torch.from_numpy(arr.reshape(-1).view(np.uint8))
        self._dist.broadcast(t, src=0, group=self.group)
        return t.numpy().view(arr.dtype).reshape(arr.shape)

    # ---------------------------------------------------------- leader

    def announce(self, kind: int, raw=None, stacked=None,
                 quality: int = 0, engine_id: int = 0) -> None:
        hdr = np.zeros(_POD_HDR, np.int32)
        hdr[0] = kind
        if kind != _POD_SHUTDOWN:
            if isinstance(raw, torch.Tensor):
                raw = (raw.view(torch.int16).cpu().numpy().view(np.uint16)
                       if raw.dtype == torch.uint16 else raw.cpu().numpy())
            B, C, H, W = raw.shape
            hdr[1:5] = (B, C, H, W)
            hdr[5] = quality
            hdr[6] = engine_id
            hdr[7] = np.asarray(stacked["tables"]).ndim
            hdr[8] = int(stacked["cd_start"])
            hdr[9] = int(stacked["cd_end"])
            hdr[10] = _RAW_CODES[raw.dtype]
        self._bcast(hdr)
        if kind == _POD_SHUTDOWN:
            return
        self._bcast(np.ascontiguousarray(raw))
        for arr, dt in self._payload(stacked):
            self._bcast(np.ascontiguousarray(np.asarray(arr, dt)))

    # -------------------------------------------------------- follower

    def recv(self):
        """The next announced group: (kind, raw, stacked, quality,
        engine_id); raw and stacked are None at shutdown."""
        hdr = self._bcast(np.zeros(_POD_HDR, np.int32))
        kind = int(hdr[0])
        if kind == _POD_SHUTDOWN:
            return kind, None, None, 0, 0
        B, C, H, W = (int(v) for v in hdr[1:5])
        raw = self._bcast(np.zeros((B, C, H, W), _RAW_DTYPES[int(hdr[10])]))
        tables_shape = (B, C, 3) if int(hdr[7]) == 3 else (B, C, 256, 3)
        got = [self._bcast(np.zeros(shape, dt))
               for shape, dt in self._shapes(B, C, tables_shape)]
        stacked = dict(zip(_SETTINGS + ("tables",), got))
        stacked["cd_start"], stacked["cd_end"] = int(hdr[8]), int(hdr[9])
        return kind, raw, stacked, int(hdr[5]), int(hdr[6])

    # ---------------------------------------------------------- layout

    @staticmethod
    def _payload(stacked):
        return (
            (stacked["window_start"], np.float32),
            (stacked["window_end"], np.float32),
            (stacked["family"], np.int32),
            (stacked["coefficient"], np.float32),
            (stacked["reverse"], np.int32),
            (stacked["tables"], np.float32),
        )

    @staticmethod
    def _shapes(B, C, tables_shape):
        return (((B, C), np.float32), ((B, C), np.float32),
                ((B, C), np.int32), ((B, C), np.float32),
                ((B, C), np.int32), (tables_shape, np.float32))


class MeshRenderer(BatchingRenderer):
    """Drop-in renderer serving every group through the mesh steps."""

    # The mesh steps run in lockstep across the whole mesh: this renderer
    # is its process's first fleet member (the mesh and bulk lane) and is
    # never pinned narrower than its mesh (parallel.fleet
    # .build_local_members); on a federated mesh host (one process a GPU)
    # it stays member 0, and parallel.federation.build_federated_members
    # warns when the manifest's member 0, the bulk lane, is on another
    # host.
    lockstep = True

    def __init__(self, mesh: Mesh, max_batch: Optional[int] = None,
                 linger_ms: float = 2.0, buckets=None,
                 jpeg_engine: str = "sparse", pipeline_depth: int = 4,
                 max_batch_limit: Optional[int] = None,
                 engine_controller=None, device_lanes: int = 2):
        data = mesh.shape["data"]
        if max_batch is None:
            max_batch = max(8, 2 * data)
        if jpeg_engine not in ("sparse", "huffman"):
            raise ValueError(f"mesh jpeg engine must be 'sparse' or "
                             f"'huffman', got {jpeg_engine!r}")
        multihost = world_size() > 1
        if multihost and pipeline_depth != 1:
            # Every rank must launch the same collectives in the same
            # order; overlapped groups would make this rank's order racy.
            logger.warning("multi-process mesh: forcing pipeline_depth=1 "
                           "(was %d): sharded launches must not overlap",
                           pipeline_depth)
            pipeline_depth = 1
        if multihost:
            device_lanes = 1
        kwargs = {} if buckets is None else {"buckets": buckets}
        super().__init__(mesh.device, max_batch=max_batch,
                         linger_ms=linger_ms, pipeline_depth=pipeline_depth,
                         max_batch_limit=max_batch_limit,
                         device_lanes=device_lanes, jpeg_engine=jpeg_engine,
                         engine_controller=engine_controller, **kwargs)
        if multihost:
            # One launch slot across every bucket key, no growth from
            # host-local timing: the pod launches the same groups in the
            # same order.  Deadline drops stay: they happen on the leader
            # before the group is announced, so every rank replays the
            # group after the drop.  The port has no transient retry to
            # switch off.  Fault injection would stall or fail one rank
            # only: the config refuses it with an explicit multi-process
            # parallel section, and create_app disarms it on a pod joined
            # from the environment.
            self._shared_slots = asyncio.Semaphore(1)
            self._growth_enabled = False
        self.mesh = mesh
        self._steps_lock = threading.Lock()
        self._render_steps: dict = {}
        self._jpeg_steps: dict = {}
        self._multihost = multihost
        # On a pod the outputs are all-gathered inside the step, so the
        # leader holds the whole result and every rank the same wire
        # totals; the leader replicates each group before its dispatch.
        self._replicated = multihost
        self._pod = _PodChannel() if multihost else None

    # ------------------------------------------------------------- steps

    def _render_step(self):
        with self._steps_lock:
            step = self._render_steps.get("render")
            if step is None:
                step = self._render_steps["render"] = \
                    render_step_sharded_batched(
                        self.mesh, replicate_output=self._replicated)
            return step

    def _jpeg_step(self, quality: int, cap: int, engine: str = "sparse",
                   cap_words: Optional[int] = None):
        key = (engine, quality, cap, cap_words)
        with self._steps_lock:
            step = self._jpeg_steps.get(key)
            if step is None:
                step = self._jpeg_steps[key] = \
                    render_jpeg_step_sharded_batched(
                        self.mesh, quality, cap=cap, engine=engine,
                        cap_words=cap_words,
                        replicate_output=self._replicated)
            return step

    # ------------------------------------------------------------ groups

    def _stacked(self, group: List[_Pending]):
        raw, stack = self._group_arrays(group)
        s0 = group[0].settings
        stacked = {name: stack(name) for name in _SETTINGS + ("tables",)}
        stacked["cd_start"] = int(s0["cd_start"])
        stacked["cd_end"] = int(s0["cd_end"])
        return _pad_group(raw, stacked, self.mesh.shape["data"],
                          self.mesh.shape["chan"])

    def _stage(self, group: List[_Pending]):
        """The group stacked and padded (``batcher.stage``), each member's
        share of it in its cost ledger."""
        t0 = time.perf_counter()
        with stopwatch("batcher.stage"):
            raw, stacked = self._stacked(group)
        telemetry.add_cost(
            "stage_ms", (time.perf_counter() - t0) * 1000.0 / len(group))
        return raw, stacked

    def _executed(self, group: List[_Pending], shape: str,
                  t0: float) -> None:
        exec_ms = (time.perf_counter() - t0) * 1000.0
        telemetry.add_cost("device_ms", exec_ms / len(group))
        telemetry.SHAPE_COSTS.observe(shape, exec_ms)

    def _render_group(self, group: List[_Pending]) -> List[np.ndarray]:
        self._inject_faults()
        n = len(group)
        # Staging and the announce sit inside the lane: planes already on
        # the card are gathered on the lane's stream, and announce order
        # is launch order (one lane on a pod).
        with self._lane():
            raw, stacked = self._stage(group)
            shape = "mesh:" + _shape_label(raw.shape)
            if self._pod is not None:
                self._pod.announce(_POD_RENDER, raw, stacked)
            t0 = time.perf_counter()
            with stopwatch("Renderer.renderAsPackedInt.mesh"):
                host = self._render_wire(raw, stacked)
            self._executed(group, shape, t0)
        self._count_batch(n)
        return [host[i, :p.h, :p.w] for i, p in enumerate(group)]

    def _render_wire(self, raw, stacked) -> np.ndarray:
        """The half of a packed render every rank runs: the step and the
        whole result on the host (u32 bits)."""
        args = shard_batch_batched(self.mesh, raw, stacked)
        return self._render_step()(*args).cpu().numpy().view(np.uint32)

    def _fetch(self, wire: torch.Tensor, cap: int,
               cap_words: Optional[int], H: int, W: int) -> list:
        """The wire rows of every tile of the (padded) group to the host:
        K4b compaction, then the used bytes."""
        B = wire.shape[0]
        if cap_words is None:
            compact = compact_sparse_rows(wire, B, cap,
                                          blocks_per_tile(H, W))
        else:
            compact = compact_huffman_rows(wire, B, cap, cap_words)
        return fetch_rows(compact, B)

    def _dense_coefficients(self, raw, stacked, quality: int, i: int):
        """One tile's dense coefficients on this rank's device, by K1/K2
        over all its channels and K3 (no collective): the rare overflow
        fallback of both wire engines, on the leader only."""
        one = slice(i, i + 1)
        args = shard_batch_batched(
            Mesh(np.zeros((1, 1), np.int64), self.mesh.device,
                 collective=False), raw[one],
            {k: (v[one] if getattr(v, "ndim", 0) else v)
             for k, v in stacked.items()})
        packed = render_ops.render_tile_batch_packed(*args)
        y, cb, cr = packed_to_jpeg_coefficients(packed, quality)
        return y[0].cpu().numpy(), cb[0].cpu().numpy(), cr[0].cpu().numpy()

    def _sparse_wire(self, raw, stacked, H: int, W: int, quality: int):
        """Sparse-engine dispatch with the one-shot cap-widening rescue;
        the same on every rank (the replicated totals decide, so the memo
        and the launch sequence stay in lockstep)."""
        cap = default_sparse_cap(H, W, quality)
        memo_key = ("mesh-sparse", H, W, quality)
        if _CAP_MEMO.get(memo_key):
            cap *= 2
        args = shard_batch_batched(self.mesh, raw, stacked)
        rows = self._fetch(self._jpeg_step(quality, cap)(*args), cap, None,
                           H, W)
        totals = np.array([row_header_i32(r, 0) for r in rows])
        if (memo_key not in _CAP_MEMO
                and ((totals > cap) & (totals <= 2 * cap)).any()):
            _CAP_MEMO[memo_key] = True
            cap *= 2
            rows = self._fetch(self._jpeg_step(quality, cap)(*args), cap,
                               None, H, W)
        return rows, cap

    def _huffman_wire(self, raw, stacked, H: int, W: int, quality: int):
        """Huffman-engine dispatch with the one-shot widening; the same
        lockstep contract as :meth:`_sparse_wire`."""
        cap = default_sparse_cap(H, W, quality)
        cap_words = default_words_cap(H, W, quality)
        memo_key = ("mesh-huffman", H, W, quality)
        if _CAP_MEMO.get(memo_key):
            cap, cap_words = cap * 2, cap_words * 2
        args = shard_batch_batched(self.mesh, raw, stacked)
        rows = self._fetch(self._jpeg_step(quality, cap, "huffman",
                                           cap_words)(*args),
                           cap, cap_words, H, W)
        totals = np.array([row_header_i32(r, 0) for r in rows])
        bits = np.array([row_header_i32(r, 1) for r in rows])
        over = (totals > cap) | (bits > cap_words * 32)
        rescuable = (totals <= 2 * cap) & (bits <= 2 * cap_words * 32)
        if memo_key not in _CAP_MEMO and (over & rescuable).any():
            _CAP_MEMO[memo_key] = True
            cap, cap_words = cap * 2, cap_words * 2
            rows = self._fetch(self._jpeg_step(quality, cap, "huffman",
                                               cap_words)(*args),
                               cap, cap_words, H, W)
        return rows, cap, cap_words

    def _jpeg_engine_for(self, all_exact: bool) -> str:
        """The group's wire engine: the live controller's (only the
        leader asks it; the choice rides the announcement) or the static
        one, and the sparse engine for a group whose tiles are not all
        grid-exact (the Huffman stream covers the whole frame)."""
        engine = self._current_engine()
        return "huffman" if engine == "huffman" and all_exact else "sparse"

    def _render_group_jpeg(self, group: List[_Pending]) -> List[bytes]:
        from .. import native

        n = len(group)
        REGISTRY.record("batcher.groupTiles", float(n))
        self._inject_faults()
        quality = group[0].quality
        dims = [(p.w, p.h) for p in group]
        with self._lane():
            raw, stacked = self._stage(group)
            shape = "mesh:" + _shape_label(raw.shape, jpeg=True)
            H, W = raw.shape[-2:]
            all_exact = all((h_ + 15) // 16 * 16 == H
                            and (w_ + 15) // 16 * 16 == W
                            for w_, h_ in dims)
            engine = self._jpeg_engine_for(all_exact)
            if self._pod is not None:
                self._pod.announce(_POD_JPEG, raw, stacked, quality,
                                   engine_id=int(engine == "huffman"))
            t0 = time.perf_counter()
            with stopwatch("Renderer.renderAsPackedInt.mesh"):
                if engine == "huffman":
                    rows, cap, cap_words = self._huffman_wire(
                        raw, stacked, H, W, quality)
                else:
                    rows, cap = self._sparse_wire(raw, stacked, H, W,
                                                  quality)
            self._executed(group, shape, t0)

        def dense(i):
            return self._dense_coefficients(raw, stacked, quality, i)

        # The JFIF tail is the leader's host work after the lockstep
        # device work (the lane is free again): no launch depends on it,
        # so first-tile-out is safe on a pod.
        with stopwatch("jfif.encodeBatch"):
            if engine == "huffman":
                def dense_tile(i):
                    w_, h_ = dims[i]
                    return native.jpeg_encode(*dense(i), w_, h_, quality)

                jpegs = finish_huffman_batch(
                    rows, dims, H, W, quality, cap, cap_words,
                    dense_fallback=dense_tile,
                    on_tile=self._early_settle_cb(group))
            else:
                jpegs = finish_sparse_to_jpegs(
                    rows, dims, H, W, quality, cap, dense,
                    on_tile=self._early_settle_cb(group))
        self._count_batch(n)
        return jpegs

    async def close(self) -> None:
        await super().close()
        if self._pod is not None and rank() == 0:
            logger.info("pod leader: announcing shutdown")
            self._pod.announce(_POD_SHUTDOWN)
            logger.info("pod leader: shutdown announced")


def run_pod_follower(mesh: Mesh, jpeg_engine: str = "sparse") -> int:
    """The loop of a non-leader rank (``--role pod-worker``).

    Receives each group the leader announces and runs the same dispatch
    (the cap-rescue re-dispatches included, decided by the replicated wire
    totals), so the pod's collectives stay in lockstep.  The JFIF tail is
    the leader's: a follower answers no request.  Returns the number of
    groups served, on the leader's shutdown announcement."""
    renderer = MeshRenderer(mesh, jpeg_engine=jpeg_engine)
    pod = renderer._pod or _PodChannel()
    groups = 0
    while True:
        kind, raw, stacked, quality, engine_id = pod.recv()
        if kind == _POD_SHUTDOWN:
            logger.info("pod follower: shutdown after %d groups", groups)
            return groups
        with renderer._lane():
            if kind == _POD_RENDER:
                renderer._render_wire(raw, stacked)
            else:
                H, W = raw.shape[-2:]
                if engine_id == 1:
                    renderer._huffman_wire(raw, stacked, H, W, quality)
                else:
                    renderer._sparse_wire(raw, stacked, H, W, quality)
        groups += 1
