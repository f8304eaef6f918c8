"""Micro-batching renderer: concurrent tile requests coalesce into one
batched launch of each kernel.

Counterpart of the JAX package's ``server/batcher.py``.  Instead of one
B=1 launch per request, requests that arrive together are stacked along B
and rendered by one launch of K1 or K2 (and, for JPEG, one of K3, K4a and
K4b) on the card.

Spatial buckets: a tile is edge-padded up to the smallest configured bucket
that holds its ceil-16 frame, so tiles of different sizes share a group;
the packed result is cropped back, and a JPEG tile is coded from its own
block subgrid with its true size in the SOF0 header.  Requests with other
windows, families, colours or reverse flags still share a group: those are
per-tile data.  The group key is the channel count, the bucket, the
codomain, ramp or LUT tables, the storage dtype and, for JPEG, the quality.
Flips are per tile too: each tile is mirrored before it is padded.

Deliberate differences from the JAX batcher; none changes a byte:

* No batch padding.  JAX pads a group to a power of two
  (``_pad_batch_size``) to bound its XLA compiles; an eager CUDA launch has
  no per-shape compile, and pad tiles would be wasted K1/K3 work, so a
  group of n tiles launches at B = n.
* Plain pinned H2D (``io.staging``) instead of packed staging.
* No transient retry: a CUDA launch error is sticky, and a failed group
  fails its requests (``utils.transient``).
* No queue-pressure growth: a group holds at most ``max_batch`` tiles, the
  batch sizes at which the kernels are checked against their plain
  versions on the card.

Left out (ROADMAP Queue 1): the mask lane (K8), the executable cache,
fault injection, shape-cost telemetry, the watchdog, and the lane cap and
backlog split that the JAX admission side drives.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..io.staging import (HostPlanes, pin_scope, storage_dtype,
                          use_on_current_stream)
from ..ops.jpegenc import pad_planes_to_mcu, render_batch_to_jpeg
from ..ops.render import render_tile_batch_packed, resolve_device
from ..utils import transient

DEFAULT_BUCKETS = ((256, 256), (512, 512), (1024, 1024), (2048, 2048))

_DTYPE_NAMES = {torch.uint8: "uint8", torch.uint16: "uint16",
                torch.float32: "float32"}


def pick_bucket(h: int, w: int,
                buckets=DEFAULT_BUCKETS) -> Tuple[int, int]:
    """Smallest bucket covering (h, w); an oversize tile keeps its own
    shape."""
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return h, w


def _dtype_name(raw: Union[np.ndarray, torch.Tensor]) -> str:
    """Storage dtype of host or device planes: planes of two dtypes do not
    stack into one group."""
    if isinstance(raw, torch.Tensor):
        return _DTYPE_NAMES[raw.dtype]
    return storage_dtype(raw.dtype).name


def _as_storage(t: torch.Tensor) -> torch.Tensor:
    """uint16 planes in their int16 view (torch's uint16 has no stack)."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


@dataclass
class _Pending:
    raw: Union[np.ndarray, torch.Tensor]   # [C, h, w], the tile's true size
    settings: dict
    h: int                 # crop (packed) or SOF0 (JPEG) height
    w: int
    bucket: Tuple[int, int]
    flip_h: bool = False
    flip_v: bool = False
    quality: int = 0       # JPEG groups only
    future: Optional[asyncio.Future] = None
    t_enqueue: float = 0.0
    # Absolute time.monotonic() budget (utils.transient): work whose
    # budget is spent is failed at dispatch pop, never rendered.
    deadline: Optional[float] = None


class BatchingRenderer:
    """Drop-in for ``handler.Renderer`` with request coalescing.

    One dispatcher task per group key drains its queue: it waits up to
    ``linger_ms`` for co-arrivals (not for a lone request on an idle
    renderer), takes up to ``max_batch`` tiles, and renders them in a
    worker thread.  Up to ``pipeline_depth`` groups of a key run at once;
    each is two stages: the host half (mirror and edge-pad every host
    member into one pinned buffer) and the execute half (H2D, kernels, the
    wire's D2H and the entropy coder), which takes one of ``device_lanes``
    lanes, each with its own CUDA stream.  So one group's upload and
    kernels overlap another group's coding.

    Requests resolve from the worker thread through
    ``loop.call_soon_threadsafe``: a JPEG request as soon as its own tile
    is coded (first-tile-out), the rest when the thread ends.  A group
    failure fails only the members still pending.  The renderer serves one
    event loop at a time; state left by a closed loop is dropped.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 max_batch: int = 8, linger_ms: float = 2.0,
                 buckets=DEFAULT_BUCKETS, pipeline_depth: int = 4,
                 device_lanes: int = 2):
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if device_lanes < 1:
            raise ValueError("device_lanes must be >= 1")
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.linger_ms = linger_ms
        self.pipeline_depth = pipeline_depth
        self.buckets = tuple(buckets)
        self.device_lanes = device_lanes
        self._lanes: "queue.Queue[Optional[torch.cuda.Stream]]" = \
            queue.Queue()
        for _ in range(device_lanes):
            self._lanes.put(torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queues: Dict[tuple, Deque[_Pending]] = {}
        self._dispatchers: Dict[tuple, asyncio.Task] = {}
        self._wakeups: Dict[tuple, asyncio.Event] = {}
        self._inflight: set = set()
        self._stats_lock = threading.Lock()
        self.batches_dispatched = 0
        self.tiles_rendered = 0
        self.group_sizes: collections.Counter = collections.Counter()
        self.queue_waits_ms: Deque[float] = collections.deque(maxlen=4096)
        # Wall time of each group's execute half (its lane held).
        self.execute_ms: Deque[float] = collections.deque(maxlen=4096)
        self._executing = 0
        self.max_executing = 0

    def _count_batch(self, tiles: int) -> None:
        with self._stats_lock:
            self.batches_dispatched += 1
            self.tiles_rendered += tiles
            self.group_sizes[tiles] += 1

    # ------------------------------------------------------------- public

    def _bucket(self, raw) -> Tuple[int, int]:
        h, w = raw.shape[-2:]
        return pick_bucket(h + (-h) % 16, w + (-w) % 16, self.buckets)

    async def render(self, raw: Union[np.ndarray, torch.Tensor],
                     settings: dict, flip_horizontal: bool = False,
                     flip_vertical: bool = False) -> np.ndarray:
        """[C, h, w] raw (host or on this device) + packed settings ->
        u32[h, w] packed RGBA of the (flipped) tile."""
        C, h, w = raw.shape
        bucket = self._bucket(raw)
        key = (C, *bucket, int(settings["cd_start"]),
               int(settings["cd_end"]), settings["tables"].ndim,
               _dtype_name(raw))
        return await self._enqueue(key, _Pending(
            raw, settings, h, w, bucket, flip_horizontal, flip_vertical))

    async def render_jpeg(self, raw: Union[np.ndarray, torch.Tensor],
                          settings: dict, quality: int, width: int,
                          height: int, flip_horizontal: bool = False,
                          flip_vertical: bool = False) -> bytes:
        """[C, h, w] raw + packed settings -> JFIF bytes of the (flipped)
        tile, ``width`` x ``height`` in its SOF0 header."""
        C = raw.shape[0]
        bucket = self._bucket(raw)
        key = ("jpeg", C, *bucket, int(settings["cd_start"]),
               int(settings["cd_end"]), settings["tables"].ndim, quality,
               _dtype_name(raw))
        return await self._enqueue(key, _Pending(
            raw, settings, height, width, bucket, flip_horizontal,
            flip_vertical, quality))

    def _bind(self, loop: asyncio.AbstractEventLoop) -> None:
        """Serve ``loop``, dropping the state of a closed one (its tasks
        and events can never run again)."""
        if self._loop is loop:
            return
        if self._loop is not None and not self._loop.is_closed():
            raise RuntimeError("BatchingRenderer is serving another "
                               "running event loop")
        self._loop = loop
        self._queues.clear()
        self._dispatchers.clear()
        self._wakeups.clear()
        self._inflight.clear()

    async def _enqueue(self, key: tuple, pending: _Pending):
        loop = asyncio.get_running_loop()
        self._bind(loop)
        pending.future = loop.create_future()
        pending.t_enqueue = time.perf_counter()
        pending.deadline = transient.deadline()
        queue_ = self._queues.get(key)
        if queue_ is None:
            queue_ = self._queues[key] = collections.deque()
            self._wakeups[key] = asyncio.Event()
            self._dispatchers[key] = asyncio.create_task(
                self._dispatch_loop(key))
        queue_.append(pending)
        self._wakeups[key].set()
        return await pending.future

    async def close(self) -> None:
        """Stop the dispatchers, let running groups finish, and fail the
        requests still queued."""
        self._bind(asyncio.get_running_loop())
        for task in self._dispatchers.values():
            task.cancel()
        await asyncio.gather(*self._dispatchers.values(),
                             return_exceptions=True)
        # Running groups cannot be interrupted; await them so their
        # requests resolve rather than being cancelled under the waiters.
        if self._inflight:
            await asyncio.gather(*tuple(self._inflight),
                                 return_exceptions=True)
        for queue_ in self._queues.values():
            while queue_:
                pending = queue_.popleft()
                if not pending.future.done():
                    # RuntimeError, not CancelledError: waiters sit in
                    # HTTP handlers that map an Exception to a 500.
                    pending.future.set_exception(
                        RuntimeError("renderer shut down"))
        self._dispatchers.clear()
        self._queues.clear()
        self._wakeups.clear()

    # --------------------------------------------------------- dispatcher

    async def _dispatch_loop(self, key: tuple) -> None:
        """Drain the key's queue into group renders, up to
        ``pipeline_depth`` at once."""
        queue_ = self._queues[key]
        wakeup = self._wakeups[key]
        slots = asyncio.Semaphore(self.pipeline_depth)
        while True:
            if not queue_:
                wakeup.clear()
                await wakeup.wait()
            # Linger for co-arrivals, but not when a full batch waits,
            # and not for a lone request on an idle renderer (it would
            # only tax single-tile latency).
            lone_idle = len(queue_) == 1 and not self._inflight
            if (len(queue_) < self.max_batch and self.linger_ms > 0
                    and not lone_idle):
                await asyncio.sleep(self.linger_ms / 1000.0)
            await slots.acquire()
            # No await between popping the group and handing it to its
            # task, so a close() cancellation cannot orphan a popped
            # group.
            group: List[_Pending] = []
            now = time.monotonic()
            while queue_ and len(group) < self.max_batch:
                p = queue_.popleft()
                if p.future.done():
                    continue          # the waiter went away while queued
                if p.deadline is not None and now >= p.deadline:
                    p.future.set_exception(transient.DeadlineExceededError(
                        "deadline exceeded in batch queue"))
                    continue
                group.append(p)
            if not group:
                slots.release()
                continue
            t_pop = time.perf_counter()
            with self._stats_lock:
                self.queue_waits_ms.extend(
                    (t_pop - p.t_enqueue) * 1000.0 for p in group)
            render = (self._render_group_jpeg if key[0] == "jpeg"
                      else self._render_group)
            task = asyncio.create_task(self._run_group(render, group, slots))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)

    async def _run_group(self, render, group: List[_Pending],
                         slots: asyncio.Semaphore) -> None:
        """Render one popped group on a worker thread.

        Settlement (slot release and waiter resolution) happens in the
        inner future's done callback, so only when the worker thread has
        finished: cancelling this task frees no slot while the group still
        runs, and no waiter ever sees a raw ``CancelledError`` (it would
        bypass the HTTP layer's mapping of an exception to a 500).
        """
        inner = asyncio.ensure_future(asyncio.to_thread(render, group))

        def settle(fut: asyncio.Future) -> None:
            slots.release()
            if fut.cancelled():
                exc: Optional[BaseException] = RuntimeError(
                    "render cancelled")
            else:
                exc = fut.exception()
            if exc is not None:
                for p in group:
                    if not p.future.done():
                        p.future.set_exception(exc)
                return
            for p, out in zip(group, fut.result()):
                if not p.future.done():
                    p.future.set_result(out)

        inner.add_done_callback(settle)
        try:
            await asyncio.shield(inner)
        except asyncio.CancelledError:
            raise      # settle() still runs when the thread finishes
        except Exception:
            pass       # the waiters were failed by settle()

    # ------------------------------------------------- worker-thread half

    def _stage_host(self, group: List[_Pending]) -> Optional[HostPlanes]:
        """Host half of staging, before a lane is taken: every host member
        mirrored and edge-padded to the bucket straight into one pinned
        buffer (members already on the device are padded in the lane)."""
        host = [p for p in group if isinstance(p.raw, np.ndarray)]
        if not host:
            return None
        bh, bw = group[0].bucket
        planes = HostPlanes((len(host), host[0].raw.shape[0], bh, bw),
                            host[0].raw.dtype, self.device)
        for j, p in enumerate(host):
            pad_planes_to_mcu(p.raw, bh, bw, p.flip_h, p.flip_v,
                              out=planes.array[j])
        return planes

    def _group_raw(self, group: List[_Pending],
                   staged: Optional[HostPlanes]) -> torch.Tensor:
        """The group's [n, C, bh, bw] planes on the device, made on the
        lane's stream: one copy of the pinned host members, one gather
        (mirror and edge pad) for each member already on the card."""
        host = staged.upload() if staged is not None else None
        if host is not None and host.shape[0] == len(group):
            return host
        bh, bw = group[0].bucket
        parts, j = [], 0
        for p in group:
            if isinstance(p.raw, np.ndarray):
                parts.append(_as_storage(host[j]))
                j += 1
            else:
                parts.append(_as_storage(pad_planes_to_mcu(
                    use_on_current_stream(p.raw), bh, bw, p.flip_h,
                    p.flip_v)))
        raw = torch.stack(parts)
        return (raw.view(torch.uint16) if _dtype_name(group[0].raw)
                == "uint16" else raw)

    def _settings(self, group: List[_Pending]) -> tuple:
        """Per-tile settings stacked along B on the device, in
        ``render_tile_batch_packed`` argument order after ``raw``."""
        def stack(name):
            return torch.from_numpy(np.stack(
                [p.settings[name] for p in group])).to(self.device)

        s0 = group[0].settings
        return (stack("window_start"), stack("window_end"), stack("family"),
                stack("coefficient"), stack("reverse"), int(s0["cd_start"]),
                int(s0["cd_end"]), stack("tables"))

    @contextlib.contextmanager
    def _lane(self):
        """A device lane for a group's execute half: at most
        ``device_lanes`` groups run their device work, D2H and coding at
        once, each on its own CUDA stream.  A lane is handed back idle:
        each group ends with a synchronous D2H on its stream."""
        stream = self._lanes.get()
        t0 = time.perf_counter()
        with self._stats_lock:
            self._executing += 1
            self.max_executing = max(self.max_executing, self._executing)
        try:
            with pin_scope(self.device), (
                    torch.cuda.stream(stream) if stream is not None
                    else contextlib.nullcontext()):
                yield
        finally:
            with self._stats_lock:
                self._executing -= 1
                self.execute_ms.append((time.perf_counter() - t0) * 1000.0)
            self._lanes.put(stream)

    def _render_group(self, group: List[_Pending]) -> List[np.ndarray]:
        staged = self._stage_host(group)
        with self._lane():
            raw = self._group_raw(group, staged)
            packed = render_tile_batch_packed(raw, *self._settings(group))
            host = packed.cpu().numpy().view(np.uint32)
        self._count_batch(len(group))
        return [host[i, :p.h, :p.w] for i, p in enumerate(group)]

    def _early_settle_cb(self, group: List[_Pending]):
        """First-tile-out hook: resolve request ``i`` from the coding
        thread as soon as its bytes exist.  The group's final settle skips
        futures already done, so this only moves a resolution earlier."""
        def on_tile(i: int, data: bytes) -> None:
            fut = group[i].future

            def settle() -> None:
                if not fut.done():
                    fut.set_result(data)
            try:
                fut.get_loop().call_soon_threadsafe(settle)
            except RuntimeError:
                pass                       # the loop is closed
        return on_tile

    def _render_group_jpeg(self, group: List[_Pending]) -> List[bytes]:
        staged = self._stage_host(group)
        with self._lane():
            raw = self._group_raw(group, staged)
            jpegs = render_batch_to_jpeg(
                raw, *self._settings(group), quality=group[0].quality,
                dims=[(p.w, p.h) for p in group],
                on_tile=self._early_settle_cb(group))
        self._count_batch(len(group))
        return jpegs
