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

Queue-pressure growth, as in JAX: after :attr:`BatchingRenderer
.GROW_STREAK` groups of one key in a row that were full and still left a
queue behind them, ``max_batch`` doubles, up to ``max_batch_limit``
(default 2 x ``max_batch``: 16 for the default 8, the batch at which the
kernels are also checked against their plain versions on the card).  With
``target_inflight`` above 1 a backlog longer than a batch is split across
the open pipeline slots (:meth:`BatchingRenderer._pop_size`).

The front's contract with the JAX batcher (``server.watchdog``,
``utils.faultinject``, ``utils.stopwatch``): each request's queue wait is
recorded once, when its group is popped (``batcher.queueWait``, or
``batcher.queueWait.cancelled`` for work never rendered); the host half of
staging and the enqueue of the group's copy and gather on the lane's
stream are ``batcher.stage``; a lane's execute half is
``Renderer.renderAsPackedInt.batch``.  A lane thread records under every
member's trace, spans and cost ledger alike: each member gets its share
of the group's staging (``stage_ms``, ``staged_bytes``) and of its
execute (``device_ms``), as the JAX batcher writes them.  The watchdog
scans the live groups: one stuck past
``max(stall_min_s, stall_factor x p99)`` has its unsettled members
requeued at the head of their queue, and a member already requeued
``escalate_after - 1`` times is failed with ``ConnectionError``.  A CUDA
stream cannot be interrupted: a group wedged in its execute half (a
stream whose synchronous D2H never returns) keeps its thread, its lane
and its pinned group buffer, so the requeued members take the other lane;
when the thread returns, its results settle into futures already done
(skipped), its lane goes back to the pool and its pinned block returns to
PyTorch's host allocator after its copy's event.  Its group stays out of
the duration history, so one wedge does not stretch the p99.  An injected
freeze or device error (``utils.faultinject``) fires in the group's
worker thread before any launch.

The JPEG wire engine (``jpeg_engine``: "sparse" or "huffman") is chosen
once a group, at the group boundary (:meth:`BatchingRenderer.
_current_engine`): the adaptive controller's current choice when one is
wired (``renderer.jpeg-engine: auto``, ``utils.adaptive``), else the
static engine; ``ops.jpegenc.render_batch_to_jpeg`` falls back to the
sparse engine for a group with tiles that are not grid-exact.

The mask lane (:meth:`BatchingRenderer.rasterize_mask`): a packed mask
queues under ``("mask", width, height, flip_h, flip_v)``, so same-shape,
same-flip masks group into one K8a launch on a lane's stream
(``Renderer.rasterizeMask.batch``); the grids come back to the host for
the PNG tail.

Shape costs (``telemetry.SHAPE_COSTS``): each group's execute wall ms is
observed under its shape label (``B<n>x<C>x<H>x<W>``, ``jpeg:`` for a JPEG
group; mask groups are not observed, as in JAX), and once per shape the
estimate: bytes and f32 operations of K1 (and K3 for a JPEG
group), counted from the shapes as PERF.md's bounds count them
(:func:`_shape_estimate`; the data-dependent K4a, K4b and K5 are left
out).  The JAX batcher takes its estimate from XLA's ``cost_analysis()``.

The pressure governor's ``cap_lanes`` (:meth:`BatchingRenderer
.set_lane_cap`): at most ``cap`` groups hold a device lane at once; a
capped lane takes no new group, and groups already on a stream finish.

The lockstep hooks of JAX's batcher (``_growth_enabled``,
``_shared_slots``, ``_deadline_drop_enabled``), which the mesh renderer of
a multi-process pod sets (``parallel.serve.MeshRenderer``), and
:meth:`BatchingRenderer._group_arrays`, the group's planes and settings
stacked on the host (or on the card when a member is there) for it.

Left out (ROADMAP Queue 1): the executable cache (the build store keeps
the built libraries instead).
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
from ..ops.maskops import rasterize_packed_batch
from ..ops.render import render_tile_batch_packed, resolve_device
from ..utils import faultinject, telemetry, transient
from ..utils.stopwatch import REGISTRY, stopwatch

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
    trace_id: Optional[str] = None   # the requester's trace
    # Times the watchdog requeued this pending out of a stuck group.
    requeues: int = 0


class _LiveGroup:
    """A dispatched group as the watchdog sees it.  ``fires``/``t_fire``
    keep a healed group under scan: if its requeued members never reach a
    healthy lane, the next interval escalates."""

    __slots__ = ("key", "group", "t_start", "fires", "t_fire")

    def __init__(self, key: tuple, group: List[_Pending], t_start: float):
        self.key = key
        self.group = group
        self.t_start = t_start
        self.fires = 0
        self.t_fire = 0.0


def _shape_label(raw_shape, jpeg: bool = False) -> str:
    """The shape-cost label of a group, the JAX batcher's:
    ``B8x4x1024x1024``, prefixed ``jpeg:`` for a JPEG group."""
    label = "B" + "x".join(str(int(v)) for v in raw_shape)
    return ("jpeg:" + label) if jpeg else label


def _shape_estimate(raw_shape, itemsize: int, table_numel: int,
                    jpeg: bool) -> Tuple[float, float]:
    """(f32 operations, bytes) of a group's K1, and K3 for a JPEG group,
    counted as PERF.md's bounds count them: each input read once and each
    output written once; ~17 operations a pixel-channel and 12 a pixel for
    the render, ~16 a pixel and 32 a coefficient for the JPEG front end."""
    B, C, H, W = (int(v) for v in raw_shape)
    px = B * H * W
    n_bytes = B * C * H * W * itemsize + px * 4 + B * C * 4 * 5 \
        + table_numel * 4
    ops = px * (17 * C + 12)
    if jpeg:
        coeffs = px * 3 // 2          # Y, and Cb and Cr at 4:2:0
        n_bytes += px * 4 + coeffs * 2 + 768
        ops += px * 16 + coeffs * 32
    return float(ops), float(n_bytes)


def _key_label(key: tuple) -> str:
    if key and key[0] == "mask":
        return "mask:" + "x".join(str(v) for v in key[1:3])
    return "/".join(str(k) for k in key)


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

    # Groups of one key in a row that were full and left a queue before
    # the batch doubles.
    GROW_STREAK = 4

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 max_batch: int = 8, linger_ms: float = 2.0,
                 buckets=DEFAULT_BUCKETS, pipeline_depth: int = 4,
                 device_lanes: int = 2, jpeg_engine: str = "sparse",
                 engine_controller=None,
                 max_batch_limit: Optional[int] = None,
                 target_inflight: int = 1):
        if jpeg_engine not in ("sparse", "huffman"):
            raise ValueError(
                f"batched jpeg engine must be 'sparse' or 'huffman', "
                f"got {jpeg_engine!r}")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if device_lanes < 1:
            raise ValueError("device_lanes must be >= 1")
        self.device = resolve_device(device)
        self.max_batch = max_batch
        # The growth ceiling: 2 x max_batch unless given.
        self.max_batch_limit = max(max_batch, max_batch_limit
                                   or max_batch * 2)
        # Full-group streaks per key: trickle traffic on one key does not
        # reset another's.
        self._full_streaks: Dict[tuple, int] = {}
        # Groups a backlog is split across, capped by pipeline_depth.
        self.target_inflight = max(1, min(target_inflight, pipeline_depth))
        self.linger_ms = linger_ms
        self.pipeline_depth = pipeline_depth
        self.buckets = tuple(buckets)
        self.device_lanes = device_lanes
        self.jpeg_engine = jpeg_engine
        # Live engine selection (utils.adaptive.AdaptiveEngine); None: the
        # static jpeg_engine.
        self.engine_controller = engine_controller
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
        # High-water dispatched queue wait (ms), for /metrics.
        self.queue_wait_max_ms = 0.0
        # Watchdog state: live groups by their worker future, and recent
        # group durations, whose p99 anchors the stuck threshold.  The
        # knobs are attributes; server.watchdog.build_watchdog sets them.
        self._live_groups: Dict[object, _LiveGroup] = {}
        self._group_durations: Deque[float] = collections.deque(maxlen=64)
        self.watchdog_stall_factor = 8.0
        self.watchdog_stall_min_s = 30.0
        self.watchdog_escalate_after = 2
        # cap_lanes: at most this many groups past the lane gate (0: no
        # cap); _gated counts them.
        self._lane_cap = 0
        self._gated = 0
        self._lane_cv = threading.Condition()
        # First-tile-out settlement (``wire.streaming``): a JPEG request
        # resolves as soon as its own tile is coded; off, a group's
        # requests settle together at its barrier.  The bytes are the same.
        self.first_tile_out = True
        # The lockstep hooks (JAX ``:199-233``), which a mesh renderer on a
        # pod sets (parallel.serve.MeshRenderer): no queue-pressure growth
        # or backlog split from host-local timing (the pod launches the
        # configured batch only); one launch slot shared by every key (a
        # Semaphore(1), made anew for each event loop in _bind); and the
        # deadline drop at dispatch pop, which stays on, since it happens
        # on the leader before a group is announced.
        self._growth_enabled = True
        self._shared_slots: Optional[asyncio.Semaphore] = None
        self._deadline_drop_enabled = True

    def _count_batch(self, tiles: int) -> None:
        with self._stats_lock:
            self.batches_dispatched += 1
            self.tiles_rendered += tiles
            self.group_sizes[tiles] += 1

    def queue_depth(self) -> int:
        """Requests waiting across every group key."""
        return sum(len(q) for q in self._queues.values())

    def inflight(self) -> int:
        """Groups holding a pipeline slot."""
        return len(self._inflight)

    def set_lane_cap(self, cap: int) -> None:
        """The pressure ladder's ``cap_lanes``: at most ``cap`` groups hold
        a device lane at once (0 lifts the cap).  A lane above the cap
        takes no new group; groups already on their streams finish."""
        with self._lane_cv:
            self._lane_cap = max(0, int(cap))
            self._lane_cv.notify_all()

    # ----------------------------------------------------------- watchdog

    def group_p99_s(self) -> float:
        """p99 of recent group durations (healed groups excluded); 0 with
        no history, when the stall floor alone rules."""
        if not self._group_durations:
            return 0.0
        ordered = sorted(self._group_durations)
        return ordered[int(0.99 * (len(ordered) - 1))]

    def watchdog_scan(self, now: Optional[float] = None) -> List[dict]:
        """Heal stuck groups (the ``server.watchdog`` target contract).

        A live group older than ``max(stall_min_s, stall_factor x p99)``
        is stuck.  Its worker thread cannot be interrupted, but its
        waiters can be rescued: its unsettled members go back to the head
        of their queue, and a free pipeline slot and lane re-render them.
        A group whose members were already requeued
        ``watchdog_escalate_after - 1`` times, or that fires again a full
        threshold after a heal (no healthy lane took its members), fails
        them with ``ConnectionError`` instead.  Returns the events."""
        now = time.monotonic() if now is None else now
        threshold = max(self.watchdog_stall_min_s,
                        self.watchdog_stall_factor * self.group_p99_s())
        events: List[dict] = []
        for live in list(self._live_groups.values()):
            anchor = live.t_fire if live.fires else live.t_start
            if now - anchor < threshold:
                continue
            pending = [p for p in live.group if not p.future.done()]
            if not pending:
                continue
            live.fires += 1
            live.t_fire = now
            event = {"target": f"lane:{_key_label(live.key)}",
                     "age_s": round(now - live.t_start, 3),
                     "tiles": len(pending)}
            if (live.fires >= self.watchdog_escalate_after
                    or max(p.requeues for p in pending)
                    >= self.watchdog_escalate_after - 1):
                for p in pending:
                    p.future.set_exception(ConnectionError(
                        "watchdog: device lane stuck after requeue; "
                        "escalating"))
                events.append(dict(event, action="escalate",
                                   escalate=True))
                continue
            queue_ = self._queues.get(live.key)
            if queue_ is None:
                continue
            for p in reversed(pending):
                if any(q is p for q in queue_):
                    continue             # still queued from a last heal
                p.requeues += 1
                queue_.appendleft(p)
            wakeup = self._wakeups.get(live.key)
            if wakeup is not None:
                wakeup.set()
            events.append(dict(event, action="requeue-group",
                               escalate=False))
        return events

    def _record_queue_waits(self, group: List[_Pending], now: float,
                            cancelled: bool = False) -> None:
        """Each request's queue wait, recorded once, when its group is
        popped: ``batcher.queueWait``, or ``batcher.queueWait.cancelled``
        for work never rendered (its budget died, or its waiter left),
        which stays out of the high-water mark."""
        series = ("batcher.queueWait.cancelled" if cancelled
                  else "batcher.queueWait")
        waits = []
        for p in group:
            wait_ms = (now - p.t_enqueue) * 1000.0
            waits.append(wait_ms)
            REGISTRY.record(series, wait_ms)
            if p.trace_id:
                telemetry.record_span(series, p.t_enqueue, wait_ms,
                                      trace_ids=(p.trace_id,))
        if not cancelled:
            with self._stats_lock:
                self.queue_waits_ms.extend(waits)
                self.queue_wait_max_ms = max(self.queue_wait_max_ms,
                                             *waits)

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

    async def rasterize_mask(self, packed: np.ndarray, width: int,
                             height: int, flip_horizontal: bool,
                             flip_vertical: bool) -> np.ndarray:
        """u8[nbytes] packed mask bits -> u8[height, width] 0/1 grid,
        byte-identical to the host ``ops.maskops`` unpack and flip.
        ``packed`` must be ``maskops.pack_mask_payload``'s exact
        ``packed_nbytes``, so the members of a group stack."""
        key = ("mask", width, height, bool(flip_horizontal),
               bool(flip_vertical))
        return await self._enqueue(key, _Pending(
            packed, {}, height, width, (height, width),
            bool(flip_horizontal), bool(flip_vertical)))

    def _bind(self, loop: asyncio.AbstractEventLoop) -> None:
        """Serve ``loop``, dropping the state of a closed one (its tasks
        and events can never run again)."""
        if self._loop is loop:
            return
        if self._loop is not None and not self._loop.is_closed():
            raise RuntimeError("BatchingRenderer is serving another "
                               "running event loop")
        self._loop = loop
        if self._shared_slots is not None:
            self._shared_slots = asyncio.Semaphore(1)
        self._queues.clear()
        self._dispatchers.clear()
        self._wakeups.clear()
        self._inflight.clear()
        self._live_groups.clear()

    async def _enqueue(self, key: tuple, pending: _Pending):
        loop = asyncio.get_running_loop()
        self._bind(loop)
        pending.future = loop.create_future()
        pending.t_enqueue = time.perf_counter()
        pending.deadline = transient.deadline()
        pending.trace_id = telemetry.current_trace_id()
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
        # Created from some request's context: detach, so the loop's
        # spans never land on that one request.
        telemetry.clear_context()
        queue_ = self._queues[key]
        wakeup = self._wakeups[key]
        slots = self._shared_slots or asyncio.Semaphore(self.pipeline_depth)
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
            dead: List[_Pending] = []
            expired = 0
            now = time.monotonic()
            take = self._pop_size(len(queue_))
            while queue_ and len(group) < take:
                p = queue_.popleft()
                if p.future.done():
                    dead.append(p)    # the waiter went away while queued
                    continue
                if (self._deadline_drop_enabled and p.deadline is not None
                        and now >= p.deadline):
                    telemetry.RESILIENCE.count_deadline_cancelled()
                    p.future.set_exception(transient.DeadlineExceededError(
                        "deadline exceeded in batch queue"))
                    dead.append(p)
                    expired += 1
                    continue
                group.append(p)
            if expired:
                telemetry.FLIGHT.record("batch.deadline-cancelled",
                                        n=expired, key=_key_label(key))
            t_pop = time.perf_counter()
            if dead:
                self._record_queue_waits(dead, t_pop, cancelled=True)
            if not group:
                slots.release()
                continue
            self._grow(key, len(group), bool(queue_))
            self._record_queue_waits(group, t_pop)
            telemetry.FLIGHT.record(
                "batch.formed", key=_key_label(key), tiles=len(group),
                queued=len(queue_), inflight=len(self._inflight))
            if key[0] == "jpeg":
                render = self._render_group_jpeg
            elif key[0] == "mask":
                render = self._render_group_mask
            else:
                render = self._render_group
            task = asyncio.create_task(
                self._run_group(render, group, slots, key))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)

    def _grow(self, key: tuple, taken: int, backlog: bool) -> None:
        """Queue-pressure growth: a full group that still leaves a queue
        extends its key's streak; after :attr:`GROW_STREAK` of them the
        batch doubles (up to ``max_batch_limit``) and the streak starts
        over.  Any other group resets the key's streak.  Off on a pod
        (``_growth_enabled``)."""
        if not self._growth_enabled:
            return
        if taken == self.max_batch and backlog:
            streak = self._full_streaks.get(key, 0) + 1
            if (streak >= self.GROW_STREAK
                    and self.max_batch < self.max_batch_limit):
                self.max_batch = min(self.max_batch * 2,
                                     self.max_batch_limit)
                streak = 0
            self._full_streaks[key] = streak
        else:
            self._full_streaks[key] = 0

    def _pop_size(self, qlen: int) -> int:
        """How many requests the next group takes: ``max_batch``, or with
        ``target_inflight`` above 1 and more than a batch queued, the
        backlog split evenly across the streams not yet in flight (not on
        a pod: group sizes there must not follow host-local timing)."""
        if (not self._growth_enabled or self.target_inflight <= 1
                or qlen <= self.max_batch):
            return self.max_batch
        open_streams = max(1, self.target_inflight - len(self._inflight))
        return max(1, min(self.max_batch, -(-qlen // open_streams)))

    async def _run_group(self, render, group: List[_Pending],
                         slots: asyncio.Semaphore, key: tuple) -> None:
        """Render one popped group on a worker thread.

        Settlement (slot release and waiter resolution) happens in the
        inner future's done callback, so only when the worker thread has
        finished: cancelling this task frees no slot while the group still
        runs, and no waiter ever sees a raw ``CancelledError`` (it would
        bypass the HTTP layer's mapping of an exception to a 500).  The
        group is live for the watchdog until then.
        """
        trace_ids = tuple(p.trace_id for p in group if p.trace_id)

        def run():
            # The thread's spans land on every member's trace.
            with telemetry.group_trace(trace_ids):
                return render(group)

        inner = asyncio.ensure_future(asyncio.to_thread(run))
        live = _LiveGroup(key, group, time.monotonic())
        self._live_groups[inner] = live

        def settle(fut: asyncio.Future) -> None:
            slots.release()
            self._live_groups.pop(fut, None)
            if not live.fires:
                self._group_durations.append(
                    time.monotonic() - live.t_start)
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

    @staticmethod
    def _inject_faults() -> None:
        """The fault-injection hooks, in the JAX batcher's order (a
        device error, then a freeze), before any launch."""
        inj = faultinject.active()
        if inj is None:
            return
        inj.maybe_device_error()
        freeze = inj.freeze_s()
        if freeze > 0:
            time.sleep(freeze)

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

    def _staged_raw(self, group: List[_Pending]):
        """Both halves of a group's staging: the host half before a lane
        is taken, then (as a context, in the lane) the device half.  The
        two together are one ``batcher.stage`` sample, and each member's
        cost ledger gets its share of them (``stage_ms``) and of the host
        bytes copied to the card (``staged_bytes``; members already on
        the card staged none)."""
        t0 = time.perf_counter()
        staged = self._stage_host(group)
        host_ms = (time.perf_counter() - t0) * 1000.0

        def device_half() -> torch.Tensor:
            t1 = time.perf_counter()
            raw = self._group_raw(group, staged)
            stage_ms = host_ms + (time.perf_counter() - t1) * 1000.0
            REGISTRY.record("batcher.stage", stage_ms)
            n = len(group)
            fields = {"stage_ms": stage_ms / n}
            if staged is not None:
                fields["staged_bytes"] = staged.array.nbytes / n
            telemetry.add_costs(fields)
            return raw
        return device_half

    def _group_arrays(self, group: List[_Pending]):
        """The group's planes mirrored and edge-padded to its bucket, and
        a stacker of its settings (the JAX ``_group_arrays``, without its
        batch padding): ``(raw, stack)``, ``raw`` a numpy [n, C, bh, bw]
        in the storage dtype when every member is on the host, else a
        tensor on this renderer's device; ``stack(name)`` the members'
        settings ``name`` stacked along a new leading axis."""
        bh, bw = group[0].bucket
        if all(isinstance(p.raw, np.ndarray) for p in group):
            raw = np.empty((len(group), group[0].raw.shape[0], bh, bw),
                           storage_dtype(group[0].raw.dtype))
            for j, p in enumerate(group):
                pad_planes_to_mcu(p.raw, bh, bw, p.flip_h, p.flip_v,
                                  out=raw[j])
        else:
            parts = []
            for p in group:
                if isinstance(p.raw, np.ndarray):
                    t = torch.from_numpy(np.ascontiguousarray(
                        pad_planes_to_mcu(p.raw, bh, bw, p.flip_h, p.flip_v)
                        .astype(storage_dtype(p.raw.dtype), copy=False)))
                    t = _as_storage(t).to(self.device)
                else:
                    t = _as_storage(pad_planes_to_mcu(
                        use_on_current_stream(p.raw), bh, bw, p.flip_h,
                        p.flip_v))
                parts.append(t)
            raw = torch.stack(parts)
            if _dtype_name(group[0].raw) == "uint16":
                raw = raw.view(torch.uint16)

        def stack(name):
            return np.stack([p.settings[name] for p in group])

        return raw, stack

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
        each group ends with a synchronous D2H on its stream.  Under a lane
        cap a group first waits until fewer than ``cap`` groups are past
        the gate."""
        with self._lane_cv:
            while self._lane_cap and self._gated >= self._lane_cap:
                self._lane_cv.wait()
            self._gated += 1
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
            with self._lane_cv:
                self._gated -= 1
                self._lane_cv.notify_all()

    @staticmethod
    def _device_cost(group: List[_Pending], t0: float,
                     shape: Optional[str] = None, estimate=None) -> None:
        """Each member's share of the group's execute (``device_ms``); for
        a render or JPEG group the shape's observed execute, and once per
        shape its estimate (``estimate()``: (operations, bytes))."""
        exec_ms = (time.perf_counter() - t0) * 1000.0
        telemetry.add_cost("device_ms", exec_ms / len(group))
        if shape is None:
            return
        telemetry.SHAPE_COSTS.observe(shape, exec_ms)
        if estimate is not None \
                and telemetry.SHAPE_COSTS.claim_estimate(shape):
            telemetry.SHAPE_COSTS.set_estimate(shape, *estimate())

    @staticmethod
    def _estimate(raw: torch.Tensor, settings: tuple, jpeg: bool):
        return lambda: _shape_estimate(raw.shape, raw.element_size(),
                                       settings[-1].numel(), jpeg)

    def _render_group(self, group: List[_Pending]) -> List[np.ndarray]:
        self._inject_faults()
        device_half = self._staged_raw(group)
        with self._lane(), stopwatch("Renderer.renderAsPackedInt.batch"):
            raw = device_half()
            t0 = time.perf_counter()
            settings = self._settings(group)
            packed = render_tile_batch_packed(raw, *settings)
            host = packed.cpu().numpy().view(np.uint32)
            self._device_cost(group, t0, _shape_label(raw.shape),
                              self._estimate(raw, settings, False))
        self._count_batch(len(group))
        return [host[i, :p.h, :p.w] for i, p in enumerate(group)]

    def _early_settle_cb(self, group: List[_Pending]):
        """First-tile-out hook: resolve request ``i`` from the coding
        thread as soon as its bytes exist.  The group's final settle skips
        futures already done, so this only moves a resolution earlier.
        None (barrier settlement) when :attr:`first_tile_out` is off."""
        if not self.first_tile_out:
            return None

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

    def _current_engine(self) -> str:
        """This group's wire engine: the adaptive controller's when one is
        wired, else the static choice."""
        if self.engine_controller is not None:
            return self.engine_controller.current()
        return self.jpeg_engine

    def _render_group_jpeg(self, group: List[_Pending]) -> List[bytes]:
        REGISTRY.record("batcher.groupTiles", float(len(group)))
        self._inject_faults()
        device_half = self._staged_raw(group)
        with self._lane(), stopwatch("Renderer.renderAsPackedInt.batch"):
            raw = device_half()
            t0 = time.perf_counter()
            settings = self._settings(group)
            jpegs = render_batch_to_jpeg(
                raw, *settings, quality=group[0].quality,
                dims=[(p.w, p.h) for p in group],
                on_tile=self._early_settle_cb(group),
                engine=self._current_engine())
            self._device_cost(group, t0, _shape_label(raw.shape, jpeg=True),
                              self._estimate(raw, settings, True))
        self._count_batch(len(group))
        return jpegs

    def _render_group_mask(self, group: List[_Pending]) -> List[np.ndarray]:
        """One K8a launch for a (shape, flips) mask group: the payloads
        stacked into one pinned buffer, copied and rasterized on the
        lane's stream, the grids copied back."""
        _, width, height, flip_h, flip_v = self._mask_key_of(group)
        packed = np.stack([p.raw for p in group])
        with self._lane(), stopwatch("Renderer.rasterizeMask.batch"):
            t0 = time.perf_counter()
            grids = rasterize_packed_batch(packed, width, height, flip_h,
                                           flip_v, self.device)
            self._device_cost(group, t0)
        self._count_batch(len(group))
        return [grids[i] for i in range(len(group))]

    @staticmethod
    def _mask_key_of(group: List[_Pending]) -> tuple:
        """The group key of a mask group, from its first member."""
        p = group[0]
        return ("mask", p.w, p.h, p.flip_h, p.flip_v)
