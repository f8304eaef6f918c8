"""In-flight render dedup.

Counterpart of the JAX package's ``server/singleflight.py``: concurrent
requests for one render identity (``settings.render_identity_key``)
coalesce onto one pipeline run.
"""

from __future__ import annotations

import asyncio

from ..utils import transient


class SingleFlight:
    """Concurrent requests for one render identity share one pending task.

    Event-loop confined: the bookkeeping runs on the loop thread, so no
    lock.  Waiters await the leader's task through ``asyncio.shield``, so
    a waiter's disconnect (aiohttp cancels its handler) never cancels the
    render the other waiters depend on; the task runs to its end even if
    every waiter has gone.
    """

    def __init__(self):
        self._inflight: dict = {}
        self.hits = 0
        self.misses = 0

    def inflight(self) -> int:
        """Pending coalescable renders."""
        return len(self._inflight)

    async def run(self, key: str, producer):
        """``(result, coalesced)``: ``producer()`` runs at most once per
        key at a time, and followers share the leader's outcome (result or
        exception).

        The shared task runs on the leader's deadline (the batcher drops
        it by that budget); each waiter bounds its own await by its own
        remaining budget, so a follower whose budget dies gets its
        :class:`~..utils.transient.DeadlineExceededError` without
        cancelling the render the others wait for.
        """
        task = self._inflight.get(key)
        if (task is not None
                and task.get_loop() is not asyncio.get_running_loop()):
            # Left over from another (closed) event loop: it can never
            # complete on this one.
            self._inflight.pop(key, None)
            task = None
        coalesced = task is not None
        if task is None:
            self.misses += 1
            task = asyncio.ensure_future(producer())
            self._inflight[key] = task

            def _cleanup(t, key=key):
                if self._inflight.get(key) is t:
                    self._inflight.pop(key, None)
                if not t.cancelled():
                    t.exception()   # retrieved even with no waiters left
            task.add_done_callback(_cleanup)
        else:
            self.hits += 1
        remaining = transient.remaining_ms()
        if remaining is None:
            return await asyncio.shield(task), coalesced
        try:
            result = await asyncio.wait_for(
                asyncio.shield(task), timeout=max(0.0, remaining) / 1000.0)
        except asyncio.TimeoutError:
            raise transient.DeadlineExceededError(
                "deadline exceeded awaiting coalesced render")
        return result, coalesced
