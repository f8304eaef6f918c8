"""Crash-safe background pyramid-build jobs (the JAX package's
``server/jobs.py``).

An unpyramided source (a single-level store, a bare TIFF) costs a
full-resolution read per tile at every zoom level; the reference ecosystem
solves this offline with Bio-Formats pyramid generation.  Here the server
builds the missing levels itself: each level is derived on the card by K9
(``ops.pyramid.downsample2_batch``, bit-exact against the host reduction)
and written back as an OME-NGFF group next to the source, which the
``PixelsService`` backend sniff then prefers for every later open: the
normal serving path, no special reader.  A build's wall time is split
into three spans (``utils.stopwatch``): ``pyramid.readSource`` (level 0
read from the source), ``pyramid.downsample`` (each K9 step, its H2D and
D2H included) and ``pyramid.writeLevel`` (each level's chunk writes).

Crash safety is structural, not transactional:

* each level is written into a ``.lvl-<n>.tmp`` sibling and
  ``os.replace``d to ``<root>/<n>``; a kill mid-level leaves only a tmp
  dir the next run deletes;
* the group markers (``.zgroup`` + multiscales ``.zattrs``) are written
  LAST; ``find_ngff`` / ``NgffZarrSource`` refuse a root without them, so
  a half-built pyramid is invisible to the serving path;
* every level derives deterministically from the source (integer math,
  fixed chunk grid, zlib level 1), so a resumed build re-creates
  byte-identical levels and skips the ones already committed.

Jobs are bulk work: while the pressure governor's ``shed_bulk`` step is
engaged (``server.pressure``) the build parks between levels in state
``deferred`` (:meth:`PyramidJobManager._wait_pressure`, polling every
``pyramid.defer-poll-s``).  The explain plane reads the latest job of an
image (:meth:`PyramidJobManager.job_for_source`).  The job records the JAX
module's flight events (``pyramid.submit``, ``pyramid.level``,
``pyramid.deferred``, ``pyramid.done``).  Left out against the JAX
module: the per-job cancel, which nothing in the port calls.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import torch

from ..utils.stopwatch import stopwatch

log = logging.getLogger("omero_ms_image_region_tpu_torch.jobs")

# Job states, closed vocabulary (mirrored by the telemetry actions).
QUEUED = "queued"
RUNNING = "running"
DEFERRED = "deferred"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"

_TMP_PREFIX = ".lvl-"
_TMP_SUFFIX = ".tmp"


def pyramid_root(source_dir: str) -> str:
    """Where a source directory's built pyramid lives.  A ``*.zarr``
    child is exactly what ``io.ngff.find_ngff`` looks for, so the moment
    the group commits, ``PixelsService._sniff`` prefers it over the
    unpyramided TIFF for every new open."""
    return os.path.join(source_dir, "pyramid.zarr")


@dataclass
class PyramidJob:
    job_id: str
    source: str                      # image dir (or file) to read
    dest: str                        # NGFF root being built
    image_id: Optional[int] = None
    state: str = QUEUED
    levels_total: int = 0
    levels_done: int = 0
    resumed: bool = False
    error: Optional[str] = None
    t_submit: float = field(default_factory=time.time)
    t_done: Optional[float] = None

    def to_doc(self) -> dict:
        return {
            "jobId": self.job_id,
            "imageId": self.image_id,
            "source": self.source,
            "dest": self.dest,
            "state": self.state,
            "levelsTotal": self.levels_total,
            "levelsDone": self.levels_done,
            "resumed": self.resumed,
            "error": self.error,
            "qosClass": "bulk",
            "submittedAt": self.t_submit,
            "doneAt": self.t_done,
        }


def _open_readable(path: str):
    """``ingest._open_source`` without the SystemExit (server context)."""
    from ..ingest import _open_source
    try:
        return _open_source(path)
    except SystemExit as e:
        raise ValueError(str(e)) from None


class PyramidJobManager:
    """Submit, track and run pyramid build jobs.

    One job runs at a time (the build is device- and IO-bound bulk work;
    concurrency would only fight interactive traffic harder).  The runner
    task starts with the app (``server.app.create_app``); the ``ingest
    pyramid`` CLI drives the identical :meth:`run_job_sync` path without a
    loop.  ``device`` is where K9 runs: the card unless the caller passes
    the CPU (the plain version)."""

    def __init__(self, pixels_service=None,
                 chunk=(256, 256), min_level_size: int = 256,
                 compressor: Optional[str] = "zlib",
                 device: Union[str, torch.device] = "cuda",
                 defer_poll_s: float = 0.25):
        self.pixels_service = pixels_service
        self.defer_poll_s = defer_poll_s
        self.chunk = tuple(chunk)
        self.min_level_size = min_level_size
        self.compressor = compressor
        self.device = device
        self._jobs: Dict[str, PyramidJob] = {}
        self._order: List[str] = []
        self._queue: Optional["asyncio.Queue[PyramidJob]"] = None
        self._seq = 0

    # ------------------------------------------------------------ submit

    def submit(self, source: str, image_id: Optional[int] = None
               ) -> PyramidJob:
        """Queue a build for ``source``.  Dedup: an unfinished job for the
        same destination is returned as-is (idempotent POST)."""
        from ..utils import telemetry

        source = os.path.abspath(source)
        if not os.path.exists(source):
            raise FileNotFoundError(source)
        dest = pyramid_root(source if os.path.isdir(source)
                            else os.path.dirname(source))
        for jid in reversed(self._order):
            j = self._jobs[jid]
            if j.dest == dest and j.state in (QUEUED, RUNNING, DEFERRED):
                return j
        self._seq += 1
        job = PyramidJob(job_id=f"pj-{self._seq}", source=source,
                         dest=dest, image_id=image_id)
        self._jobs[job.job_id] = job
        self._order.append(job.job_id)
        telemetry.WORKLOADS.count_job("submitted")
        telemetry.FLIGHT.record("pyramid.submit", job=job.job_id,
                                source=source)
        self._write_sidecar(job)
        if self._queue is not None:
            self._queue.put_nowait(job)
        return job

    def submit_image(self, image_id: int) -> PyramidJob:
        if self.pixels_service is None:
            raise ValueError("no pixels service configured")
        return self.submit(self.pixels_service.image_dir(image_id),
                           image_id=image_id)

    def get(self, job_id: str) -> Optional[PyramidJob]:
        return self._jobs.get(job_id)

    def job_for_source(self, source: str) -> Optional[dict]:
        """The latest job of ``source``'s pyramid, from memory or its job
        file (a previous process's job): the explain plane's probe."""
        source = os.path.abspath(source)
        dest = pyramid_root(source if os.path.isdir(source)
                            else os.path.dirname(source))
        for jid in reversed(self._order):
            if self._jobs[jid].dest == dest:
                return self._jobs[jid].to_doc()
        try:
            with open(dest + ".job.json") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ------------------------------------------------------------ runner

    async def run(self) -> None:
        """Background runner: drain the queue, one build at a time."""
        self._queue = asyncio.Queue()
        for jid in self._order:          # submits before the loop started
            if self._jobs[jid].state == QUEUED:
                self._queue.put_nowait(self._jobs[jid])
        while True:
            job = await self._queue.get()
            if job.state != QUEUED:
                continue
            await self._execute(job)

    async def _execute(self, job: PyramidJob) -> None:
        from ..utils import telemetry
        telemetry.WORKLOADS.job_started()
        job.state = RUNNING
        self._write_sidecar(job)
        try:
            cur, n_levels = await asyncio.to_thread(self._prepare, job)
            for n in range(n_levels):
                await self._wait_pressure(job)
                cur = await asyncio.to_thread(
                    self._level_step, job, cur, n, n_levels)
            await asyncio.to_thread(self._commit, job, n_levels)
            job.state = DONE
            telemetry.WORKLOADS.count_job("completed")
            telemetry.FLIGHT.record("pyramid.done", job=job.job_id,
                                    levels=n_levels,
                                    resumed=int(job.resumed))
        except asyncio.CancelledError:     # the runner torn down
            job.state = CANCELLED
            telemetry.WORKLOADS.count_job("cancelled")
            raise
        except Exception as e:
            job.state = FAILED
            job.error = str(e)
            telemetry.WORKLOADS.count_job("failed")
            log.warning("pyramid job %s failed: %s", job.job_id, e)
        finally:
            job.t_done = time.time()
            telemetry.WORKLOADS.job_finished()
            self._write_sidecar(job)

    def run_job_sync(self, job: PyramidJob) -> PyramidJob:
        """The CLI drive (``ingest pyramid``): the same prepare / level /
        commit steps, no loop, no parking."""
        from ..utils import telemetry
        telemetry.WORKLOADS.job_started()
        job.state = RUNNING
        self._write_sidecar(job)
        try:
            cur, n_levels = self._prepare(job)
            for n in range(n_levels):
                cur = self._level_step(job, cur, n, n_levels)
            self._commit(job, n_levels)
            job.state = DONE
            telemetry.WORKLOADS.count_job("completed")
        except Exception as e:
            job.state = FAILED
            job.error = str(e)
            telemetry.WORKLOADS.count_job("failed")
            raise
        finally:
            job.t_done = time.time()
            telemetry.WORKLOADS.job_finished()
            self._write_sidecar(job)
        return job

    async def _wait_pressure(self, job: PyramidJob) -> None:
        """Park while the ladder's ``shed_bulk`` step is engaged: the build
        is bulk work and must not starve interactive renders."""
        from ..utils import telemetry
        from . import pressure
        deferred = False
        while True:
            gov = pressure.active()
            if gov is None or not gov.bulk_shed_active():
                break
            if not deferred:
                deferred = True
                job.state = DEFERRED
                telemetry.WORKLOADS.count_job("deferred")
                telemetry.FLIGHT.record("pyramid.deferred", job=job.job_id,
                                        level=job.levels_done)
                self._write_sidecar(job)
            await asyncio.sleep(self.defer_poll_s)
        if deferred:
            job.state = RUNNING
            self._write_sidecar(job)

    # ------------------------------------------------------- build steps

    def _prepare(self, job: PyramidJob):
        """Open the source, load level 0, plan the level count, and clear
        any tmp debris a killed predecessor left behind."""
        from ..ingest import _gather_planes
        from ..ops.pyramid import n_pyramid_levels

        if os.path.exists(os.path.join(job.dest, ".zattrs")):
            # A committed pyramid is already serving; nothing to build.
            job.resumed = True
        with stopwatch("pyramid.readSource"):
            src, _backend = _open_readable(job.source)
            try:
                planes = _gather_planes(src)
            finally:
                src.close()
        h, w = planes.shape[-2:]
        n_levels = n_pyramid_levels(h, w, self.min_level_size)
        job.levels_total = n_levels
        if os.path.isdir(job.dest):
            for name in os.listdir(job.dest):
                if name.startswith(_TMP_PREFIX) \
                        and name.endswith(_TMP_SUFFIX):
                    shutil.rmtree(os.path.join(job.dest, name),
                                  ignore_errors=True)
                    log.info("pyramid job %s: removed stale %s",
                             job.job_id, name)
            if any(c.isdigit() and os.path.exists(
                    os.path.join(job.dest, c, ".zarray"))
                    for c in os.listdir(job.dest)):
                job.resumed = True
        if job.resumed:
            from ..utils import telemetry
            telemetry.WORKLOADS.count_job("resumed")
        return planes, n_levels

    def _level_step(self, job: PyramidJob, cur, n: int, n_levels: int):
        """Write level ``n`` (unless already committed) and derive the
        next level's planes on the card.  The tmp dir + ``os.replace``
        pair is the atomic per-level commit."""
        from ..io.ngff import write_ngff_level_dir
        from ..ops.pyramid import downsample2_batch
        from ..utils import telemetry

        final = os.path.join(job.dest, str(n))
        if not os.path.exists(os.path.join(final, ".zarray")):
            tmp = os.path.join(job.dest, f"{_TMP_PREFIX}{n}{_TMP_SUFFIX}")
            os.makedirs(job.dest, exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
            with stopwatch("pyramid.writeLevel"):
                write_ngff_level_dir(tmp, cur, self.chunk, self.compressor)
                os.replace(tmp, final)
            telemetry.WORKLOADS.count_level_committed()
            telemetry.FLIGHT.record("pyramid.level", job=job.job_id,
                                    level=n, of=n_levels)
        job.levels_done = n + 1
        self._write_sidecar(job)
        if n + 1 < n_levels:
            with stopwatch("pyramid.downsample"):
                return downsample2_batch(cur, self.device)
        return cur

    def _commit(self, job: PyramidJob, n_levels: int) -> None:
        """Write the group markers LAST (the build's commit point), then
        drop the source's cached open handle so the next request re-sniffs
        and serves the pyramid."""
        from ..io.ngff import write_ngff_group_meta
        write_ngff_group_meta(job.dest, n_levels)
        if self.pixels_service is not None and job.image_id is not None:
            self.pixels_service.invalidate(job.image_id)

    # ----------------------------------------------------------- sidecar

    def _write_sidecar(self, job: PyramidJob) -> None:
        """Atomic job-state sidecar next to the dest root: status survives
        a process restart."""
        path = job.dest + ".job.json"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(job.to_doc(), f)
            os.replace(tmp, path)
        except OSError:
            log.debug("pyramid sidecar write failed", exc_info=True)
