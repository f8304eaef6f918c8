"""PixelsService: image id -> PixelSource (≙ ``ome.io.nio.PixelsService``,
consumed at ``ImageRegionRequestHandler.java:302-309``).

A data directory holds one image per ``<data_dir>/<image_id>/`` directory,
mirroring the reference's ``omero.data.dir`` layout role
(``config.yaml:19-20``).  The backend is sniffed per image directory as the
JAX package's service does: a ``meta.json`` selects the chunked pyramid
store; ``.zattrs``/``.zarray`` markers (directly or in a ``*.zarr`` child)
select the OME-NGFF reader; otherwise an ``*.ome.tif(f)`` / ``*.tif(f)``
file selects the OME-TIFF reader — the role Bio-Formats format dispatch
plays behind ``PixelsService.getPixelBuffer``.

Left out: the JAX service's ``repo_root`` (images resolved through
DB-provided paths in an OMERO binary repository, legacy ``Pixels/<id>``
ROMIO buffers among them).  It needs the DB metadata service and the ROMIO
reader, which come with a later slice.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from .ngff import NgffZarrSource, find_ngff
from .ometiff import OmeTiffSource, find_tiff
from .pixelsource import PixelSource
from .store import ChunkedPyramidStore

DEFAULT_MAX_OPEN = 128


class PixelsService:
    """Opens pixel sources from a data directory, with a bounded LRU of
    open handles (each open store holds live memmaps or file handles, so
    the bound caps fds and address space on long-running servers).

    An evicted source is not closed at once: a reader on a worker thread
    may still be mid-read on its TIFF handle.  It waits on a deferred-close
    list and is closed by a later drain once no reference but the list's
    remains."""

    # Evicted-set size past which a gc.collect() is forced: a reference
    # cycle (e.g. a captured exception traceback) can keep an evicted
    # source's refcount high until a cycle collection runs.
    _GC_THRESHOLD = 8

    def __init__(self, data_dir: str, max_open: int = DEFAULT_MAX_OPEN):
        self.data_dir = data_dir
        self.max_open = max_open
        self._lock = threading.Lock()
        self._open: "OrderedDict[int, PixelSource]" = OrderedDict()
        self._evicted: List[PixelSource] = []

    def _drain_evicted_locked(self) -> int:
        """Close evicted sources no longer referenced anywhere else;
        returns how many stragglers remain.  Caller holds ``self._lock``.
        Refcount 3 = the list slot, the loop variable and getrefcount's
        argument: no reader still holds the source."""
        still: List[PixelSource] = []
        for src in self._evicted:
            if sys.getrefcount(src) <= 3:
                try:
                    src.close()
                except Exception:
                    pass
            else:
                still.append(src)
        self._evicted = still
        return len(still)

    def _gc_and_drain(self) -> None:
        """A cycle collection outside the lock (concurrent lookups never
        stall behind it), then a drain."""
        gc.collect()
        with self._lock:
            self._drain_evicted_locked()

    def image_dir(self, image_id: int) -> str:
        return os.path.join(self.data_dir, str(image_id))

    def _sniff(self, image_id: int) -> Optional[Tuple[str, str]]:
        """("chunked"|"ngff"|"tiff", path) | None."""
        d = self.image_dir(image_id)
        if os.path.exists(os.path.join(d, "meta.json")):
            return ("chunked", d)
        ngff = find_ngff(d)
        if ngff is not None:
            return ("ngff", ngff)
        tiff = find_tiff(d)
        if tiff is not None:
            return ("tiff", tiff)
        return None

    def exists(self, image_id: int) -> bool:
        return self._sniff(image_id) is not None

    def is_open(self, image_id: int) -> bool:
        """LRU probe without disk I/O."""
        with self._lock:
            return image_id in self._open

    def get_open_source(self, image_id: int) -> Optional[PixelSource]:
        """The already-open source, or None; never sniffs or opens, so it
        is safe to call on an event loop."""
        with self._lock:
            src = self._open.get(image_id)
            if src is not None:
                self._open.move_to_end(image_id)
            return src

    def get_pixel_source(self, image_id: int) -> PixelSource:
        """≙ ``PixelsService.getPixelBuffer(pixels, false)``."""
        with self._lock:
            src = self._open.get(image_id)
            if src is not None:
                self._open.move_to_end(image_id)
                if self._evicted:
                    # Hit traffic also releases finished readers' handles
                    # (a refcount scan, no gc).
                    self._drain_evicted_locked()
                return src
        backend = self._sniff(image_id)
        if backend is None:
            raise FileNotFoundError(
                f"no pixel data for image {image_id} under {self.data_dir}")
        kind, path = backend
        if kind == "chunked":
            src = ChunkedPyramidStore(path)
        elif kind == "ngff":
            src = NgffZarrSource(path)
        else:
            src = OmeTiffSource(path)
        with self._lock:
            # A concurrent opener may have won the race: keep theirs and
            # close ours, so no handle leaks.
            existing = self._open.get(image_id)
            if existing is not None:
                self._open.move_to_end(image_id)
                src.close()
                return existing
            self._open[image_id] = src
            while len(self._open) > self.max_open:
                self._evicted.append(self._open.popitem(last=False)[1])
            stragglers = self._drain_evicted_locked()
        if stragglers > self._GC_THRESHOLD:
            self._gc_and_drain()
        return src

    def invalidate(self, image_id: int) -> None:
        """Drop a cached open handle so the next request re-sniffs the
        image directory.  The pyramid job calls this after committing an
        NGFF group: the sniff prefers it, but an LRU-resident source opened
        before the build would otherwise keep serving one level."""
        with self._lock:
            src = self._open.pop(image_id, None)
            if src is not None:
                self._evicted.append(src)   # deferred close
            self._drain_evicted_locked()

    def close(self) -> None:
        with self._lock:
            sources = list(self._open.values()) + self._evicted
            self._open.clear()
            self._evicted = []
        for src in sources:
            try:
                src.close()
            except Exception:
                pass
