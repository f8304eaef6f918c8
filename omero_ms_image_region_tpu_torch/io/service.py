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

With ``repo_root`` (``omero.server`` ``omero.data.dir``) an image that the
data directory lacks opens from the OMERO binary repository, through the
repository-relative candidate paths the DB metadata service resolves
(``services.db_metadata.DbMetadataService.resolve_image_paths``): a
ManagedRepository fileset file (OME-TIFF, a TIFF-based vendor file such as
an Aperio ``.svs``, or an NGFF group) or a legacy ``Pixels/<id>`` ROMIO
buffer (``io.romio``), as the JAX service opens them.
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

    def __init__(self, data_dir: str, max_open: int = DEFAULT_MAX_OPEN,
                 repo_root: Optional[str] = None):
        self.data_dir = data_dir
        self.max_open = max_open
        # The OMERO binary repository's mount (``omero.data.dir``,
        # ``config.yaml:19-20``), the role of the reference's file-path
        # resolver bean (``beanRefContext.xml:13-16``); None: off.
        self.repo_root = repo_root
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

    def _open_from_repo(self, image_id: int, candidates,
                        pixels) -> PixelSource:
        """Open the first usable repository-relative candidate: TIFF
        suffixes (``.ome.tif(f)`` first) through the OME-TIFF reader,
        ``*.zarr`` directories as OME-NGFF, a ``Pixels/<id>`` entry as a
        ROMIO buffer (with the DB geometry, ``pixels``), and any other
        file whose magic says TIFF (vendor WSI names) as a TIFF."""
        from .romio import RomioPixelSource

        def rank(rel: str) -> int:
            low = rel.lower()
            if low.endswith((".ome.tif", ".ome.tiff")):
                return 0
            if low.endswith((".tif", ".tiff", ".svs", ".ndpi")):
                return 1
            return 2

        tried = []
        for rel in sorted(candidates, key=rank):
            path = os.path.join(self.repo_root, rel)
            if os.path.isdir(path):
                ngff = find_ngff(path)
                if ngff is not None:
                    return NgffZarrSource(ngff)
                tried.append(rel)
                continue
            if not os.path.isfile(path):
                tried.append(rel)
                continue
            if rank(rel) < 2:
                return OmeTiffSource(path)
            if rel.startswith("Pixels/"):
                if pixels is None:
                    raise ValueError(
                        f"image {image_id}: ROMIO path {rel} needs "
                        f"pixels geometry to open")
                return RomioPixelSource(path, pixels)
            with open(path, "rb") as f:
                magic = f.read(4)
            if magic[:2] in (b"II", b"MM"):
                return OmeTiffSource(path)
            tried.append(rel)       # present, but not a format served
        raise FileNotFoundError(
            f"image {image_id}: no usable pixel file under "
            f"{self.repo_root} (candidates: {tried or candidates})")

    def get_pixel_source(self, image_id: int, candidates=None,
                         pixels=None) -> PixelSource:
        """≙ ``PixelsService.getPixelBuffer(pixels, false)``.
        ``candidates`` (repository-relative paths from the DB) apply only
        when the data directory has no entry for the image, so a local
        copy always wins."""
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
        if backend is None and candidates and self.repo_root:
            kind, path = "repo", None
        elif backend is None:
            raise FileNotFoundError(
                f"no pixel data for image {image_id} under {self.data_dir}")
        else:
            kind, path = backend
        if kind == "repo":
            src = self._open_from_repo(image_id, candidates, pixels)
        elif kind == "chunked":
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
