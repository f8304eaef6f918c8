"""PixelsService: image id -> PixelSource (≙ ``ome.io.nio.PixelsService``,
consumed at ``ImageRegionRequestHandler.java:302-309``).

A data directory holds one chunked pyramid per image
(``<data_dir>/<image_id>/meta.json``), mirroring the reference's
``omero.data.dir`` layout role (``config.yaml:19-20``).  Only the chunked
store backend is served; the OME-NGFF and OME-TIFF readers of the JAX
package are not ported yet.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from .store import ChunkedPyramidStore

DEFAULT_MAX_OPEN = 128


class PixelsService:
    """Opens chunked stores from a data directory, with a bounded LRU of
    open handles (each open store holds live memmaps, so the bound caps
    fds and address space on long-running servers)."""

    def __init__(self, data_dir: str, max_open: int = DEFAULT_MAX_OPEN):
        self.data_dir = data_dir
        self.max_open = max_open
        self._lock = threading.Lock()
        self._open: "OrderedDict[int, ChunkedPyramidStore]" = OrderedDict()

    def image_dir(self, image_id: int) -> str:
        return os.path.join(self.data_dir, str(image_id))

    def exists(self, image_id: int) -> bool:
        return os.path.exists(os.path.join(self.image_dir(image_id),
                                           "meta.json"))

    def get_pixel_source(self, image_id: int) -> ChunkedPyramidStore:
        """≙ ``PixelsService.getPixelBuffer(pixels, false)``."""
        with self._lock:
            src = self._open.get(image_id)
            if src is not None:
                self._open.move_to_end(image_id)
                return src
        if not self.exists(image_id):
            raise FileNotFoundError(
                f"no pixel data for image {image_id} under {self.data_dir}")
        src = ChunkedPyramidStore(self.image_dir(image_id))
        with self._lock:
            # A concurrent opener may have won the race: keep theirs.
            existing = self._open.setdefault(image_id, src)
            self._open.move_to_end(image_id)
            while len(self._open) > self.max_open:
                # Dropping the store's memmap table is safe under a
                # concurrent read: a reader holds its own memmap reference.
                self._open.popitem(last=False)[1].close()
        return existing

