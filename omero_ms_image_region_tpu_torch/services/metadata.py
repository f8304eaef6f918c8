"""Metadata + ACL service (≙ the OMERO backbone event-bus services).

The reference fetches ``Pixels`` metadata and read-ACL decisions from the
OMERO server JVM over the clustered event bus (addresses
``omero.get_pixels_description`` / ``omero.can_read``;
``ImageRegionRequestHandler.java:80-84, 316-427``).  Here both are async
calls on a local filesystem-backed service over the chunked-store layout.

ACL model: each image directory may carry an ``acl.json`` —
``{"public": true}`` or ``{"sessions": ["key", ...]}``.  Absent file =
public (the standalone dev posture).

``source_mtime`` is the ``Last-Modified`` source of conditional HTTP
(``server.httpcache``).  The port reads chunked stores only
(``io.service``), so an image's stamp is the newer of its directory's and
its ``meta.json``'s mtime; the JAX service also stamps NGFF and TIFF
sources, which wait for the port's readers of those formats.

Shape masks live under ``<data_dir>/masks/<shape_id>.json`` (width, height,
fill colour) and ``.bin`` (the packed bits), the layout :func:`write_mask`
writes and both packages read.  A mask's ACL is ``<shape_id>.acl.json``
beside them, with the image's ``public`` / ``sessions`` keys; without one
a mask is readable when it exists.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..models.mask import Mask
from ..models.pixels import Pixels


def _check_acl(path: str, session_key: Optional[str]) -> bool:
    acl_file = os.path.join(path, "acl.json")
    if not os.path.exists(acl_file):
        return True
    with open(acl_file) as f:
        acl = json.load(f)
    if acl.get("public"):
        return True
    return session_key is not None and session_key in acl.get("sessions", [])


class LocalMetadataService:
    """Filesystem-backed metadata: ``<data_dir>/<image_id>/meta.json``."""

    # Source mtimes are memoized this long: a request pays a dict hit, not
    # a stat walk.
    _MTIME_TTL_S = 5.0

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self._mtime_memo: Dict[int, Tuple[float, Optional[float]]] = {}
        self._mtime_lock = threading.Lock()

    def _image_dir(self, image_id: int) -> str:
        return os.path.join(self.data_dir, str(image_id))

    def _mask_base(self, shape_id: int) -> str:
        return os.path.join(self.data_dir, "masks", str(shape_id))

    async def get_pixels_description(self, image_id: int,
                                     session_key: Optional[str]
                                     ) -> Optional[Pixels]:
        meta_path = os.path.join(self._image_dir(image_id), "meta.json")
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            m = json.load(f)
        return Pixels(
            image_id=image_id,
            pixels_type=m.get("pixels_type", m["dtype"]),
            size_x=m["levels"][0]["size_x"],
            size_y=m["levels"][0]["size_y"],
            size_z=m["size_z"],
            size_c=m["size_c"],
            size_t=m["size_t"],
        )

    def source_mtime_cached(self, image_id: int
                            ) -> Tuple[bool, Optional[float]]:
        """Memo peek, ``(hit, mtime)``, with no filesystem work: the
        request path's inline fast path (only a miss pays a thread hop to
        :meth:`source_mtime`)."""
        now = time.monotonic()
        with self._mtime_lock:
            hit = self._mtime_memo.get(image_id)
            if hit is not None and hit[0] > now:
                return True, hit[1]
        return False, None

    def source_mtime(self, image_id: int) -> Optional[float]:
        """The image's source mtime (unix seconds): the newest of its
        directory and its ``meta.json``; None when the image does not
        exist.  Memoized for ``_MTIME_TTL_S``."""
        hit, value = self.source_mtime_cached(image_id)
        if hit:
            return value
        image_dir = self._image_dir(image_id)
        candidates = []
        try:
            candidates.append(os.stat(image_dir).st_mtime)
            candidates.append(
                os.stat(os.path.join(image_dir, "meta.json")).st_mtime)
        except OSError:
            pass
        mtime = max(candidates) if candidates else None
        with self._mtime_lock:
            self._mtime_memo[image_id] = (
                time.monotonic() + self._MTIME_TTL_S, mtime)
            if len(self._mtime_memo) > 4096:    # bounded, coarse
                self._mtime_memo.clear()
        return mtime

    async def can_read(self, object_type: str, object_id: int,
                       session_key: Optional[str]) -> bool:
        """The read ACL of an ``Image`` or a ``Mask`` for a caller."""
        if object_type == "Image":
            path = self._image_dir(object_id)
        else:
            path = self._mask_base(object_id)
            acl = path + ".acl.json"
            if os.path.exists(acl):
                with open(acl) as f:
                    a = json.load(f)
                if a.get("public"):
                    return True
                return (session_key is not None
                        and session_key in a.get("sessions", []))
            return os.path.exists(path + ".json")
        if not os.path.exists(path):
            return False
        return _check_acl(path, session_key)

    async def get_mask(self, shape_id: int,
                       session_key: Optional[str]) -> Optional[Mask]:
        """The stored mask, or None when there is none."""
        base = self._mask_base(shape_id)
        if not os.path.exists(base + ".json"):
            return None
        with open(base + ".json") as f:
            m = json.load(f)
        with open(base + ".bin", "rb") as f:
            bits = f.read()
        fill = m.get("fill_color")
        return Mask(
            shape_id=shape_id,
            width=m["width"],
            height=m["height"],
            bytes_=bits,
            fill_color=None if fill is None else tuple(fill),
        )


def write_mask(data_dir: str, mask: Mask) -> None:
    """Persist a mask in the layout ``LocalMetadataService`` reads."""
    os.makedirs(os.path.join(data_dir, "masks"), exist_ok=True)
    base = os.path.join(data_dir, "masks", str(mask.shape_id))
    with open(base + ".json", "w") as f:
        json.dump({
            "width": mask.width,
            "height": mask.height,
            "fill_color": (None if mask.fill_color is None
                           else list(mask.fill_color)),
        }, f)
    with open(base + ".bin", "wb") as f:
        f.write(mask.bytes_)
