"""Metadata + ACL service (≙ the OMERO backbone event-bus services).

The reference fetches ``Pixels`` metadata and read-ACL decisions from the
OMERO server JVM over the clustered event bus (addresses
``omero.get_pixels_description`` / ``omero.can_read``;
``ImageRegionRequestHandler.java:80-84, 316-427``).  Here both are async
calls on a local filesystem-backed service over the chunked-store layout.

ACL model: each image directory may carry an ``acl.json`` —
``{"public": true}`` or ``{"sessions": ["key", ...]}``.  Absent file =
public (the standalone dev posture).

Pixels descriptions come from the backend ``io.service`` sniffs, in the
same order: a chunked store's ``meta.json``, else an OME-NGFF group's
``.zattrs`` / ``.zarray`` JSON, else an OME-TIFF's OME-XML and IFDs.  The
NGFF and TIFF parses run off the event loop and are cached per (path,
mtime), so a WSI pyramid is parsed again only when rewritten.

``source_mtime`` is the ``Last-Modified`` source of conditional HTTP
(``server.httpcache``): the newest of the image directory, its
``meta.json``, the NGFF group's geometry stamp (the ``.zattrs`` and
level-0 ``.zarray`` files, not the directory) or the TIFF file, as in the
JAX service, so both packages send the same ``Last-Modified`` and ETag
epoch for the same tree.

Shape masks live under ``<data_dir>/masks/<shape_id>.json`` (width, height,
fill colour) and ``.bin`` (the packed bits), the layout :func:`write_mask`
writes and both packages read.  A mask's ACL is ``<shape_id>.acl.json``
beside them, with the image's ``public`` / ``sessions`` keys; without one
a mask is readable when it exists.

:class:`CanReadMemo` memoizes ACL decisions for 60 s (the JAX package's,
which plays the Hazelcast ``canRead`` map of the reference): the handlers
ask every ACL question through it (``server.handler.check_can_read``), so
against the OMERO database (``services.db_metadata``) a repeat request
pays no ACL round trip.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.ngff import NgffZarrSource, find_ngff
from ..io.ometiff import OmeTiffSource, find_tiff
from ..models.mask import Mask
from ..models.pixels import Pixels

log = logging.getLogger(__name__)

# Level-0 dataset path per NGFF root, validated by the root .zattrs
# mtime: the path only changes when .zattrs changes, so the per-request
# freshness stamp stays stat-only.
_NGFF_LEVEL0: Dict[str, Tuple[int, Optional[str]]] = {}
_NGFF_LEVEL0_LOCK = threading.Lock()


def _ngff_level0_zarray(ngff: str, zattrs_mtime_ns: int) -> Optional[str]:
    with _NGFF_LEVEL0_LOCK:
        cached = _NGFF_LEVEL0.get(ngff)
        if cached is not None and cached[0] == zattrs_mtime_ns:
            return cached[1]
    path = None
    try:
        with open(os.path.join(ngff, ".zattrs")) as f:
            attrs = json.load(f)
        datasets = (attrs.get("multiscales") or [{}])[0] \
            .get("datasets") or []
        if datasets and datasets[0].get("path"):
            path = os.path.join(ngff, datasets[0]["path"], ".zarray")
    except (OSError, ValueError, KeyError, IndexError):
        pass    # malformed/absent .zattrs: the parse downstream complains
    with _NGFF_LEVEL0_LOCK:
        _NGFF_LEVEL0[ngff] = (zattrs_mtime_ns, path)
    return path


def _ngff_meta_mtime(ngff: str) -> int:
    """Freshness stamp (ns) of an NGFF group's geometry: the metadata
    FILES, not the directory (an in-place rewrite leaves the directory's
    mtime alone), the first multiscales level's ``.zarray`` included."""
    candidates = [os.path.join(ngff, ".zattrs"),
                  os.path.join(ngff, ".zarray")]
    try:
        zattrs_mtime = os.stat(candidates[0]).st_mtime_ns
    except OSError:
        zattrs_mtime = 0
    if zattrs_mtime:
        level0 = _ngff_level0_zarray(ngff, zattrs_mtime)
        if level0 is not None:
            candidates.append(level0)
    return max((os.stat(p).st_mtime_ns for p in candidates
                if os.path.exists(p)),
               default=os.stat(ngff).st_mtime_ns)


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
    """Filesystem-backed metadata over the image directories of a data
    directory (chunked store, NGFF group or TIFF) and its masks."""

    # Source mtimes are memoized this long: a request pays a dict hit, not
    # a stat walk.
    _MTIME_TTL_S = 5.0

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        # image id -> ((path, mtime_ns), Pixels) for NGFF- and TIFF-backed
        # images (a chunked store's meta.json read is cheap enough bare).
        self._parsed_pixels: Dict[int, tuple] = {}
        self._mtime_memo: Dict[int, Tuple[float, Optional[float]]] = {}
        self._mtime_lock = threading.Lock()

    def _image_dir(self, image_id: int) -> str:
        return os.path.join(self.data_dir, str(image_id))

    def _mask_base(self, shape_id: int) -> str:
        return os.path.join(self.data_dir, "masks", str(shape_id))

    async def get_pixels_description(self, image_id: int,
                                     session_key: Optional[str]
                                     ) -> Optional[Pixels]:
        image_dir = self._image_dir(image_id)
        meta_path = os.path.join(image_dir, "meta.json")
        if os.path.exists(meta_path):
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
        ngff = await asyncio.to_thread(find_ngff, image_dir)
        if ngff is not None:
            mtime = await asyncio.to_thread(_ngff_meta_mtime, ngff)
            return await self._parsed(image_id, ngff, mtime,
                                      self._parse_ngff_pixels)
        tiff = find_tiff(image_dir)
        if tiff is None:
            return None
        return await self._parsed(image_id, tiff,
                                  os.stat(tiff).st_mtime_ns,
                                  self._parse_tiff_pixels)

    async def _parsed(self, image_id: int, path: str, mtime: int,
                      parse) -> Pixels:
        """The (path, mtime)-cached parse of an NGFF or TIFF image's
        Pixels, run off the event loop on a miss."""
        cached = self._parsed_pixels.get(image_id)
        if cached is not None and cached[0] == (path, mtime):
            return cached[1]
        px = await asyncio.to_thread(parse, image_id, path)
        self._parsed_pixels[image_id] = ((path, mtime), px)
        return px

    @staticmethod
    def _parse_ngff_pixels(image_id: int, ngff: str) -> Pixels:
        src = NgffZarrSource(ngff)
        return Pixels(
            image_id=image_id, pixels_type=np.dtype(src.dtype).name,
            size_x=src.size_x, size_y=src.size_y, size_z=src.size_z,
            size_c=src.size_c, size_t=src.size_t)

    @staticmethod
    def _parse_tiff_pixels(image_id: int, tiff: str) -> Pixels:
        src = OmeTiffSource(tiff)
        try:
            size_x, size_y = src.resolution_descriptions()[0]
            return Pixels(
                image_id=image_id, pixels_type=src.pixels_type,
                size_x=size_x, size_y=size_y, size_z=src.size_z,
                size_c=src.size_c, size_t=src.size_t)
        finally:
            src.close()

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
        directory, its ``meta.json``, its NGFF group's geometry stamp or,
        without a group, its TIFF; None when the image does not exist.
        Memoized for ``_MTIME_TTL_S``."""
        hit, value = self.source_mtime_cached(image_id)
        if hit:
            return value
        image_dir = self._image_dir(image_id)
        candidates = []
        try:
            candidates.append(os.stat(image_dir).st_mtime)
            meta = os.path.join(image_dir, "meta.json")
            if os.path.exists(meta):
                candidates.append(os.stat(meta).st_mtime)
            ngff = find_ngff(image_dir)
            if ngff is not None:
                candidates.append(_ngff_meta_mtime(ngff) / 1e9)
            else:
                tiff = find_tiff(image_dir)
                if tiff is not None:
                    candidates.append(os.stat(tiff).st_mtime)
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


class CanReadMemo:
    """TTL memo of ACL decisions keyed by (session, type, id)
    (≙ the Hazelcast ``canRead`` map the reference's workers share,
    ``ImageRegionVerticle.java:107-111``).

    An in-process TTL dict, and an optional ``shared`` tier (an async
    ``get`` / ``set`` or ``set_ttl`` cache shared by the service's
    instances, b"1"/b"0" values) that plays the distributed map: a
    decision one instance memoized is seen by the others.  The app gives it
    the byte caches' Redis client (``services.cache.Caches.redis``), None
    without ``redis-cache.uri`` or the ``redis`` package.  A shared-tier
    failure is a miss, never a failed request."""

    def __init__(self, ttl_seconds: float = 60.0, shared=None):
        self.ttl = ttl_seconds
        self.shared = shared
        self._lock = threading.Lock()
        self._memo: Dict[Tuple[Optional[str], str, int],
                         Tuple[bool, float]] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _shared_key(session_key: Optional[str], object_type: str,
                    object_id: int) -> str:
        return f"canRead:{session_key or ''}:{object_type}:{object_id}"

    async def get_async(self, session_key: Optional[str], object_type: str,
                        object_id: int) -> Optional[bool]:
        local = self.get(session_key, object_type, object_id)
        if local is not None or self.shared is None:
            return local
        try:
            raw = await self.shared.get(
                self._shared_key(session_key, object_type, object_id))
        except Exception as e:
            log.warning("shared canRead memo get failed: %r", e)
            return None
        if raw is None:
            return None
        value = raw == b"1"
        self.put(session_key, object_type, object_id, value)
        return value

    async def put_async(self, session_key: Optional[str], object_type: str,
                        object_id: int, value: bool) -> None:
        self.put(session_key, object_type, object_id, value)
        if self.shared is None:
            return
        key = self._shared_key(session_key, object_type, object_id)
        payload = b"1" if value else b"0"
        try:
            set_ttl = getattr(self.shared, "set_ttl", None)
            if set_ttl is not None:
                await set_ttl(key, payload, self.ttl)
            else:
                await self.shared.set(key, payload)
        except Exception as e:
            log.warning("shared canRead memo set failed: %r", e)

    def get(self, session_key: Optional[str], object_type: str,
            object_id: int) -> Optional[bool]:
        key = (session_key, object_type, object_id)
        with self._lock:
            hit = self._memo.get(key)
            if hit is not None and time.monotonic() > hit[1]:
                del self._memo[key]
                hit = None
            if hit is None:
                self.misses += 1
                return None
            self.hits += 1
            return hit[0]

    def put(self, session_key: Optional[str], object_type: str,
            object_id: int, value: bool) -> None:
        with self._lock:
            self._memo[(session_key, object_type, object_id)] = (
                value, time.monotonic() + self.ttl)
