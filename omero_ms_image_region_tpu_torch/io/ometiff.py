"""OME-TIFF pixel source: serve real microscopy files directly.

The port's copy of the JAX package's ``io/ometiff.py``.
``OmeTiffSource`` implements the :class:`.pixelsource.PixelSource`
protocol over a tiled/pyramidal OME-TIFF — the role Bio-Formats plays
behind the reference's ``PixelsService.getPixelBuffer``
(``ImageRegionRequestHandler.java:302-309``; dependency
``build.gradle:81-83``).  With this backend the service serves existing
OMERO exports drop-in, no re-ingest through ``build_pyramid``.

Layout understood (OME-TIFF 6.0):

- OME-XML in the first IFD's ImageDescription: ``Pixels`` geometry
  (SizeX/Y/Z/C/T, DimensionOrder, Type) and optional ``TiffData``
  plane->IFD mapping;
- one IFD per (z, c, t) plane, ordered by DimensionOrder when no
  TiffData elements are present;
- pyramid levels as SubIFD chains (tag 330) of each plane IFD;
- multi-file sets: TiffData UUID FileName entries map planes to sibling
  files in the same directory (opened lazily), and BinaryOnly stubs
  follow their MetadataFile pointer to the ``*.companion.ome`` — the
  standard multi-file OMERO export layout;
- plain (non-OME) TIFFs degrade gracefully: pages become Z sections of
  a single channel, or channels when SamplesPerPixel > 1.

Decoded segments go through a bounded per-source LRU so pans that
straddle tile boundaries do not re-inflate the same compressed tile.
``get_region(..., out=)`` fills the caller's array segment by segment
from that cache (the handler passes a pinned staging buffer), so a cold
tile is copied once, from the decoded segment to its destination.
"""

from __future__ import annotations

import os
import re
import threading
import xml.etree.ElementTree as ET
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..server.region import RegionDef
from .tiff import (IMAGE_DESCRIPTION, NEW_SUBFILE_TYPE,
                   SAMPLES_PER_PIXEL, Ifd, TiffFile)

# OME pixel Type values are exactly the OMERO pixels-type names the
# render path already understands (models/pixels.py dtype table).
_OME_TYPES = {"int8", "int16", "int32", "uint8", "uint16", "uint32",
              "float", "double", "bit"}

_SEG_CACHE_BYTES = 64 << 20

# Process-wide segment-decode pool (daemon threads, lazily built):
# sized for I/O + GIL-released native decode overlap rather than CPU
# parallelism, so it helps even on single-core hosts.
_DECODE_POOL = None
_DECODE_POOL_LOCK = threading.Lock()


def _decode_pool():
    global _DECODE_POOL
    with _DECODE_POOL_LOCK:
        if _DECODE_POOL is None:
            import concurrent.futures as cf
            _DECODE_POOL = cf.ThreadPoolExecutor(
                max_workers=max(4, (os.cpu_count() or 1) * 2),
                thread_name_prefix="tiffdec")
        return _DECODE_POOL


def _localname(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


class _NoDoctypeTreeBuilder(ET.TreeBuilder):
    """Tree builder whose ``doctype`` callback rejects the document —
    expat invokes it when the declaration is parsed, before any entity
    is used, so a billion-laughs payload never expands."""

    def doctype(self, name, pubid, system):
        raise ValueError(
            "OME-XML with a DTD/entity declaration is rejected "
            "(entity expansion is not OME and unsafe)")


def _find_pixels(root: ET.Element) -> Optional[ET.Element]:
    for el in root.iter():
        if _localname(el.tag) == "Pixels":
            return el
    return None


class OmeTiffSource:
    """PixelSource over one OME-TIFF (or plain TIFF) file."""

    def __init__(self, path: str):
        self.path = path
        self._tf = TiffFile(path)
        self._lock = threading.Lock()
        self._seg_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._seg_cache_bytes = 0
        # Multi-file OME-TIFF: sibling files referenced by TiffData UUID
        # FileName entries, opened lazily and keyed by basename.  Key
        # None = the primary file.
        self._files: Dict[Optional[str], TiffFile] = {None: self._tf}
        # Page-based pyramids (plain TIFF): full-res page -> its
        # reduced-resolution page indices, in file order.
        self._page_levels: Dict[int, List[int]] = {}
        try:
            self._parse_layout()
        except BaseException:
            # Loud metadata failures (corrupt companion, rejected DTD,
            # unsupported layout) must not leak the already-open
            # descriptors to GC timing — servers probe hostile files.
            self.close()
            raise

    # ------------------------------------------------------------- layout

    def _file(self, key: Optional[str]) -> TiffFile:
        tf = self._files.get(key)
        if tf is None:
            sibling = os.path.join(os.path.dirname(self.path), key)
            if not os.path.exists(sibling):
                raise FileNotFoundError(
                    f"{self.path}: OME TiffData references missing "
                    f"file {key!r}")
            with self._lock:
                tf = self._files.get(key)
                if tf is None:
                    tf = self._files[key] = TiffFile(sibling)
        return tf

    @staticmethod
    def _fromstring_no_dtd(text) -> ET.Element:
        """``ET.fromstring`` with any DOCTYPE rejected at the parser.

        ElementTree expands internal entities, so a hostile
        ImageDescription carrying a billion-laughs DTD would balloon
        memory before any OME validation runs.  Real OME-XML never
        declares a DTD (the schema is XSD), so the presence of one IS
        the verdict.  The rejection rides the TreeBuilder ``doctype``
        callback — which expat fires when the declaration is parsed,
        before any entity use in the body — so it cannot be dodged by
        prolog padding or an exotic document encoding the way a raw
        substring scan of a decoded prefix could.
        """
        return ET.fromstring(
            text, parser=ET.XMLParser(target=_NoDoctypeTreeBuilder()))

    def _resolve_ome_root(self, desc: str) -> Optional[ET.Element]:
        """The OME root for this file — following a BinaryOnly pointer
        to its companion metadata file (``*.companion.ome``), the
        standard multi-file OMERO export layout."""
        try:
            root = self._fromstring_no_dtd(desc)
        except (ET.ParseError, ValueError):
            # Unparseable — or DTD-carrying, which is unparseable by
            # policy — descriptions degrade to plain-TIFF semantics,
            # exactly like any other non-OME ImageDescription.
            return None
        for el in root.iter():
            if _localname(el.tag) == "BinaryOnly":
                meta = el.get("MetadataFile")
                if not meta:
                    return root
                companion = os.path.join(
                    os.path.dirname(self.path), meta)
                if not os.path.exists(companion):
                    raise FileNotFoundError(
                        f"{self.path}: BinaryOnly metadata file "
                        f"{meta!r} not found")
                with open(companion, "rb") as f:
                    try:
                        return self._fromstring_no_dtd(f.read())
                    except (ET.ParseError, ValueError) as e:
                        # A present-but-corrupt (or DTD-carrying)
                        # companion must be as loud as a missing one —
                        # degrading to plain-TIFF semantics would serve
                        # wrong dimensions — and must name the file an
                        # operator has to go look at.
                        raise ValueError(
                            f"{self.path}: companion metadata "
                            f"{meta!r} rejected: {e}")
        return root

    def _parse_layout(self) -> None:
        tf = self._tf
        first = tf.ifds[0]
        desc = first.one(IMAGE_DESCRIPTION, "") or ""
        self.size_z = self.size_c = self.size_t = 1
        self.dimension_order = "XYZCT"
        self.pixels_type: Optional[str] = None
        self._interleaved_c = False   # channels live in SamplesPerPixel
        plane_map: Dict[Tuple[int, int, int],
                        Tuple[Optional[str], int]] = {}
        spp = int(first.one(SAMPLES_PER_PIXEL, 1))
        self_names = {None, os.path.basename(self.path)}

        px = None
        if "<OME" in desc or "<ome" in desc:
            root = self._resolve_ome_root(desc)
            px = _find_pixels(root) if root is not None else None

        if px is not None:
            self.size_z = int(px.get("SizeZ", 1))
            self.size_c = int(px.get("SizeC", 1))
            self.size_t = int(px.get("SizeT", 1))
            order = px.get("DimensionOrder", "XYZCT")
            if (len(order) == 5 and order[:2] == "XY"
                    and set(order[2:]) == set("ZCT")):
                self.dimension_order = order
            ptype = (px.get("Type") or "").lower()
            if ptype and ptype not in _OME_TYPES:
                raise ValueError(
                    f"{self.path}: unsupported OME pixel type {ptype!r}")
            self.pixels_type = ptype or None
            # Interleaved detection must precede TiffData mapping: with
            # channels in SamplesPerPixel, C is not an IFD dimension and
            # _advance() must not enumerate it.
            if spp > 1 and self.size_c == spp and len(tf.ifds) < (
                    self.size_z * self.size_c * self.size_t):
                self._interleaved_c = True
            for td in px:
                if _localname(td.tag) != "TiffData":
                    continue
                # Multi-file OME-TIFF: a UUID child's FileName names the
                # sibling holding these planes (same directory).
                file_key: Optional[str] = None
                for child in td:
                    if _localname(child.tag) == "UUID":
                        name = child.get("FileName")
                        if name and name not in self_names:
                            file_key = name
                fz = int(td.get("FirstZ", 0))
                fc = int(td.get("FirstC", 0))
                ft = int(td.get("FirstT", 0))
                ifd0 = int(td.get("IFD", 0))
                if td.get("PlaneCount") is not None:
                    count = int(td.get("PlaneCount"))
                elif td.get("IFD") is not None:
                    count = 1            # spec: IFD without PlaneCount
                else:
                    # Attribute-less TiffData covers the TARGET file's
                    # own IFDs in order (spec) — never the whole set's
                    # plane count, which for a multi-file entry would
                    # wrap plane coordinates and corrupt the map.
                    count = len(self._file(file_key).ifds)
                count = min(count, self._n_ifd_planes())
                for k in range(count):
                    z, c, t = self._advance(fz, fc, ft, k)
                    plane_map[(z, c, t)] = (file_key, ifd0 + k)
        else:
            # Plain TIFF: pages = Z sections; chunky RGB = channels.
            # Reduced-resolution pages (NewSubfileType bit 0 — the
            # pre-OME page-based pyramid layout vips/openslide-style
            # exporters write) attach as pyramid levels of the
            # preceding full-resolution page instead of masquerading
            # as extra Z sections.
            full_pages = []
            for i, page_ifd in enumerate(tf.ifds):
                if int(page_ifd.one(NEW_SUBFILE_TYPE, 0)) & 1:
                    if full_pages:
                        self._page_levels[full_pages[-1]].append(i)
                else:
                    full_pages.append(i)
                    self._page_levels[i] = []
            if len(full_pages) > 1 and not any(
                    self._page_levels[i] for i in full_pages):
                # Aperio SVS-style layout: vendors historically flag
                # NOTHING — page 0 is the tiled baseline, later TILED
                # pages with strictly smaller dims are pyramid levels,
                # and STRIPPED pages (thumbnail/label/macro) are
                # associated images, not Z sections.  Only applied when
                # page 0 is tiled and every other page fits the
                # pattern; equal-size tiled pages (a real tiled Z
                # stack) never match.
                base = tf.ifds[full_pages[0]]
                levels, associated, ok = [], 0, base.tiled
                for i in full_pages[1:]:
                    p = tf.ifds[i]
                    smaller = (p.width < base.width
                               and p.height < base.height)
                    if p.tiled and smaller:
                        levels.append(i)
                    elif not p.tiled and smaller:
                        associated += 1    # thumbnail/label/macro
                    else:
                        # Equal-size page (tiled or stripped): a
                        # genuine Z section — no vendor layout here.
                        ok = False
                        break
                if ok and (levels or associated):
                    levels.sort(key=lambda i: -tf.ifds[i].width)
                    full_pages = [full_pages[0]]
                    self._page_levels = {full_pages[0]: levels}
            if spp > 1:
                self.size_c = spp
                self._interleaved_c = True
            self.size_z = max(1, len(full_pages))
            for zi, page in enumerate(full_pages):
                plane_map[(zi, 0, 0)] = (None, page)
        if self.pixels_type is None:
            if first.bits == 1:
                self.pixels_type = "bit"
            else:
                self.pixels_type = {
                    "uint8": "uint8", "uint16": "uint16",
                    "uint32": "uint32", "int8": "int8", "int16": "int16",
                    "int32": "int32", "float32": "float",
                    "float64": "double",
                }[np.dtype(first.dtype()).name]

        n_ifd_planes = self._n_ifd_planes()
        multi_file = any(k is not None for k, _ in plane_map.values())
        if not multi_file and len(tf.ifds) < n_ifd_planes:
            # Single-file: every declared plane must have an IFD here.
            # Multi-file sets validate lazily at read (sibling files
            # open on first touch).
            raise ValueError(
                f"{self.path}: {len(tf.ifds)} IFDs < {n_ifd_planes} "
                f"planes declared by OME metadata")
        if not plane_map:
            for i in range(n_ifd_planes):
                plane_map[self._plane_of_index(i)] = (None, i)
        self._plane_map = plane_map

        # Pyramid: SubIFD chain of each plane IFD (OME-TIFF 6.0), or the
        # reduced-resolution page chain for plain pyramidal TIFFs.
        # Level dims come from the first plane; every plane must agree.
        # Geometry anchors on plane (0,0,0)'s full-res IFD — for a
        # thumbnail-first plain TIFF that is NOT page 0 (multi-file
        # sets whose first plane lives elsewhere keep the primary
        # file's first page as the anchor; files are homogeneous).
        anchor_key, anchor_page = plane_map.get((0, 0, 0), (None, 0))
        self._first_ifd = (tf.ifds[anchor_page]
                           if anchor_key is None
                           and anchor_page < len(tf.ifds) else first)
        first_levels = self._page_levels.get(anchor_page, []) \
            if anchor_key is None else []
        if first_levels:
            level_ifds = [tf.ifds[i] for i in first_levels]
        else:
            level_ifds = tf.sub_ifds(self._first_ifd)
        self._n_levels = 1 + len(level_ifds)
        self._level_dims: List[Tuple[int, int]] = [
            (self._first_ifd.width, self._first_ifd.height)
        ] + [(s.width, s.height) for s in level_ifds]
        self._level_ifds: Dict[Tuple[Optional[str], int, int], Ifd] = {}

    def _n_ifd_planes(self) -> int:
        """Planes that occupy their own IFD (interleaved C shares one)."""
        return (self.size_z * self.size_t if self._interleaved_c
                else self.size_z * self.size_c * self.size_t)

    def _order_dims(self):
        sizes = {"Z": self.size_z, "C": self.size_c, "T": self.size_t}
        if self._interleaved_c:
            sizes = {"Z": self.size_z, "C": 1, "T": self.size_t}
        return [(d, sizes[d]) for d in self.dimension_order[2:]]

    def _plane_of_index(self, i: int) -> Tuple[int, int, int]:
        coords = {"Z": 0, "C": 0, "T": 0}
        for dim, size in self._order_dims():
            coords[dim] = i % size
            i //= size
        return coords["Z"], coords["C"], coords["T"]

    def _advance(self, z: int, c: int, t: int, k: int
                 ) -> Tuple[int, int, int]:
        """plane (z,c,t) advanced k steps in DimensionOrder."""
        coords = {"Z": z, "C": c, "T": t}
        idx = 0
        mult = 1
        for dim, size in self._order_dims():
            idx += coords[dim] * mult
            mult *= size
        idx += k
        return self._plane_of_index(idx)

    def _ifd_for(self, z: int, c: int, t: int, level: int
                 ) -> Tuple[TiffFile, Ifd]:
        key_c = 0 if self._interleaved_c else c
        try:
            file_key, page = self._plane_map[(z, key_c, t)]
        except KeyError:
            raise ValueError(
                f"{self.path}: no IFD for plane z={z} c={c} t={t}")
        tf = self._file(file_key)
        if page >= len(tf.ifds):
            raise ValueError(
                f"{self.path}: plane z={z} c={c} t={t} maps to IFD "
                f"{page} but {file_key or 'this file'} has only "
                f"{len(tf.ifds)}")
        key = (file_key, page, level)
        ifd = self._level_ifds.get(key)
        if ifd is None:
            base = tf.ifds[page]
            if level == 0:
                ifd = base
            else:
                page_levels = (self._page_levels.get(page, [])
                               if file_key is None else [])
                levels = ([tf.ifds[i] for i in page_levels]
                          if page_levels else tf.sub_ifds(base))
                if level - 1 >= len(levels):
                    raise ValueError(
                        f"{self.path}: page {page} has no level "
                        f"{level}")
                ifd = levels[level - 1]
            with self._lock:
                self._level_ifds[key] = ifd
        return tf, ifd

    # ----------------------------------------------------------- protocol

    @property
    def dtype(self) -> np.dtype:
        return self._first_ifd.dtype()

    def resolution_levels(self) -> int:
        return self._n_levels

    def resolution_descriptions(self) -> List[Tuple[int, int]]:
        return list(self._level_dims)

    def tile_size(self) -> Tuple[int, int]:
        ifd = self._first_ifd
        if not ifd.tiled:
            # Strips: serve a square default rather than a width x rows
            # sliver (the reference's server-side tile-size default,
            # ``ImageRegionRequestHandler.java:797``).
            return (min(1024, ifd.width), min(1024, ifd.height))
        seg_h, seg_w, _, _ = self._tf.segment_grid(ifd)
        return (seg_w, seg_h)

    def _segment(self, tf: TiffFile, ifd: Ifd, page_key: tuple,
                 gy: int, gx: int) -> np.ndarray:
        key = (page_key, gy, gx)
        with self._lock:
            seg = self._seg_cache.get(key)
            if seg is not None:
                self._seg_cache.move_to_end(key)
                return seg
        seg = tf.read_segment(ifd, gy, gx)
        with self._lock:
            if key not in self._seg_cache:
                self._seg_cache[key] = seg
                self._seg_cache_bytes += seg.nbytes
                while self._seg_cache_bytes > _SEG_CACHE_BYTES:
                    _, old = self._seg_cache.popitem(last=False)
                    self._seg_cache_bytes -= old.nbytes
        return seg

    def get_region(self, z: int, c: int, t: int, region: RegionDef,
                   level: int = 0, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        sx, sy = self._level_dims[level]
        x0, y0 = region.x, region.y
        x1, y1 = x0 + region.width, y0 + region.height
        if not (0 <= x0 <= x1 <= sx and 0 <= y0 <= y1 <= sy):
            raise ValueError(
                f"region {region.as_tuple()} outside level {level} "
                f"bounds ({sx}x{sy})")
        tf, ifd = self._ifd_for(z, c, t, level)
        seg_h, seg_w, grid_y, grid_x = tf.segment_grid(ifd)
        sample = c if self._interleaved_c else 0
        if out is None:
            out = np.empty((region.height, region.width), dtype=self.dtype)
        page_key = (z, 0 if self._interleaved_c else c, t, level)
        spans = []
        for gy in range(y0 // seg_h, min(grid_y, -(-y1 // seg_h))):
            for gx in range(x0 // seg_w, min(grid_x, -(-x1 // seg_w))):
                cy0, cx0 = gy * seg_h, gx * seg_w
                ix0, ix1 = max(x0, cx0), min(x1, cx0 + seg_w)
                iy0, iy1 = max(y0, cy0), min(y1, cy0 + seg_h)
                if ix0 >= ix1 or iy0 >= iy1:
                    continue
                spans.append((gy, gx, cy0, cx0, iy0, iy1, ix0, ix1))

        def fill(span) -> None:
            gy, gx, cy0, cx0, iy0, iy1, ix0, ix1 = span
            seg = self._segment(tf, ifd, page_key, gy, gx)
            out[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = \
                seg[iy0 - cy0:iy1 - cy0, ix0 - cx0:ix1 - cx0, sample]

        # Multi-segment regions decode concurrently on the shared pool
        # (disjoint output slices; the native decoders release the GIL,
        # so preads and entropy decode overlap even single-core — the
        # cold first-touch path was serialized here).  Single-segment
        # reads (the common warm tile) stay inline.
        if len(spans) > 1:
            list(_decode_pool().map(fill, spans))
        else:
            for span in spans:
                fill(span)
        return out

    def get_stack(self, c: int, t: int) -> np.ndarray:
        sx, sy = self._level_dims[0]
        region = RegionDef(0, 0, sx, sy)
        out = np.empty((self.size_z, sy, sx), dtype=self.dtype)
        for z in range(self.size_z):
            self.get_region(z, c, t, region, 0, out=out[z])
        return out

    def close(self) -> None:
        with self._lock:
            self._seg_cache.clear()
            self._seg_cache_bytes = 0
            files = list(self._files.values())
        for tf in files:
            tf.close()            # idempotent (file.close() is)

    def __del__(self):  # pragma: no cover - GC timing
        # The PixelsService LRU drops evicted sources WITHOUT closing
        # them (an in-flight request may still be reading); the last
        # reference closes the file handles here.
        try:
            for tf in self._files.values():
                tf.close()
        except Exception:
            pass


_TIFF_RE = re.compile(r"\.(ome\.)?tiff?$", re.IGNORECASE)


def find_tiff(image_dir: str) -> Optional[str]:
    """The image directory's TIFF file, if it holds one (sniffing seam
    used by ``PixelsService`` and ``LocalMetadataService``)."""
    import os
    if not os.path.isdir(image_dir):
        return None
    names = sorted(n for n in os.listdir(image_dir) if _TIFF_RE.search(n))
    # Prefer .ome.tif(f) over plain .tif(f) when both are present.
    for name in names:
        if ".ome." in name.lower():
            return os.path.join(image_dir, name)
    return os.path.join(image_dir, names[0]) if names else None
