"""Tiled OME-TIFF pyramid writer.

The port's copy of the JAX package's ``io/tiffwrite.py``: the ingest-side
counterpart of :class:`.ometiff.OmeTiffSource` (the export path
OMERO/Bio-Formats covers for the reference).  Writes [T, C, Z, H, W] arrays
as a tiled OME-TIFF with SubIFD pyramid levels (OME-TIFF 6.0), one IFD per
plane in DimensionOrder, OME-XML on the first IFD.  Used by
``ingest store-to-tiff``, ``chip_smoke.py`` and the tests; classic TIFF by
default, BigTIFF automatically once offsets could exceed 32 bits.

Only what the reader consumes is emitted: BlackIsZero photometric,
SamplesPerPixel=1, no predictor, compression none or deflate.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from .store import _downsample2

_ASCII = 2
_SHORT = 3
_LONG = 4
_LONG8 = 16

_CODES = {1: "B", _SHORT: "H", _LONG: "I", _LONG8: "Q"}
_SIZES = {1: 1, _ASCII: 1, _SHORT: 2, _LONG: 4, _LONG8: 8}

_DTYPE_FMT = {"u": 1, "i": 2, "f": 3}

_OME_TYPE = {
    "uint8": "uint8", "uint16": "uint16", "uint32": "uint32",
    "int8": "int8", "int16": "int16", "int32": "int32",
    "float32": "float", "float64": "double",
}


def _ome_xml(T: int, C: int, Z: int, H: int, W: int, dtype) -> str:
    ptype = _OME_TYPE[np.dtype(dtype).name]
    channels = "".join(
        f'<Channel ID="Channel:0:{c}" SamplesPerPixel="1"/>'
        for c in range(C))
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0"><Pixels ID="Pixels:0" '
        f'DimensionOrder="XYZCT" Type="{ptype}" Interleaved="false" '
        f'SizeX="{W}" SizeY="{H}" SizeZ="{Z}" SizeC="{C}" SizeT="{T}" '
        'BigEndian="false">'
        f'{channels}<TiffData/></Pixels></Image></OME>'
    )


class _TiffOut:
    """Sequential TIFF writer with IFD/next-pointer patching."""

    def __init__(self, f, big: bool):
        self.f = f
        self.big = big
        self.e = "<"
        f.write(b"II")
        if big:
            f.write(struct.pack("<HHHQ", 43, 8, 0, 0))
            self._first_ifd_patch = 8
        else:
            f.write(struct.pack("<HI", 42, 0))
            self._first_ifd_patch = 4

    def tell(self) -> int:
        return self.f.tell()

    def align(self) -> None:
        pos = self.f.tell()
        if pos % 2:
            self.f.write(b"\0")

    def write(self, data: bytes) -> int:
        off = self.f.tell()
        self.f.write(data)
        return off

    def patch(self, pos: int, value: int) -> None:
        cur = self.f.tell()
        self.f.seek(pos)
        self.f.write(struct.pack(self.e + ("Q" if self.big else "I"),
                                 value))
        self.f.seek(cur)

    def patch_first_ifd(self, off: int) -> None:
        self.patch(self._first_ifd_patch, off)

    def write_ifd(self, tags: List[Tuple[int, int, object]]
                  ) -> Tuple[int, int]:
        """Write one IFD; returns (ifd_offset, next_field_pos).

        ``tags`` is [(tag, type, values)]; values is bytes for ASCII or a
        sequence of ints otherwise.  The next-IFD pointer is written as
        0 for the caller to patch.
        """
        self.align()
        e = self.e
        tags = sorted(tags)
        if self.big:
            count_fmt, entry_n, off_fmt, inline_cap = "Q", 20, "Q", 8
        else:
            count_fmt, entry_n, off_fmt, inline_cap = "H", 12, "I", 4
        ifd_off = self.f.tell()
        n = len(tags)
        next_pos = (ifd_off + struct.calcsize(count_fmt)
                    + n * entry_n)
        overflow_off = next_pos + struct.calcsize(e + off_fmt)

        entries = b""
        overflow = b""
        for tag, ftype, values in tags:
            if ftype == _ASCII:
                data = bytes(values)
                if not data.endswith(b"\0"):
                    data += b"\0"
                count = len(data)
            else:
                seq = list(values)
                count = len(seq)
                data = struct.pack(e + _CODES[ftype] * count, *seq)
            ent = struct.pack(e + "HH", tag, ftype)
            ent += struct.pack(e + ("Q" if self.big else "I"), count)
            if len(data) <= inline_cap:
                ent += data + b"\0" * (inline_cap - len(data))
            else:
                pad = len(overflow) % 2
                overflow += b"\0" * pad
                ent += struct.pack(e + off_fmt,
                                   overflow_off + len(overflow))
                overflow += data
            entries += ent
        self.f.write(struct.pack(e + count_fmt, n))
        self.f.write(entries)
        self.f.write(struct.pack(e + off_fmt, 0))
        self.f.write(overflow)
        return ifd_off, next_pos


def _plane_levels(plane: np.ndarray, n_levels: Optional[int],
                  min_level_size: int) -> List[np.ndarray]:
    levels = [plane]
    while True:
        if n_levels is not None and len(levels) >= n_levels:
            break
        h, w = levels[-1].shape
        if n_levels is None and min(h // 2, w // 2) < min_level_size:
            break
        if min(h // 2, w // 2) < 1:
            break
        levels.append(_downsample2(levels[-1]))
    return levels


def _tile_bytes(plane: np.ndarray, th: int, tw: int, gy: int, gx: int,
                compression: str) -> bytes:
    tile = plane[gy * th:(gy + 1) * th, gx * tw:(gx + 1) * tw]
    if tile.shape != (th, tw):
        full = np.zeros((th, tw), dtype=plane.dtype)
        full[:tile.shape[0], :tile.shape[1]] = tile
        tile = full
    raw = np.ascontiguousarray(tile).tobytes()
    if compression == "deflate":
        return zlib.compress(raw, 6)
    return raw


def write_ome_tiff(
    planes: np.ndarray,
    path: str,
    tile: Tuple[int, int] = (256, 256),
    compression: str = "none",
    n_levels: Optional[int] = None,
    min_level_size: int = 256,
    bigtiff: Optional[bool] = None,
    description: Optional[str] = None,
) -> str:
    """Write [T, C, Z, H, W] (or [C, Z, H, W]) as a pyramidal OME-TIFF.

    ``description`` overrides the generated OME-XML — used to build
    multi-file sets (TiffData FileName entries / BinaryOnly stubs)."""
    if planes.ndim == 4:
        planes = planes[None]
    if planes.ndim != 5:
        raise ValueError("planes must be [T, C, Z, H, W] or [C, Z, H, W]")
    if compression not in ("none", "deflate"):
        raise ValueError(f"unsupported compression {compression!r}")
    T, C, Z, H, W = planes.shape
    tw, th = tile
    if bigtiff is None:
        bigtiff = planes.nbytes * 2 > (1 << 32) - (1 << 20)

    comp_code = 8 if compression == "deflate" else 1
    dt = planes.dtype
    bits = dt.itemsize * 8
    sfmt = _DTYPE_FMT[dt.kind]
    off_type = _LONG8 if bigtiff else _LONG
    ome = (description if description is not None
           else _ome_xml(T, C, Z, H, W, dt)).encode()

    with open(path, "wb") as f:
        out = _TiffOut(f, bigtiff)

        # Pass 1: all tile data, plane-major then level-major, recording
        # (offsets, counts, level_dims) per (plane_index, level).
        plane_seq = [(z, c, t) for t in range(T) for c in range(C)
                     for z in range(Z)]        # XYZCT: z fastest
        tiles_of = {}
        level_dims = None
        for p, (z, c, t) in enumerate(plane_seq):
            levels = _plane_levels(planes[t, c, z], n_levels,
                                   min_level_size)
            dims = [(lv.shape[1], lv.shape[0]) for lv in levels]
            if level_dims is None:
                level_dims = dims
            elif dims != level_dims:
                raise ValueError("planes produced inconsistent pyramids")
            for li, lv in enumerate(levels):
                h, w = lv.shape
                gy_n, gx_n = -(-h // th), -(-w // tw)
                offs, cnts = [], []
                for gy in range(gy_n):
                    for gx in range(gx_n):
                        data = _tile_bytes(lv, th, tw, gy, gx,
                                           compression)
                        out.align()
                        offs.append(out.write(data))
                        cnts.append(len(data))
                tiles_of[(p, li)] = (offs, cnts)

        n_levels_final = len(level_dims)

        def base_tags(w: int, h: int, offs, cnts):
            return [
                (256, _LONG, [w]), (257, _LONG, [h]),
                (258, _SHORT, [bits]), (259, _SHORT, [comp_code]),
                (262, _SHORT, [1]), (277, _SHORT, [1]),
                (284, _SHORT, [1]),
                (322, _LONG, [tw]), (323, _LONG, [th]),
                (324, off_type, offs), (325, off_type, cnts),
                (339, _SHORT, [sfmt]),
            ]

        # Pass 2: SubIFDs (levels >= 1) per plane, then the chained main
        # IFDs referencing them.
        sub_offsets = {}
        for p in range(len(plane_seq)):
            subs = []
            for li in range(1, n_levels_final):
                w, h = level_dims[li]
                offs, cnts = tiles_of[(p, li)]
                tags = base_tags(w, h, offs, cnts)
                tags.append((254, _LONG, [1]))   # reduced-resolution
                ifd_off, _next = out.write_ifd(tags)
                subs.append(ifd_off)
            sub_offsets[p] = subs

        prev_next_pos = None
        first_ifd = None
        for p in range(len(plane_seq)):
            w, h = level_dims[0]
            offs, cnts = tiles_of[(p, 0)]
            tags = base_tags(w, h, offs, cnts)
            if sub_offsets[p]:
                tags.append((330, off_type, sub_offsets[p]))
            if p == 0:
                tags.append((270, _ASCII, ome))
            ifd_off, next_pos = out.write_ifd(tags)
            if p == 0:
                first_ifd = ifd_off
            else:
                out.patch(prev_next_pos, ifd_off)
            prev_next_pos = next_pos
        out.patch_first_ifd(first_ifd)
    return path
