"""Minimal TIFF container reader (classic + BigTIFF).

The port's copy of the JAX package's ``io/tiff.py``: the format layer under
:class:`.ometiff.OmeTiffSource`, the capability the reference gets from
Bio-Formats behind ``PixelsService.getPixelBuffer``
(``ImageRegionRequestHandler.java:302-309``, memoizer bean
``beanRefContext.xml:19-21``).  The container is parsed directly (no TIFF
library is a dependency); scope is exactly what serving needs:

- classic (magic 42) and BigTIFF (magic 43), both byte orders;
- tiled (322/323/324/325) and stripped (273/278/279) image data;
- compression: none (1), old-style JPEG (6, interchange-format layout),
  LZW (5), new-style JPEG (7, baseline; tables from tag 347, via
  ``io/jpegdec``), deflate (8 / 32946), PackBits (32773), Aperio
  JPEG 2000 (33003 YCbCr, 33005 RGB; ``io/jp2k``);
- predictors (317): horizontal differencing (2) and floating-point
  byte differencing (3, TIFF TechNote 3); unknown ids reject loudly;
- SubIFD chains (330) — OME-TIFF 6.0 stores pyramid levels there;
- sample types: u8/u16/u32, i8/i16/i32, f32/f64 via 258/339.

Everything is read lazily with ``pread``-style slices off one file
handle; decoded segments are cached by the caller, not here.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# TIFF tag ids (TIFF 6.0 spec; names per the spec).
NEW_SUBFILE_TYPE = 254      # bit 0 = reduced-resolution page
IMAGE_WIDTH = 256
IMAGE_LENGTH = 257
BITS_PER_SAMPLE = 258
COMPRESSION = 259
PHOTOMETRIC = 262
IMAGE_DESCRIPTION = 270
STRIP_OFFSETS = 273
SAMPLES_PER_PIXEL = 277
ROWS_PER_STRIP = 278
STRIP_BYTE_COUNTS = 279
PLANAR_CONFIG = 284
PREDICTOR = 317
TILE_WIDTH = 322
TILE_LENGTH = 323
TILE_OFFSETS = 324
TILE_BYTE_COUNTS = 325
SUB_IFDS = 330
SAMPLE_FORMAT = 339
JPEG_TABLES = 347
JPEG_INTERCHANGE = 513          # old-style JPEG (compression 6)
JPEG_INTERCHANGE_LEN = 514

# field type -> (struct code, byte size); struct code None = opaque bytes
_TYPES: Dict[int, Tuple[Optional[str], int]] = {
    1: ("B", 1),    # BYTE
    2: (None, 1),   # ASCII
    3: ("H", 2),    # SHORT
    4: ("I", 4),    # LONG
    5: (None, 8),   # RATIONAL
    6: ("b", 1),    # SBYTE
    7: (None, 1),   # UNDEFINED
    8: ("h", 2),    # SSHORT
    9: ("i", 4),    # SLONG
    10: (None, 8),  # SRATIONAL
    11: ("f", 4),   # FLOAT
    12: ("d", 8),   # DOUBLE
    13: ("I", 4),   # IFD
    16: ("Q", 8),   # LONG8 (BigTIFF)
    17: ("q", 8),   # SLONG8
    18: ("Q", 8),   # IFD8
}


# (BitsPerSample, SampleFormat) -> numpy dtype — the storage dtypes
# this reader can stage.  (1, 1) is 1-bit bilevel (OME "bit", the
# ShapeMask raster class; ome.util.PixelData's 1-bit accessor is the
# reference analogue, ShapeMaskRequestHandler.java:214-221): stored
# packed MSB-first, exposed expanded as uint8 0/1.
_SAMPLE_DTYPES = {
    (1, 1): "u1",
    (8, 1): "u1", (16, 1): "u2", (32, 1): "u4",
    # 12-bit: the standard declaration for 12-bit JPEG-in-TIFF
    # microscopy exports; decoded samples are served as uint16.
    (12, 1): "u2",
    (8, 2): "i1", (16, 2): "i2", (32, 2): "i4",
    (32, 3): "f4", (64, 3): "f8",
}

# The same domain by dtype name: the storage dtypes a configured spec may
# name (server.prewarm).
STORAGE_DTYPE_NAMES = tuple(sorted(
    {np.dtype(v).name for v in _SAMPLE_DTYPES.values()}))

@dataclass
class Ifd:
    """One decoded image file directory."""

    offset: int
    tags: Dict[int, tuple] = field(default_factory=dict)
    # Source label for error messages (the module's convention prefixes
    # every reader error with the file path).
    path: str = ""

    def get(self, tag: int, default=None):
        v = self.tags.get(tag)
        return v if v is not None else default

    _REQUIRED = object()

    def one(self, tag: int, default=_REQUIRED):
        v = self.tags.get(tag)
        if v is None:
            if default is Ifd._REQUIRED:
                # Hostile/corrupt files can omit any tag; a clean parse
                # error (not a TypeError from int(None) downstream) is
                # the error contract.
                where = f"{self.path}: " if self.path else ""
                raise ValueError(
                    f"{where}missing required TIFF tag {tag}")
            return default
        return v[0] if isinstance(v, tuple) else v

    @property
    def width(self) -> int:
        return int(self.one(IMAGE_WIDTH))

    @property
    def height(self) -> int:
        return int(self.one(IMAGE_LENGTH))

    @property
    def tiled(self) -> bool:
        return TILE_OFFSETS in self.tags

    @property
    def bits(self) -> int:
        # TIFF 6.0: BitsPerSample DEFAULTS TO 1 (bilevel files omit the
        # tag — PIL mode-"1" output does exactly this).
        return int(self.one(BITS_PER_SAMPLE, 1))

    def dtype(self) -> np.dtype:
        key = (self.bits, int(self.one(SAMPLE_FORMAT, 1)))
        if key not in _SAMPLE_DTYPES:
            raise ValueError(f"unsupported TIFF sample: {key[0]}-bit "
                             f"format {key[1]}")
        if self.bits == 12 and int(self.one(COMPRESSION, 1)) not in (6,
                                                                     7):
            # Only the JPEG codecs deliver decoded uint16 samples for
            # 12-bit declarations; packed 12-bit raw/LZW/deflate rows
            # (1.5 bytes/sample) are not unpacked here.
            raise ValueError(
                f"unsupported TIFF sample: 12-bit outside "
                f"JPEG-compressed files (compression "
                f"{int(self.one(COMPRESSION, 1))})")
        return np.dtype(_SAMPLE_DTYPES[key])


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early code-size change).

    TIFF 6.0 section 13: codes start at 9 bits, ClearCode=256, EOI=257;
    the code width bumps one entry EARLY (at table sizes 511/1023/2047).
    """
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    code_bits = 9
    buf = 0
    nbits = 0
    prev: Optional[bytes] = None
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= code_bits:
            nbits -= code_bits
            code = (buf >> nbits) & ((1 << code_bits) - 1)
            if code == 256:          # ClearCode
                table = table[:258]
                code_bits = 9
                prev = None
                continue
            if code == 257:          # EOI
                return bytes(out)
            if prev is None:
                if code >= len(table):
                    raise ValueError(
                        "corrupt LZW stream: code out of range")
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):  # the only legal KwKwK case
                entry = prev + prev[:1]
                table.append(entry)
            else:
                # Matching the native decoder's strictness: any code
                # beyond next-table-entry is a corrupt stream, not KwKwK.
                raise ValueError("corrupt LZW stream: code out of range")
            out += entry
            prev = entry
            if len(table) >= (1 << code_bits) - 1 and code_bits < 12:
                code_bits += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:                  # literal run of h+1 bytes
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:                # repeat next byte 257-h times
            out += data[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out)


def decode_segment(data: bytes, compression: int,
                   expected_bytes: "int | None" = None) -> bytes:
    if compression == 1:
        return data
    if compression in (8, 32946):    # Adobe deflate / old deflate
        try:
            return zlib.decompress(data)
        except zlib.error as e:
            # One error contract across codecs: corrupt streams raise
            # ValueError here like the LZW/PackBits paths do, not a
            # bare zlib.error.
            raise ValueError(f"corrupt deflate segment: {e}") from e
    if compression == 5:
        # Native LZW first (the Python decoder runs ~1 MB/s, too slow for
        # cold pans over LZW OME-TIFF exports); expected_bytes bounds its
        # output buffer.  A stream it refuses (malformed, or longer than
        # the segment) goes to the Python decoder, as in the JAX package.
        if expected_bytes is not None:
            from ..native import tiff_lzw_decode
            try:
                return tiff_lzw_decode(data, expected_bytes)
            except ValueError:
                pass
        return _lzw_decode(data)
    if compression == 32773:
        return _packbits_decode(data)
    if compression == 6:
        # Array-path codec (interchange-format layout only); handled
        # in read_segment, never through this bytes-level API.
        raise ValueError(
            "old-style JPEG segments (compression 6) decode via "
            "read_segment, not decode_segment")
    if compression in (33003, 33005):
        # Array-path codec: handled in read_segment (io/jp2k.py), never
        # through this bytes-level API.
        raise ValueError(
            f"JPEG 2000 segments (compression {compression}) decode "
            f"via read_segment, not decode_segment")
    raise ValueError(f"unsupported TIFF compression {compression}")


def _undo_predictor(rows: np.ndarray) -> np.ndarray:
    """Predictor 2 = horizontal differencing on [h, w, spp] samples.

    cumsum in the storage width wraps exactly like the encoder's
    subtraction did (modular arithmetic), so no widening is needed.
    """
    return np.cumsum(rows, axis=1, dtype=rows.dtype)


def _undo_float_predictor(data: bytes, seg_h: int, seg_w: int, spp: int,
                          dt: np.dtype) -> np.ndarray:
    """Predictor 3 = floating-point horizontal differencing (TIFF
    Technical Note 3; GDAL/ImageJ float exports).

    Per row the encoder splits each value into its bytes, regroups them
    byte-plane-major — ALL most-significant bytes first, regardless of
    the file's byte order — then byte-wise horizontally differences the
    whole row.  Undo: uint8 cumsum along the row (wrapping, mirroring
    the encoder's modular subtraction), de-interleave the byte planes,
    and view the reassembled per-value bytes big-endian.
    """
    n = seg_w * spp
    rows = np.frombuffer(data, np.uint8,
                         count=seg_h * n * dt.itemsize).reshape(
        seg_h, n * dt.itemsize)
    # The encoder (libtiff fpDiff) differences the reorganized row's
    # bytes in stride-spp chains — per-sample chains, continuing across
    # the byte-plane boundaries — so the undo accumulates the same way.
    rows = rows.reshape(seg_h, -1, spp).cumsum(
        axis=1, dtype=np.uint8).reshape(seg_h, n * dt.itemsize)
    planes = rows.reshape(seg_h, dt.itemsize, n)
    be = np.ascontiguousarray(planes.transpose(0, 2, 1))
    arr = be.reshape(seg_h, n * dt.itemsize).view(dt.newbyteorder(">"))
    return np.ascontiguousarray(
        arr.astype(dt.newbyteorder("="), copy=False)).reshape(
        seg_h, seg_w, spp)


class TiffFile:
    """Lazy random-access reader over one TIFF file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        # Parsed-JPEGTables memo (keyed by the tag's bytes object):
        # every tile of an IFD shares one tag-347 stream, so the Huffman
        # lookup tables build once per file, not once per tile.
        self._jpeg_tables_cache: Dict[bytes, object] = {}
        # Decoded whole-image memo for old-style JPEG IFDs (keyed by
        # IFD offset); see _old_jpeg_image.
        self._old_jpeg_cache: Dict[int, np.ndarray] = {}
        try:
            self._parse_header_and_ifds(path)
        except BaseException:
            # Any parse failure must not leak the fd (servers probe
            # hostile files; GC-timed closes exhaust descriptors).
            self._f.close()
            raise

    def _parse_header_and_ifds(self, path: str) -> None:
        head = self._f.read(16)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated TIFF header")
        if head[:2] == b"II":
            self.endian = "<"
        elif head[:2] == b"MM":
            self.endian = ">"
        else:
            raise ValueError(f"{path}: not a TIFF (no II/MM header)")
        magic = struct.unpack(self.endian + "H", head[2:4])[0]
        if magic == 42:
            self.big = False
            first = struct.unpack(self.endian + "I", head[4:8])[0]
        elif magic == 43:
            self.big = True
            offsize, _pad = struct.unpack(self.endian + "HH", head[4:8])
            if offsize != 8:
                raise ValueError(f"{path}: BigTIFF offset size {offsize}")
            if len(head) < 16:
                raise ValueError(f"{path}: truncated BigTIFF header")
            first = struct.unpack(self.endian + "Q", head[8:16])[0]
        else:
            raise ValueError(f"{path}: bad TIFF magic {magic}")
        self.ifds: List[Ifd] = []
        seen = set()
        off = first
        while off and off not in seen:
            seen.add(off)
            ifd, off = self._read_ifd(off)
            self.ifds.append(ifd)
        if not self.ifds:
            # TIFF 6.0 requires at least one IFD; a zeroed first-IFD
            # offset otherwise surfaces later as IndexError from
            # ifds[0] (fuzz-found escape of the error contract).
            raise ValueError(f"{path}: TIFF has no IFDs")

    # ------------------------------------------------------------ low level

    def _pread(self, offset: int, size: int) -> bytes:
        # os.pread, not seek+read: one TiffFile is shared by concurrent
        # render worker threads, and interleaved seeks on a single file
        # object would silently corrupt both readers' tiles.  pread is
        # positional and atomic per call.
        if not 0 <= offset < (1 << 63):
            # A corrupt 64-bit offset would raise OverflowError from the
            # C off_t conversion — keep the clean-failure contract.
            raise ValueError(f"{self.path}: bad file offset {offset}")
        data = os.pread(self._f.fileno(), size, offset)
        if len(data) != size:
            raise EOFError(f"{self.path}: short read at {offset}")
        return data

    def _read_ifd(self, offset: int) -> Tuple[Ifd, int]:
        e = self.endian
        if self.big:
            count = struct.unpack(e + "Q", self._pread(offset, 8))[0]
            entry_size, count_size, next_fmt = 20, 8, "Q"
        else:
            count = struct.unpack(e + "H", self._pread(offset, 2))[0]
            entry_size, count_size, next_fmt = 12, 2, "I"
        if count > 65536:
            # Hostile/corrupt count fields must not drive allocations.
            raise ValueError(f"{self.path}: IFD at {offset} claims "
                             f"{count} entries")
        next_size = 8 if self.big else 4
        raw = self._pread(offset + count_size,
                          count * entry_size + next_size)
        ifd = Ifd(offset=offset, path=self.path)
        for i in range(count):
            ent = raw[i * entry_size:(i + 1) * entry_size]
            tag, ftype = struct.unpack(e + "HH", ent[:4])
            if ftype not in _TYPES:
                continue
            code, size = _TYPES[ftype]
            if self.big:
                n = struct.unpack(e + "Q", ent[4:12])[0]
                inline = ent[12:20]
                inline_cap = 8
            else:
                n = struct.unpack(e + "I", ent[4:8])[0]
                inline = ent[8:12]
                inline_cap = 4
            nbytes = n * size
            if nbytes > (1 << 28):
                # 256 MB of tag data (offset/count arrays for huge
                # BigTIFF grids stay far below this) — corrupt counts
                # must not drive allocations.
                raise ValueError(f"{self.path}: tag {tag} claims "
                                 f"{nbytes} bytes")
            if nbytes <= inline_cap:
                data = inline[:nbytes]
            else:
                src_off = struct.unpack(
                    e + ("Q" if self.big else "I"),
                    inline[:inline_cap])[0]
                data = self._pread(src_off, nbytes)
            if ftype == 2:
                ifd.tags[tag] = data.split(b"\0")[0].decode(
                    "utf-8", "replace")
            elif code is None:
                ifd.tags[tag] = data
            else:
                ifd.tags[tag] = struct.unpack(e + code * n, data)
        next_off = struct.unpack(
            e + next_fmt,
            raw[count * entry_size:count * entry_size + next_size])[0]
        return ifd, next_off

    # ----------------------------------------------------------- segments

    def sub_ifds(self, ifd: Ifd) -> List[Ifd]:
        """Decode the SubIFD chain (tag 330) — OME-TIFF pyramid levels."""
        offs = ifd.get(SUB_IFDS)
        if not offs:
            return []
        subs = []
        for off in offs:
            sub, _next = self._read_ifd(int(off))
            subs.append(sub)
        return subs

    def segment_grid(self, ifd: Ifd) -> Tuple[int, int, int, int]:
        """(seg_h, seg_w, grid_y, grid_x) for tiles or strips."""
        if ifd.tiled:
            tw = int(ifd.one(TILE_WIDTH))
            th = int(ifd.one(TILE_LENGTH))
            return th, tw, -(-ifd.height // th), -(-ifd.width // tw)
        rps = int(ifd.one(ROWS_PER_STRIP, ifd.height))
        return min(rps, ifd.height), ifd.width, -(-ifd.height // rps), 1

    @staticmethod
    def _check_frame(img: np.ndarray, seg_h: int, seg_w: int, spp: int,
                     tiled: bool, path: str, codec: str) -> int:
        """Shared frame-vs-segment contract for the array codec (the JPEG
        variants): the decoded frame must cover the segment
        width (and height, for tiles); only the last strip's height may
        run short.  Returns the (possibly shortened) segment height."""
        if img.shape[1] < seg_w or (tiled and img.shape[0] < seg_h):
            raise ValueError(
                f"{path}: {codec} frame {img.shape[:2]} smaller than "
                f"segment {seg_h}x{seg_w}")
        if img.shape[-1] != spp:
            raise ValueError(
                f"{path}: {codec} components {img.shape[-1]} != "
                f"samples per pixel {spp}")
        return seg_h if tiled else min(seg_h, img.shape[0])

    def _read_old_jpeg_segment(self, ifd: Ifd, gy: int, seg_h: int,
                               seg_w: int, spp: int) -> np.ndarray:
        """Old-style JPEG (compression 6), interchange-format layout:
        tags 513/514 point at ONE complete JFIF stream for the whole
        image (real files often omit or garbage the 273/279 tags, so
        this path never touches them).  The deprecated per-strip tables
        variants stay rejected."""
        if ifd.tiled:
            raise ValueError(
                f"{self.path}: tiled old-style JPEG is not supported")
        off = ifd.one(JPEG_INTERCHANGE, None)
        if off is None:
            raise ValueError(
                f"{self.path}: old-style JPEG (compression 6) without "
                f"JPEGInterchangeFormat is not supported — re-export "
                f"with new-style JPEG (7)")
        img = self._old_jpeg_image(ifd, int(off))
        # The one stream must cover the declared geometry.
        if img.shape[1] < ifd.width or img.shape[0] < ifd.height:
            raise ValueError(
                f"{self.path}: JPEG frame {img.shape[:2]} smaller "
                f"than declared {ifd.height}x{ifd.width}")
        seg_h = self._check_frame(img, seg_h, seg_w, spp, False,
                                  self.path, "JPEG")
        # Slice this strip (seg_h was already shortened for the last
        # strip, so the row origin uses the nominal rows-per-strip).
        rps = min(int(ifd.one(ROWS_PER_STRIP, ifd.height)), ifd.height)
        y0 = gy * rps
        return np.ascontiguousarray(img[y0:y0 + seg_h, :seg_w])

    def _read_jpeg_segment(self, ifd: Ifd, raw: bytes, seg_h: int,
                           seg_w: int, spp: int) -> np.ndarray:
        """New-style JPEG-in-TIFF (compression 7, the SVS/WSI
        vendor-pyramid class).  The abbreviated per-segment stream
        carries its tables in tag 347; photometric 6 stores YCbCr and
        converts to RGB."""
        from .jpegdec import decode_tiff_jpeg
        tables = ifd.get(JPEG_TABLES)
        img = decode_tiff_jpeg(
            raw, bytes(tables) if tables else None,
            int(ifd.one(PHOTOMETRIC, 1)),
            tables_cache=self._jpeg_tables_cache)
        seg_h = self._check_frame(img, seg_h, seg_w, spp, ifd.tiled,
                                  self.path, "JPEG")
        self._check_jpeg_depth(ifd, img)
        dt = ifd.dtype()
        return np.ascontiguousarray(
            img[:seg_h, :seg_w].astype(dt.newbyteorder("="),
                                       copy=False))

    def _read_jp2k_segment(self, ifd: Ifd, raw: bytes, comp: int,
                           seg_h: int, seg_w: int, spp: int,
                           dt: np.dtype) -> np.ndarray:
        """Aperio JPEG 2000 tiles (raw J2K codestreams; 33003 = YCbCr
        planes, 33005 = RGB), which Bio-Formats reads behind
        getPixelBuffer; tier-1 runs in the native decoder."""
        from .jp2k import decode_tiff_jp2k
        img = decode_tiff_jp2k(raw, comp, int(ifd.one(PHOTOMETRIC, 1)))
        seg_h = self._check_frame(img, seg_h, seg_w, spp, ifd.tiled,
                                  self.path, "JPEG2000")
        if img.dtype.itemsize > dt.itemsize:
            # A deeper codestream cast down would wrap mod 2^bits: a
            # declaration mismatch fails instead of corrupting pixels.
            raise ValueError(
                f"{self.path}: JPEG2000 sample depth "
                f"{img.dtype.itemsize * 8} exceeds declared "
                f"{dt.itemsize * 8}-bit samples")
        return np.ascontiguousarray(
            img[:seg_h, :seg_w].astype(dt.newbyteorder("=")))

    def _check_jpeg_depth(self, ifd: Ifd, img: np.ndarray) -> None:
        """Decoded-vs-declared sample depth must MATCH, both ways: a
        12-bit stream under an 8-bit declaration cast down would wrap
        mod 256, and an 8-bit stream under a 12-bit declaration upcast
        would render ~16x dark against the declared range — either
        mismatch serves wrong pixels, so both fail loudly; shared by the
        compression-6 and -7 paths."""
        if img.dtype.itemsize != ifd.dtype().itemsize:
            raise ValueError(
                f"{self.path}: JPEG sample depth "
                f"{img.dtype.itemsize * 8} does not match declared "
                f"{ifd.bits}-bit samples")

    def _read_bilevel_segment(self, ifd: Ifd, raw: bytes, comp: int,
                              seg_h: int, seg_w: int,
                              spp: int) -> np.ndarray:
        """Packed bilevel rows: each row starts on a byte boundary.
        Expanded to uint8 0/1 with 1 = bright: WhiteIsZero files
        (photometric 0, the CCITT-era default) are inverted so the
        mask/render pipeline always sees set==foreground."""
        bpr = (seg_w * spp + 7) // 8
        data = decode_segment(raw, comp, seg_h * bpr)
        rows = np.frombuffer(data, np.uint8,
                             count=seg_h * bpr).reshape(seg_h, bpr)
        arr = np.unpackbits(rows, axis=1)[:, :seg_w * spp]
        if int(ifd.one(PHOTOMETRIC, 1)) == 0:
            arr = 1 - arr
        return np.ascontiguousarray(arr.reshape(seg_h, seg_w, spp))

    def read_segment(self, ifd: Ifd, gy: int, gx: int) -> np.ndarray:
        """Decode one tile/strip as [seg_h, seg_w, spp] in storage dtype.

        Edge tiles come back full-size (TIFF pads tiles); edge strips come
        back at their true height.
        """
        seg_h, seg_w, grid_y, grid_x = self.segment_grid(ifd)
        comp = int(ifd.one(COMPRESSION, 1))
        spp = int(ifd.one(SAMPLES_PER_PIXEL, 1))
        if spp > 1 and int(ifd.one(PLANAR_CONFIG, 1)) != 1:
            raise ValueError(
                f"{self.path}: unsupported planar configuration "
                f"{ifd.one(PLANAR_CONFIG)} (only chunky is supported)")
        if not ifd.tiled and gy == grid_y - 1:
            seg_h = ifd.height - gy * seg_h  # last strip may be short
        if comp == 6:
            # Handled BEFORE the strip-offset read: see
            # _read_old_jpeg_segment.
            return self._read_old_jpeg_segment(ifd, gy, seg_h, seg_w,
                                               spp)
        idx = gy * grid_x + gx
        offsets = ifd.get(TILE_OFFSETS if ifd.tiled else STRIP_OFFSETS)
        counts = ifd.get(TILE_BYTE_COUNTS if ifd.tiled
                         else STRIP_BYTE_COUNTS)
        if offsets is None or counts is None:
            raise ValueError(f"{self.path}: IFD lacks segment "
                             f"offset/byte-count tags")
        if idx >= len(offsets) or idx >= len(counts):
            raise ValueError(f"{self.path}: segment index {idx} beyond "
                             f"declared offsets ({len(offsets)})")
        raw = self._pread(int(offsets[idx]), int(counts[idx]))
        dt = ifd.dtype().newbyteorder(self.endian)
        if comp in (33003, 33005):
            return self._read_jp2k_segment(ifd, raw, comp, seg_h, seg_w,
                                           spp, dt)
        if comp == 7:
            return self._read_jpeg_segment(ifd, raw, seg_h, seg_w, spp)
        if ifd.bits == 1:
            if (BITS_PER_SAMPLE not in ifd.tags and comp == 1
                    and len(raw) == seg_h * seg_w * spp):
                # Spec says a missing BitsPerSample means 1-bit, but
                # sloppy 8-bit writers omit the tag too; uncompressed
                # data whose length matches the byte-per-sample layout
                # (a real bilevel strip is ~8x smaller) disambiguates.
                pass
            else:
                return self._read_bilevel_segment(ifd, raw, comp,
                                                  seg_h, seg_w, spp)
        data = decode_segment(raw, comp,
                              seg_h * seg_w * spp * dt.itemsize)
        predictor = int(ifd.one(PREDICTOR, 1))
        if predictor == 3:
            # Byte-level transform: must run BEFORE the dtype view.
            if dt.kind != "f":
                raise ValueError(
                    f"{self.path}: predictor 3 (floating point) on "
                    f"non-float samples ({dt})")
            return _undo_float_predictor(data, seg_h, seg_w, spp, dt)
        if predictor not in (1, 2):
            # An unrecognized predictor silently ignored would serve
            # garbage samples; reject loudly instead.
            raise ValueError(
                f"{self.path}: unsupported TIFF predictor {predictor}")
        arr = np.frombuffer(data, dtype=dt,
                            count=seg_h * seg_w * spp)
        arr = arr.reshape(seg_h, seg_w, spp)
        arr = np.ascontiguousarray(
            arr.astype(arr.dtype.newbyteorder("="), copy=False))
        if predictor == 2:
            arr = _undo_predictor(arr)
        return arr

    def _old_jpeg_image(self, ifd: Ifd, off: int) -> np.ndarray:
        """Decode (and memoize) the one interchange-format JFIF stream
        a compression-6 IFD holds: per-strip reads would otherwise pay
        a full-image decode EACH (an 8-row-strip scan would decode the
        same stream hundreds of times)."""
        from .jpegdec import decode_tiff_jpeg

        cached = self._old_jpeg_cache.get(ifd.offset)
        if cached is not None:
            return cached
        # Bounded: one decoded image at a time (reads are sequential
        # per IFD; an unbounded memo would pin every page's pixels for
        # the file's lifetime).
        self._old_jpeg_cache.clear()
        n = ifd.one(JPEG_INTERCHANGE_LEN, None)
        jf = self._pread(off, int(n) if n else
                         os.fstat(self._f.fileno()).st_size - off)
        img = decode_tiff_jpeg(jf, None, int(ifd.one(PHOTOMETRIC, 1)),
                               tables_cache=self._jpeg_tables_cache)
        self._check_jpeg_depth(ifd, img)
        self._old_jpeg_cache[ifd.offset] = img
        return img

    def close(self) -> None:
        self._f.close()
