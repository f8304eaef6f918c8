"""Baseline and progressive JPEG decoder (ITU-T T.81) for JPEG-in-TIFF.

The port's copy of the JAX package's ``io/jpegdec.py``.  The reference
reads JPEG-compressed TIFF (compression 7: Aperio SVS, Hamamatsu exports,
most vendor WSI pyramids) through Bio-Formats behind
``PixelsService.getPixelBuffer`` (``build.gradle:81-83``).  PIL decodes
whole files, not the abbreviated per-tile streams TIFF stores, so the
decoder is implemented directly; scope is what TIFF serving needs:

- baseline sequential DCT (SOF0/1) and progressive DCT (SOF2);
- 8-bit samples, plus 12-bit extended/progressive frames decoding to
  uint16 (the precision-over-8 microscopy exports Bio-Formats reads);
- 1..4 components, sampling factors 1-2 (4:4:4, 4:2:2, 4:2:0);
- abbreviated streams: a ``JPEGTables`` (TIFF tag 347) stream carries
  DQT/DHT once, per-tile streams reference them (T.81 Annex B.5);
- restart markers (DRI/RSTn), inter-scan DHT/DQT/DRI updates.

Lossless JPEG (SOF3) and arithmetic-coded processes reject with errors
naming the variant.

The entropy decode is a tight Python loop over Huffman codes; the heavy
math (dequantize + IDCT + upsample + color transform) is vectorized
numpy over all blocks at once.  This module is the plain version of the
native decoder (``native.jpeg_decode_baseline``, ``native/jpegdec.cpp``):
:func:`decode_tiff_jpeg` sends 8-bit frames there and 12-bit frames here,
as the JAX package does.

Output is the raw decoded component array ``[h, w, ncomp]`` (uint8, or
uint16 for 12-bit frames); the YCbCr->RGB decision belongs to the TIFF
layer (photometric 6 converts, photometric 1/2 serve components as
stored).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# Zig-zag order: index i holds the (row-major) position of the i-th
# zig-zag coefficient (T.81 Figure A.6).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# 8x8 IDCT basis: spatial = M^T @ coeff @ M with M[u, x] scaled DCT-II.
_IDCT_M = np.array([
    [(np.sqrt(0.125) if u == 0 else 0.5)
     * np.cos((2 * x + 1) * u * np.pi / 16)
     for x in range(8)] for u in range(8)
], dtype=np.float32)


class JpegError(ValueError):
    """Malformed or unsupported JPEG stream."""


@dataclass
class _Huff:
    """Flat-lookup Huffman table: 16-bit left-aligned prefix -> (value,
    length).  Max code length is 16 bits, so one 64K table decodes any
    code in a single index — the loop stays in Python but each symbol
    is O(1)."""

    lookup_val: np.ndarray   # u8[65536]
    lookup_len: np.ndarray   # u8[65536]  (0 = invalid prefix)


def _build_huff(bits: bytes, values: bytes) -> _Huff:
    lookup_val = np.zeros(65536, np.uint8)
    lookup_len = np.zeros(65536, np.uint8)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if k >= len(values):
                raise JpegError("DHT: counts exceed values")
            aligned = code << (16 - length)
            span = 1 << (16 - length)
            if aligned + span > 65536:
                raise JpegError("DHT: code overflow")
            lookup_val[aligned:aligned + span] = values[k]
            lookup_len[aligned:aligned + span] = length
            code += 1
            k += 1
        code <<= 1
    return _Huff(lookup_val, lookup_len)


@dataclass
class _Component:
    ident: int
    h: int                  # horizontal sampling factor
    v: int                  # vertical sampling factor
    tq: int                 # quant table id
    td: int = 0             # DC huffman id (from SOS)
    ta: int = 0             # AC huffman id (from SOS)


class _TableSet:
    """Mutable DQT/DHT/DRI state, shared between a JPEGTables stream and
    the abbreviated tile stream that follows it (T.81 B.5)."""

    def __init__(self) -> None:
        self.quant: Dict[int, np.ndarray] = {}        # id -> i32[64] zigzag
        self.huff_dc: Dict[int, _Huff] = {}
        self.huff_ac: Dict[int, _Huff] = {}
        self.restart_interval = 0


class _BitReader:
    """MSB-first bit reader over entropy-coded data with 0xFF00
    unstuffing; marker bytes terminate the stream (pad with 1s)."""

    __slots__ = ("data", "pos", "buf", "nbits", "marker")

    def __init__(self, data: bytes, pos: int) -> None:
        self.data = data
        self.pos = pos
        self.buf = 0
        self.nbits = 0
        self.marker: Optional[int] = None

    def _fill(self) -> None:
        data = self.data
        while self.nbits <= 48:
            if self.marker is not None or self.pos >= len(data):
                # Past the end: feed 1-bits (T.81 F.2.2.5 padding); a
                # well-formed stream never consumes them into samples.
                self.buf = (self.buf << 8) | 0xFF
                self.nbits += 8
                continue
            b = data[self.pos]
            if b == 0xFF:
                nxt = data[self.pos + 1] if self.pos + 1 < len(data) else 0xD9
                if nxt == 0x00:
                    self.pos += 2
                elif 0xD0 <= nxt <= 0xD7:
                    # RST markers are consumed by restart(), not here.
                    self.marker = nxt
                    continue
                else:
                    self.marker = nxt
                    continue
            else:
                self.pos += 1
            self.buf = (self.buf << 8) | b
            self.nbits += 8

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill()
        return (self.buf >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n: int) -> None:
        self.nbits -= n
        self.buf &= (1 << self.nbits) - 1

    def receive(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        v = (self.buf >> (self.nbits - n)) & ((1 << n) - 1)
        self.skip(n)
        return v

    def restart(self) -> None:
        """Byte-align and consume one RSTn marker."""
        self.buf = 0
        self.nbits = 0
        if self.marker is not None and 0xD0 <= self.marker <= 0xD7:
            self.pos += 2
            self.marker = None
            return
        # Marker not yet reached in _fill: scan forward.
        data = self.data
        while self.pos + 1 < len(data):
            if data[self.pos] == 0xFF and 0xD0 <= data[self.pos + 1] <= 0xD7:
                self.pos += 2
                # A stale non-RST marker (spurious FFxx in corrupt
                # entropy data) must not make _fill pad the rest of the
                # image with 1-bits.
                self.marker = None
                return
            self.pos += 1
        raise JpegError("missing restart marker")


def _extend(v: int, t: int) -> int:
    """T.81 F.2.2.1 EXTEND: map t-bit magnitude to signed value."""
    return v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v


def _decode_huff(reader: _BitReader, table: _Huff) -> int:
    prefix = reader.peek16()
    length = int(table.lookup_len[prefix])
    if length == 0:
        raise JpegError("invalid huffman code")
    reader.skip(length)
    return int(table.lookup_val[prefix])


def _parse_segments(data: bytes, tables: _TableSet):
    """Walk marker segments until SOS (or EOI).  Returns
    (frame, first_scan, scan_start, progressive) — frame is None for a
    tables-only stream."""
    if len(data) < 2 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("no SOI")
    pos = 2
    frame: Optional[Tuple[int, int, List[_Component]]] = None
    progressive = False
    while pos + 2 <= len(data):
        if data[pos] != 0xFF:
            raise JpegError(f"expected marker at {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:               # EOI (tables-only stream)
            return frame, None, pos, progressive
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2                     # standalone marker, no length
            continue
        if pos + 4 > len(data):
            raise JpegError("truncated segment")
        seglen = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if seglen < 2 or pos + 2 + seglen > len(data):
            raise JpegError("truncated segment")
        body = data[pos + 4:pos + 2 + seglen]
        if marker == 0xDB:               # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 0xF
                i += 1
                if pq == 0:
                    q = np.frombuffer(body[i:i + 64], np.uint8)
                    i += 64
                else:
                    q = np.frombuffer(body[i:i + 128], ">u2")
                    i += 128
                if q.size != 64:
                    raise JpegError("truncated DQT")
                tables.quant[tq] = q.astype(np.int32)
        elif marker == 0xC4:             # DHT
            i = 0
            while i + 17 <= len(body):
                tc, th = body[i] >> 4, body[i] & 0xF
                bits = body[i + 1:i + 17]
                n = sum(bits)
                values = body[i + 17:i + 17 + n]
                if len(values) != n:
                    raise JpegError("truncated DHT")
                dst = tables.huff_dc if tc == 0 else tables.huff_ac
                dst[th] = _build_huff(bits, values)
                i += 17 + n
        elif marker == 0xDD:             # DRI
            if len(body) < 2:
                raise JpegError("truncated DRI")
            tables.restart_interval = struct.unpack(">H", body[:2])[0]
        elif marker in (0xC0, 0xC1, 0xC2):   # SOF0/1 baseline, SOF2 prog
            if len(body) < 6:
                raise JpegError("truncated SOF")
            precision = body[0]
            if marker == 0xC0 and precision != 8:
                # Baseline DCT is 8-bit by definition (T.81 4.11).
                raise JpegError(
                    f"unsupported sample precision {precision} "
                    f"for baseline SOF0 (8-bit only)")
            if precision not in (8, 12):
                # 16-bit precision exists only in lossless JPEG
                # (SOF3); DCT processes are 8/12-bit.  Decoding
                # anything else would serve silently saturated garbage.
                raise JpegError(
                    f"unsupported sample precision {precision} "
                    f"(8-bit and 12-bit extended/progressive only)")
            h, w = struct.unpack(">HH", body[1:5])
            ncomp = body[5]
            if not 1 <= ncomp <= 4 or len(body) < 6 + 3 * ncomp:
                raise JpegError("truncated SOF components")
            if h * w * ncomp > (1 << 28):
                # Hostile headers must not drive allocations (a TIFF
                # tile is orders of magnitude smaller).
                raise JpegError("frame exceeds the 256M-sample cap")
            comps = []
            for ci in range(ncomp):
                ident, hv, tq = body[6 + 3 * ci:9 + 3 * ci]
                comps.append(_Component(ident, hv >> 4, hv & 0xF, tq))
            for c in comps:
                if not (1 <= c.h <= 2 and 1 <= c.v <= 2):
                    raise JpegError(
                        f"unsupported sampling {c.h}x{c.v}")
            if h == 0 or w == 0:
                raise JpegError("zero frame dimension")
            frame = (h, w, comps, precision)
            progressive = marker == 0xC2
        elif marker == 0xC3:
            raise JpegError(
                "lossless JPEG (SOF3) is not supported")
        elif marker in (0xC5, 0xC6, 0xC7,
                        0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise JpegError(
                f"unsupported JPEG process (SOF{marker & 0xF})")
        elif marker == 0xDA:             # SOS
            if frame is None:
                raise JpegError("SOS before SOF")
            scan = _parse_sos_body(body, frame, progressive)
            return frame, scan, pos + 2 + seglen, progressive
        # APPn/COM/others: skipped.
        pos += 2 + seglen
    raise JpegError("no SOS/EOI")


def _parse_sos_body(body: bytes, frame, progressive: bool):
    """SOS body -> (selected components, Ss, Se, Ah, Al).

    Baseline keeps the one-interleaved-scan constraint; progressive
    scans may name any component subset (non-interleaved AC scans are
    mandatory there, T.81 G.1.1.1.1)."""
    if len(body) < 1:
        raise JpegError("truncated SOS")
    ns = body[0]
    if not 1 <= ns <= 4 or len(body) < 1 + 2 * ns + 3:
        raise JpegError("truncated SOS components")
    if not progressive and ns != len(frame[2]):
        # Non-interleaved multi-scan BASELINE files exist but this
        # decoder walks one interleaved scan; misparsing the entropy
        # stream would yield garbage, so fail loud.
        raise JpegError(
            "non-interleaved (multi-scan) sequential JPEG is not "
            "supported")
    sel = []
    for si in range(ns):
        cs, tdta = body[1 + 2 * si:3 + 2 * si]
        for c in frame[2]:
            if c.ident == cs:
                c.td, c.ta = tdta >> 4, tdta & 0xF
                sel.append(c)
                break
        else:
            raise JpegError(f"SOS names unknown component {cs}")
    ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 0xF
    if progressive:
        if ss > se or se > 63 or al > 13 or ah > 13:
            raise JpegError(f"bad spectral selection {ss}..{se}")
        if ss == 0 and se != 0:
            raise JpegError("progressive DC scan must have Se=0")
        if ss > 0 and len(sel) != 1:
            raise JpegError("progressive AC scan must be single-"
                            "component")
    return sel, ss, se, ah, al


def _jpeg_error_contract(fn):
    """Everything malformed must surface as :class:`JpegError` (a
    ValueError): these streams come from untrusted files, and server
    error mapping turns ValueError into a 4xx instead of a 500.  The
    explicit length checks cover the known shapes; this net catches any
    residual IndexError/struct.error/OverflowError from hostile input."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (IndexError, struct.error, OverflowError,
                MemoryError) as e:
            raise JpegError(f"malformed JPEG stream: {e}") from e
    return wrapped


@_jpeg_error_contract
def parse_jpeg_tables(tables_bytes: bytes) -> _TableSet:
    """Parse a TIFF ``JPEGTables`` (tag 347) abbreviated stream."""
    ts = _TableSet()
    _parse_segments(tables_bytes, ts)
    return ts


@_jpeg_error_contract
def decode_baseline_jpeg(data: bytes,
                         tables: Optional[_TableSet] = None
                         ) -> np.ndarray:
    """Decode one JPEG (baseline SOF0/1 or progressive SOF2, optionally
    abbreviated) to ``u8[h, w, ncomp]`` raw components (no color
    transform)."""
    ts = _TableSet()
    if tables is not None:
        ts.quant.update(tables.quant)
        ts.huff_dc.update(tables.huff_dc)
        ts.huff_ac.update(tables.huff_ac)
        ts.restart_interval = tables.restart_interval
    frame, scan, scan_start, progressive = _parse_segments(data, ts)
    if frame is None or scan is None:
        raise JpegError("stream has no frame/scan")
    h, w, comps, precision = frame
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))

    for c in comps:
        if c.tq not in ts.quant:
            raise JpegError(f"missing quant table {c.tq}")

    # Per-component coefficient grids [by, bx, 64] (zigzag order).
    grids = []
    for c in comps:
        grids.append(np.zeros((mcuy * c.v, mcux * c.h, 64), np.int32))

    if progressive:
        _decode_progressive_scans(data, ts, frame, grids, scan,
                                  scan_start, hmax, vmax, mcux, mcuy)
        return _reconstruct(frame, ts, grids, hmax, vmax)

    sel, ss, se, ah, al = scan
    for c in comps:
        if c.td not in ts.huff_dc or c.ta not in ts.huff_ac:
            raise JpegError("missing huffman table")

    reader = _BitReader(data, scan_start)
    preds = [0] * len(comps)
    ri = ts.restart_interval
    mcu_index = 0
    block = np.zeros(64, np.int32)
    for my in range(mcuy):
        for mx in range(mcux):
            if ri and mcu_index and mcu_index % ri == 0:
                reader.restart()
                preds = [0] * len(comps)
            mcu_index += 1
            for ci, c in enumerate(comps):
                dc_tbl = ts.huff_dc[c.td]
                ac_tbl = ts.huff_ac[c.ta]
                grid = grids[ci]
                for by in range(c.v):
                    for bx in range(c.h):
                        block[:] = 0
                        t = _decode_huff(reader, dc_tbl)
                        if t > 15:
                            # A corrupt DHT can map codes to arbitrary
                            # byte values; DCT DC categories stop at 15
                            # at BOTH 8- and 12-bit precision (SSSS 16
                            # exists only in lossless coding).
                            raise JpegError("bad DC category")
                        diff = _extend(reader.receive(t), t)
                        preds[ci] += diff
                        block[0] = preds[ci]
                        k = 1
                        while k < 64:
                            rs = _decode_huff(reader, ac_tbl)
                            r, s = rs >> 4, rs & 0xF
                            if s == 0:
                                if r == 15:
                                    k += 16       # ZRL
                                    continue
                                break             # EOB
                            k += r
                            if k > 63:
                                raise JpegError("AC run overflow")
                            block[k] = _extend(reader.receive(s), s)
                            k += 1
                        grid[my * c.v + by, mx * c.h + bx] = block
    if reader.marker not in (None, 0xD9):
        # Trailing RST is tolerated; anything else is malformed.
        if not (0xD0 <= (reader.marker or 0) <= 0xD7):
            raise JpegError(f"unexpected marker {reader.marker:#x}")
    return _reconstruct(frame, ts, grids, hmax, vmax)


def _reconstruct(frame, ts: _TableSet, grids, hmax: int,
                 vmax: int) -> np.ndarray:
    """Vectorized dequant + IDCT + level shift, per component.

    12-bit frames (extended sequential / progressive, T.81 Table B.2)
    level-shift by 2048 and serve uint16 planes — the
    precision-over-8 microscopy exports Bio-Formats reads."""
    h, w, comps, precision = frame
    shift = 1 << (precision - 1)
    top = (1 << precision) - 1
    dtype = np.uint8 if precision == 8 else np.uint16
    planes = []
    for c, grid in zip(comps, grids):
        q = ts.quant[c.tq]
        by, bx = grid.shape[:2]
        coeff = np.zeros((by, bx, 64), np.float32)
        coeff[..., ZIGZAG] = grid * q            # un-zigzag + dequant
        coeff = coeff.reshape(by, bx, 8, 8)
        spatial = np.einsum("ux,ybuv,vz->ybxz", _IDCT_M, coeff,
                            _IDCT_M, optimize=True)
        plane = spatial.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        plane = np.clip(np.round(plane) + shift, 0, top).astype(dtype)
        # Upsample to full MCU-grid resolution (pixel replication).
        if c.h < hmax:
            plane = np.repeat(plane, hmax // c.h, axis=1)
        if c.v < vmax:
            plane = np.repeat(plane, vmax // c.v, axis=0)
        planes.append(plane[:h, :w])
    return np.stack(planes, axis=-1)


# ---------------------------------------------------- progressive scans

# Bound on the scan count (T.81 allows many; real encoders emit ~10):
# hostile streams must not drive unbounded re-walks of the image.
_MAX_SCANS = 256

# FLOOR of the cumulative block-visit budget across ALL scans: every
# scan re-walks its band over the frame, so scan count alone is not a
# work bound — a tiny stream declaring a huge frame plus many scans
# (which decode "successfully" off the reader's 1-bit padding) would
# amplify far past the frame-size cap.  The effective budget scales
# with the DECLARED frame (``max(floor, 64 * blocks_per_frame)``, the
# rule the native decoder shares), so a deep scan script over a
# legitimately large frame decodes while amplification beyond ~64 full
# walks is rejected.
_MAX_BLOCK_VISITS = 1 << 23


class _ScanScript:
    """Successive-approximation succession state (T.81 G.1.1.1.1):
    tracks each coefficient's current approximation level so a
    malformed-but-parseable scan script raises instead of silently
    decoding garbage — an AC scan needs its component's DC first scan,
    a first scan per coefficient happens once, and a refinement's Ah
    must continue the band's Al (with Al = Ah - 1).  Identical rules in
    the native decoder (byte-parity contract)."""

    _NONE = -2

    def __init__(self, ncomp: int) -> None:
        self.dc_al = [self._NONE] * ncomp
        self.ac_al = [[self._NONE] * 64 for _ in range(ncomp)]

    def validate(self, comps, sel, ss, se, ah, al) -> None:
        if ss == 0:
            for c in sel:
                ci = comps.index(c)
                if ah == 0:
                    if self.dc_al[ci] != self._NONE:
                        raise JpegError("duplicate DC first scan")
                elif self.dc_al[ci] != ah or al != ah - 1:
                    raise JpegError(
                        f"DC refinement Ah={ah} does not continue "
                        f"Al={self.dc_al[ci]}")
                self.dc_al[ci] = al
            return
        ci = comps.index(sel[0])
        if self.dc_al[ci] == self._NONE:
            raise JpegError("AC scan before the component's DC scan")
        band = self.ac_al[ci]
        for k in range(ss, se + 1):
            if ah == 0:
                if band[k] != self._NONE:
                    raise JpegError("duplicate AC first scan")
            elif band[k] != ah or al != ah - 1:
                raise JpegError(
                    f"AC refinement Ah={ah} does not continue "
                    f"Al={band[k]}")
            band[k] = al


def _next_marker_pos(data: bytes, pos: int) -> int:
    """First non-RST, non-stuffing marker at/after ``pos`` (the segment
    stream between progressive scans)."""
    while pos + 1 < len(data):
        if data[pos] == 0xFF and data[pos + 1] not in (0x00, 0xFF) \
                and not (0xD0 <= data[pos + 1] <= 0xD7):
            return pos
        pos += 1
    raise JpegError("no marker after scan")


def _decode_progressive_scans(data, ts, frame, grids, scan, scan_start,
                              hmax, vmax, mcux, mcuy) -> None:
    """Accumulate every progressive scan into the coefficient grids.

    DC scans (Ss=0) walk the MCU grid interleaved (or a component's own
    block grid when single-component); AC scans (Ss>0) are always
    single-component and walk the component's TRUE block grid — MCU
    padding blocks are not coded in non-interleaved scans
    (T.81 G.2 / A.2.2).
    """
    h, w, comps, _precision = frame
    visits = 0
    # Frame-scaled budget (floor _MAX_BLOCK_VISITS): see the constant's
    # comment; the native decoder applies the same rule.  The scale
    # term is CAPPED (1 << 25 visits, ~30 s worst case on this pure-
    # Python path) so attacker-declared SOF dimensions cannot buy
    # unbounded amplification headroom.
    total_blocks = sum(mcux * c.h * mcuy * c.v for c in comps)
    max_visits = max(_MAX_BLOCK_VISITS,
                     min(64 * total_blocks, 1 << 25))
    script = _ScanScript(len(comps))
    for _ in range(_MAX_SCANS):
        sel, ss, se, ah, al = scan
        script.validate(comps, sel, ss, se, ah, al)
        if ss == 0:
            visits += (sum(mcux * c.h * mcuy * c.v for c in sel)
                       if len(sel) > 1 else
                       int(np.prod(_comp_block_dims(sel[0], h, w,
                                                    hmax, vmax))))
        else:
            visits += int(np.prod(_comp_block_dims(sel[0], h, w,
                                                   hmax, vmax)))
        if visits > max_visits:
            raise JpegError("progressive stream exceeds the "
                            "cumulative block budget")
        reader = _BitReader(data, scan_start)
        if ss == 0:
            _prog_dc_scan(reader, ts, sel, comps, grids, ah, al,
                          mcux, mcuy, h, w, hmax, vmax)
        else:
            _prog_ac_scan(reader, ts, sel[0], comps, grids, ss, se,
                          ah, al, h, w, hmax, vmax)
        # Next segment stream starts at the first marker past the
        # scan's entropy bytes.
        pos = _next_marker_pos(data, reader.pos)
        scan = None
        while pos + 2 <= len(data):
            marker = data[pos + 1]
            if marker == 0xD9:           # EOI: done
                return
            if pos + 4 > len(data):
                raise JpegError("truncated segment")
            seglen = struct.unpack(">H", data[pos + 2:pos + 4])[0]
            if seglen < 2 or pos + 2 + seglen > len(data):
                raise JpegError("truncated segment")
            body = data[pos + 4:pos + 2 + seglen]
            if marker == 0xDA:
                scan = _parse_sos_body(body, frame, True)
                scan_start = pos + 2 + seglen
                break
            # Inter-scan DHT/DQT/DRI updates reuse the SOI-path parser
            # by faking a minimal stream prefix.
            _parse_segments(
                b"\xff\xd8" + data[pos:pos + 2 + seglen] + b"\xff\xd9",
                ts)
            pos += 2 + seglen
        if scan is None:
            raise JpegError("progressive stream ended without EOI")
    raise JpegError(f"more than {_MAX_SCANS} scans")


def _comp_block_dims(c, h, w, hmax, vmax):
    """A component's TRUE (non-interleaved) block-grid dimensions."""
    cw = -(-w * c.h // hmax)
    ch = -(-h * c.v // vmax)
    return -(-ch // 8), -(-cw // 8)


def _prog_dc_scan(reader, ts, sel, comps, grids, ah, al,
                  mcux, mcuy, h, w, hmax, vmax) -> None:
    for c in sel:
        if ah == 0 and c.td not in ts.huff_dc:
            raise JpegError("missing huffman table")
    ri = ts.restart_interval
    preds = {c.ident: 0 for c in sel}
    interleaved = len(sel) > 1

    def first_bit(c, grid, by, bx):
        t = _decode_huff(reader, ts.huff_dc[c.td])
        if t > 15:
            raise JpegError("bad DC category")
        preds[c.ident] += _extend(reader.receive(t), t)
        grid[by, bx, 0] = preds[c.ident] << al

    def refine_bit(c, grid, by, bx):
        if reader.receive(1):
            grid[by, bx, 0] |= (1 << al)

    visit = first_bit if ah == 0 else refine_bit
    unit = 0
    if interleaved:
        pairs = [(c, grids[comps.index(c)]) for c in sel]
        for my in range(mcuy):
            for mx in range(mcux):
                if ri and unit and unit % ri == 0:
                    reader.restart()
                    preds = {c.ident: 0 for c in sel}
                unit += 1
                for c, grid in pairs:
                    for by in range(c.v):
                        for bx in range(c.h):
                            visit(c, grid, my * c.v + by, mx * c.h + bx)
    else:
        c = sel[0]
        grid = grids[comps.index(c)]
        nby, nbx = _comp_block_dims(c, h, w, hmax, vmax)
        for by in range(nby):
            for bx in range(nbx):
                if ri and unit and unit % ri == 0:
                    reader.restart()
                    preds = {c.ident: 0 for c in sel}
                unit += 1
                visit(c, grid, by, bx)


def _prog_ac_scan(reader, ts, c, comps, grids, ss, se, ah, al,
                  h, w, hmax, vmax) -> None:
    if c.ta not in ts.huff_ac:
        raise JpegError("missing huffman table")
    ac_tbl = ts.huff_ac[c.ta]
    grid = grids[comps.index(c)]
    nby, nbx = _comp_block_dims(c, h, w, hmax, vmax)
    ri = ts.restart_interval
    eobrun = 0
    unit = 0
    for by in range(nby):
        for bx in range(nbx):
            if ri and unit and unit % ri == 0:
                reader.restart()
                eobrun = 0
            unit += 1
            block = grid[by, bx]
            if ah == 0:
                eobrun = _ac_first_block(reader, ac_tbl, block, ss, se,
                                         al, eobrun)
            else:
                eobrun = _ac_refine_block(reader, ac_tbl, block, ss, se,
                                          al, eobrun)


def _ac_first_block(reader, ac_tbl, block, ss, se, al, eobrun) -> int:
    """T.81 G.2.2: first pass over an AC spectral band."""
    if eobrun:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = _decode_huff(reader, ac_tbl)
        r, s = rs >> 4, rs & 0xF
        if s == 0:
            if r == 15:
                k += 16                       # ZRL
                continue
            eobrun = 1 << r
            if r:
                eobrun += reader.receive(r)
            return eobrun - 1                 # covers this block
        k += r
        if k > se:
            raise JpegError("AC run overflow")
        block[k] = _extend(reader.receive(s), s) << al
        k += 1
    return 0


def _ac_refine_block(reader, ac_tbl, block, ss, se, al, eobrun) -> int:
    """T.81 G.2.3 correction pass (the jdphuff.c refinement walk):
    every already-nonzero coefficient in the band gets one correction
    bit as it is passed; zero-history coefficients consume the run
    lengths and receive new ±1<<Al values."""
    p1 = 1 << al
    m1 = -1 << al

    def correct(k):
        # libjpeg's jdphuff form: partially-decoded coefficients are
        # multiples of p1, where (x & p1) == (|x| & p1) in two's
        # complement, so the signed test equals the spec's magnitude
        # test.
        if reader.receive(1) and not (block[k] & p1):
            block[k] += p1 if block[k] >= 0 else m1

    k = ss
    if not eobrun:
        while k <= se:
            rs = _decode_huff(reader, ac_tbl)
            r, s = rs >> 4, rs & 0xF
            val = 0
            if s == 0:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += reader.receive(r)
                    break
                # r == 15: run of 16 zero-history coefficients
            else:
                if s != 1:
                    raise JpegError("bad refinement size")
                val = p1 if reader.receive(1) else m1
            while k <= se:
                if block[k]:
                    correct(k)
                else:
                    if r == 0:
                        if val:
                            block[k] = val
                        k += 1
                        break
                    r -= 1
                k += 1
            else:
                if val:
                    raise JpegError("refinement value past band end")
    if eobrun:
        while k <= se:
            if block[k]:
                correct(k)
            k += 1
        eobrun -= 1
    return eobrun


def ycbcr_to_rgb(img: np.ndarray) -> np.ndarray:
    """JFIF YCbCr -> RGB on u8[h, w, 3] (BT.601 full range)."""
    y = img[..., 0].astype(np.float32)
    cb = img[..., 1].astype(np.float32) - 128.0
    cr = img[..., 2].astype(np.float32) - 128.0
    rgb = np.stack([
        y + 1.402 * cr,
        y - 0.344136 * cb - 0.714136 * cr,
        y + 1.772 * cb,
    ], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _sniff_precision(data: bytes) -> int:
    """The frame's SOF sample precision from a header-only walk
    (default 8 when no SOF is found before SOS — the full parse will
    produce the real error)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return 8
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):
            return 8
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return data[pos + 4] if pos + 4 < len(data) else 8
        seglen = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if seglen < 2:
            return 8
        pos += 2 + seglen
    return 8


def decode_tiff_jpeg(data: bytes, tables_bytes: Optional[bytes],
                     photometric: int,
                     tables_cache: Optional[dict] = None) -> np.ndarray:
    """Decode one TIFF compression-7 segment to ``u8[h, w, spp]``.

    8-bit frames go to the native decoder (``native.jpeg_decode_baseline``,
    which despite the name covers baseline SOF0/1 AND progressive SOF2),
    12-bit frames to the Python decoder (uint16 output).
    YCbCr (photometric 6) converts to RGB here; photometric 1/2 pass raw
    components through (libtiff writes photometric 2 with RGB stored
    directly in the JPEG).  ``tables_cache`` (per-TiffFile) memoizes the
    parsed JPEGTables so the Python path builds its Huffman lookups once
    per file rather than once per tile.
    """
    if _sniff_precision(data) == 8:
        from ..native import jpeg_decode_baseline
        out = jpeg_decode_baseline(data, tables_bytes)
    else:
        ts = None
        if tables_bytes:
            if tables_cache is not None:
                ts = tables_cache.get(tables_bytes)
            if ts is None:
                ts = parse_jpeg_tables(tables_bytes)
                if tables_cache is not None:
                    tables_cache[tables_bytes] = ts
        out = decode_baseline_jpeg(data, ts)
    if photometric == 6:
        if out.shape[-1] != 3:
            raise JpegError(
                f"YCbCr photometric with {out.shape[-1]} components")
        if out.dtype != np.uint8:
            raise JpegError(
                "12-bit YCbCr JPEG-in-TIFF is not supported (12-bit "
                "microscopy exports store components directly)")
        out = ycbcr_to_rgb(out)
    return out
