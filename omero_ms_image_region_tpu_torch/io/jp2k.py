"""Baseline JPEG 2000 Part-1 decoder (ITU-T T.800) for JPEG2000-in-TIFF.

The port's copy of the JAX package's ``io/jp2k.py`` (numpy only), with the
same order of operations everywhere, so a decode is bit-equal to the JAX
package's.  Aperio SVS exports and other vendor WSI pyramids store tiles as
raw JPEG 2000 codestreams under TIFF compression 33003/33005; the reference
reads them through Bio-Formats behind ``PixelsService.getPixelBuffer``
(``build.gradle:81-83``).

Scope (what WSI serving needs):
- raw J2K codestreams and JP2 box files (the box walk just locates the
  contiguous codestream);
- SIZ/COD/COC/QCD/QCC, multiple tiles and tile-parts, all five
  progression orders, quality layers, SOP/EPH markers;
- EBCOT Tier-1 (MQ coder per Annex C, three passes, default code-block
  style; the segmentation-symbol option is tolerated) with mid-point
  reconstruction for truncated planes;
- 5/3 reversible and 9/7 irreversible inverse DWT, RCT/ICT multiple
  component transform, scalar quantization (derived + expounded);
- default (whole-subband) and explicit precinct sizes.

Tier-1, per code-block, runs in ``native/jp2kt1.cpp`` (built with g++ on
first use, the GIL released for the block; :data:`T1_NATIVE_BLOCKS` counts
its calls); :func:`_t1_decode` below is its plain Python version, which
the tests hold it against block by block.  Everything else (markers, tag
trees, the packet walk, the inverse DWT and the colour transforms) is
numpy on the host, as in the JAX package: the decode does not touch the
card.
"""

from __future__ import annotations

import math
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class Jp2kError(ValueError):
    """Malformed or unsupported JPEG 2000 stream."""


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------- MQ decoder

# Annex C probability state machine: (Qe, NMPS, NLPS, SWITCH).
_MQ = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]
_MQ_QE = [s[0] for s in _MQ]
_MQ_NMPS = [s[1] for s in _MQ]
_MQ_NLPS = [s[2] for s in _MQ]
_MQ_SWITCH = [s[3] for s in _MQ]

# T1 context indices: 0-8 zero coding, 9-13 sign coding, 14-16 magnitude
# refinement, 17 run-length, 18 uniform.
_CTX_RL = 17
_CTX_UNI = 18
_N_CTX = 19


class _MQDecoder:
    """MQ arithmetic decoder (T.800 Annex C, software conventions)."""

    __slots__ = ("data", "bp", "c", "a", "ct", "i", "mps")

    def __init__(self, data: bytes):
        self.data = data
        self.i = [0] * _N_CTX
        self.mps = [0] * _N_CTX
        # Initial states (Table D.7): ctx 18 (UNIFORM) = 46, ctx 17
        # (RUN-LENGTH) = 3, ctx 0 (first zero-coding) = 4, rest 0.
        self.i[_CTX_UNI] = 46
        self.i[_CTX_RL] = 3
        self.i[0] = 4
        self.bp = 0
        b = data[0] if data else 0xFF
        self.c = b << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _b(self, k: int = 0) -> int:
        p = self.bp + k
        return self.data[p] if p < len(self.data) else 0xFF

    def _bytein(self) -> None:
        if self._b() == 0xFF:
            if self._b(1) > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += self._b() << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += self._b() << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        i = self.i[cx]
        qe = _MQ_QE[i]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS path (chigh < Qe)
            if self.a < qe:
                d = self.mps[cx]
                self.i[cx] = _MQ_NMPS[i]
            else:
                d = 1 - self.mps[cx]
                if _MQ_SWITCH[i]:
                    self.mps[cx] = 1 - self.mps[cx]
                self.i[cx] = _MQ_NLPS[i]
            self.a = qe
        else:
            self.c = (self.c - (qe << 16)) & 0xFFFFFFFF
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if _MQ_SWITCH[i]:
                    self.mps[cx] = 1 - self.mps[cx]
                self.i[cx] = _MQ_NLPS[i]
            else:
                d = self.mps[cx]
                self.i[cx] = _MQ_NMPS[i]
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# ------------------------------------------------------------ tag trees

class _TagTree:
    """T.800 B.10.2 tag tree over a w x h leaf grid.

    Per node a lower bound rises with 0-bits; a 1-bit resolves the
    node's value at the current bound.
    """

    def __init__(self, w: int, h: int):
        self.levels: List[Tuple[int, int]] = []
        while True:
            self.levels.append((w, h))
            if w == 1 and h == 1:
                break
            w, h = _ceil_div(w, 2), _ceil_div(h, 2)
        self.low = [np.zeros((lh, lw), np.int32)
                    for (lw, lh) in self.levels]
        self.value = [np.zeros((lh, lw), np.int32)
                      for (lw, lh) in self.levels]
        self.known = [np.zeros((lh, lw), bool)
                      for (lw, lh) in self.levels]

    def decode(self, x: int, y: int, reader, threshold: int) -> bool:
        """Resolve leaf (x, y) against ``threshold``: True iff its
        value is known AND < threshold.  Consumes bits."""
        # Leaf -> root path; walk root-first.
        path = []
        lx, ly = x, y
        for li in range(len(self.levels)):
            path.append((li, lx, ly))
            lx >>= 1
            ly >>= 1
        bound = 0
        for li, lx, ly in reversed(path):
            if self.low[li][ly, lx] < bound:
                self.low[li][ly, lx] = bound
            while (not self.known[li][ly, lx]
                   and self.low[li][ly, lx] < threshold):
                if reader.bit():
                    self.known[li][ly, lx] = True
                    self.value[li][ly, lx] = self.low[li][ly, lx]
                else:
                    self.low[li][ly, lx] += 1
            bound = int(self.value[li][ly, lx]
                        if self.known[li][ly, lx]
                        else self.low[li][ly, lx])
        return bool(self.known[0][y, x]) \
            and int(self.value[0][y, x]) < threshold

    def leaf_value(self, x: int, y: int) -> int:
        return int(self.value[0][y, x])


class _PacketBitReader:
    """Packet-header bit reader with the 0xFF bit-stuffing rule
    (after an 0xFF byte only 7 bits follow)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.nbits = 0
        self.last = 0

    def bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.data):
                raise Jp2kError("truncated packet header")
            b = self.data[self.pos]
            self.pos += 1
            self.nbits = 7 if self.last == 0xFF else 8
            self.buf = b
            self.last = b
        self.nbits -= 1
        return (self.buf >> self.nbits) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        """Finish the header: byte-align; a stuffed 0 bit after a
        trailing 0xFF consumes the next byte."""
        self.nbits = 0
        if self.last == 0xFF:
            if self.pos < len(self.data) and self.data[self.pos] == 0x00:
                self.pos += 1
            self.last = 0


# ----------------------------------------------------------- structures

@dataclass
class _CodingStyle:
    progression: int = 0
    layers: int = 1
    mct: int = 0
    levels: int = 5                 # decomposition levels NL
    cblk_w_exp: int = 6             # log2 widths (already +2)
    cblk_h_exp: int = 6
    cblk_style: int = 0
    transform: int = 1              # 0 = 9/7, 1 = 5/3
    precincts: Optional[List[Tuple[int, int]]] = None  # per resolution

    def precinct_exp(self, r: int) -> Tuple[int, int]:
        if self.precincts is None:
            return 15, 15
        return self.precincts[min(r, len(self.precincts) - 1)]


@dataclass
class _Quant:
    style: int = 0                  # 0 none, 1 derived, 2 expounded
    guard: int = 2
    exponents: List[int] = field(default_factory=list)
    mantissas: List[int] = field(default_factory=list)


@dataclass
class _Component:
    depth: int
    signed: bool
    dx: int
    dy: int


@dataclass
class _CodeBlock:
    x0: int
    y0: int
    x1: int
    y1: int
    included: bool = False
    zero_planes: int = 0
    lblock: int = 3
    passes: int = 0
    data: bytearray = field(default_factory=bytearray)


@dataclass
class _Band:
    orient: int                     # 0 LL, 1 HL, 2 LH, 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    blocks: List[List[_CodeBlock]] = field(default_factory=list)
    incl_tree: Dict[int, _TagTree] = field(default_factory=dict)
    zero_tree: Dict[int, _TagTree] = field(default_factory=dict)


_J2K_SOC = 0xFF4F
_J2K_SIZ = 0xFF51
_J2K_COD = 0xFF52
_J2K_COC = 0xFF53
_J2K_QCD = 0xFF5C
_J2K_QCC = 0xFF5D
_J2K_RGN = 0xFF5E
_J2K_POC = 0xFF5F
_J2K_SOT = 0xFF90
_J2K_SOP = 0xFF91
_J2K_EPH = 0xFF92
_J2K_SOD = 0xFF93
_J2K_EOC = 0xFFD9


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.comps: List[_Component] = []
        self.cod = _CodingStyle()
        self.cod_per_comp: Dict[int, _CodingStyle] = {}
        self.qcd = _Quant()
        self.qcd_per_comp: Dict[int, _Quant] = {}
        self.tile_parts: Dict[int, List[Tuple[int, int]]] = {}
        self._parse()

    # -------------------------------------------------------- main parse

    def _parse(self) -> None:
        d = self.data
        if len(d) < 4 or struct.unpack(">H", d[:2])[0] != _J2K_SOC:
            raise Jp2kError("no SOC marker")
        pos = 2
        in_tile = None
        while pos + 2 <= len(d):
            marker = struct.unpack(">H", d[pos:pos + 2])[0]
            if marker == _J2K_EOC:
                return
            if marker == _J2K_SOD:
                if in_tile is None:
                    raise Jp2kError("SOD outside tile-part")
                isot, tp_end = in_tile
                self.tile_parts.setdefault(isot, []).append(
                    (pos + 2, tp_end))
                pos = tp_end
                in_tile = None
                continue
            if pos + 4 > len(d):
                raise Jp2kError("truncated marker segment")
            seglen = struct.unpack(">H", d[pos + 2:pos + 4])[0]
            if seglen < 2 or pos + 2 + seglen > len(d):
                raise Jp2kError("truncated marker segment")
            body = d[pos + 4:pos + 2 + seglen]
            if marker == _J2K_SIZ:
                self._parse_siz(body)
            elif marker in (_J2K_COD, _J2K_COC, _J2K_QCD, _J2K_QCC) \
                    and in_tile is not None:
                # Tile-part-local coding/quantization overrides are
                # spec-legal but would need per-tile style state; the
                # current decoder applies styles globally, so refusing
                # is the only honest behavior (silently-global would
                # decode OTHER tiles with the wrong tables).
                raise Jp2kError(
                    "tile-part-local COD/COC/QCD/QCC is not supported")
            elif marker in (0xFF60, 0xFF61):    # PPM / PPT
                raise Jp2kError(
                    "packed packet headers (PPM/PPT) are not supported")
            elif marker == _J2K_COD:
                self.cod = self._parse_cod(body)
            elif marker == _J2K_COC:
                ci, cs = self._parse_coc(body)
                self.cod_per_comp[ci] = cs
            elif marker == _J2K_QCD:
                self.qcd = self._parse_quant(body)
            elif marker == _J2K_QCC:
                big = len(self.comps) > 256
                if len(body) < (3 if big else 2):
                    raise Jp2kError("truncated QCC")
                if big:
                    ci = struct.unpack(">H", body[:2])[0]
                    qbody = body[2:]
                else:
                    ci = body[0]
                    qbody = body[1:]
                self.qcd_per_comp[ci] = self._parse_quant(qbody)
            elif marker == _J2K_SOT:
                if seglen != 10:
                    raise Jp2kError("bad SOT length")
                isot, psot, _tpsot, _tnsot = struct.unpack(
                    ">HIBB", body)
                tp_end = pos + psot if psot else len(d)
                if tp_end > len(d):
                    raise Jp2kError("tile-part overruns stream")
                in_tile = (isot, tp_end)
            elif marker == _J2K_RGN:
                raise Jp2kError("ROI (RGN) streams are not supported")
            elif marker == _J2K_POC:
                raise Jp2kError(
                    "progression-order changes (POC) not supported")
            # COM/TLM/PLM/PLT/CRG etc: skipped.
            pos += 2 + seglen

    def _parse_siz(self, b: bytes) -> None:
        if len(b) < 36:
            raise Jp2kError("truncated SIZ")
        (_rsiz, self.xsiz, self.ysiz, self.xosiz, self.yosiz,
         self.xtsiz, self.ytsiz, self.xtosiz, self.ytosiz,
         csiz) = struct.unpack(">HIIIIIIIIH", b[:36])
        if self.xsiz <= self.xosiz or self.ysiz <= self.yosiz:
            raise Jp2kError("empty image grid")
        if self.xtsiz == 0 or self.ytsiz == 0:
            raise Jp2kError("zero tile size")
        # Hostile/corrupt headers must not drive allocations or tile
        # loops (same posture as the TIFF parser's count caps).
        if csiz < 1 or csiz > 64:
            raise Jp2kError(f"component count {csiz} exceeds the "
                            f"64-component cap")
        if (self.xsiz - self.xosiz) * (self.ysiz - self.yosiz) \
                * csiz > (1 << 28):
            raise Jp2kError("image area exceeds the 256M-sample cap")
        if len(b) < 36 + 3 * csiz:
            raise Jp2kError("truncated SIZ components")
        self.comps = []
        for ci in range(csiz):
            ssiz, xr, yr = b[36 + 3 * ci:39 + 3 * ci]
            if xr == 0 or yr == 0:
                raise Jp2kError("zero component subsampling")
            depth = (ssiz & 0x7F) + 1
            if depth > 32:
                # T.800 allows up to 38 bits, but past 32 the output
                # dtypes would silently wrap — fail loudly instead.
                raise Jp2kError(
                    f"{depth}-bit components are not supported "
                    f"(32-bit max)")
            self.comps.append(_Component(
                depth=depth, signed=bool(ssiz & 0x80), dx=xr, dy=yr))
        self.ntx = _ceil_div(self.xsiz - self.xtosiz, self.xtsiz)
        self.nty = _ceil_div(self.ysiz - self.ytosiz, self.ytsiz)
        if self.ntx * self.nty > 65536:
            raise Jp2kError("tile grid exceeds the 65536-tile cap")

    def _parse_cod(self, b: bytes) -> _CodingStyle:
        if len(b) < 10:
            raise Jp2kError("truncated COD")
        scod = b[0]
        cs = _CodingStyle(
            progression=b[1],
            layers=struct.unpack(">H", b[2:4])[0],
            mct=b[4],
            levels=b[5],
            cblk_w_exp=(b[6] & 0xF) + 2,
            cblk_h_exp=(b[7] & 0xF) + 2,
            cblk_style=b[8],
            transform=b[9],
        )
        cs.sop = bool(scod & 2)
        cs.eph = bool(scod & 4)
        if cs.layers == 0:
            raise Jp2kError("zero quality layers")
        if cs.layers > 4096:
            # Spec allows 65535, but layers scale the packet walk per
            # precinct; real encoders use a handful.
            raise Jp2kError(f"{cs.layers} quality layers exceed the "
                            f"4096-layer cap")
        if cs.cblk_w_exp + cs.cblk_h_exp > 12:
            raise Jp2kError("code-block area > 4096")
        # Styles we cannot decode: selective bypass (1), reset (2),
        # termall (4), vertically causal (8).  Predictable termination
        # (32) and segmentation symbols (16) only ADD decoder-checkable
        # redundancy; tolerate 16, reject the rest.
        if cs.cblk_style & ~0x10:
            raise Jp2kError(
                f"unsupported code-block style {cs.cblk_style:#x}")
        if cs.transform not in (0, 1):
            raise Jp2kError(f"unknown wavelet transform {cs.transform}")
        if scod & 1:
            if len(b) < 10 + cs.levels + 1:
                raise Jp2kError("truncated COD precincts")
            cs.precincts = [(v & 0xF, v >> 4)
                            for v in b[10:10 + cs.levels + 1]]
        return cs

    def _parse_coc(self, b: bytes) -> Tuple[int, _CodingStyle]:
        big = len(self.comps) > 256
        if len(b) < (2 if big else 1) + 6:
            raise Jp2kError("truncated COC")
        ci = struct.unpack(">H", b[:2])[0] if big else b[0]
        off = 2 if big else 1
        scoc = b[off]
        sp = b[off + 1:]
        cs = _CodingStyle(
            progression=self.cod.progression, layers=self.cod.layers,
            mct=self.cod.mct,
            levels=sp[0], cblk_w_exp=(sp[1] & 0xF) + 2,
            cblk_h_exp=(sp[2] & 0xF) + 2, cblk_style=sp[3],
            transform=sp[4])
        cs.sop = getattr(self.cod, "sop", False)
        cs.eph = getattr(self.cod, "eph", False)
        if cs.cblk_w_exp + cs.cblk_h_exp > 12:
            raise Jp2kError("code-block area > 4096")
        if cs.cblk_style & ~0x10:
            raise Jp2kError(
                f"unsupported code-block style {cs.cblk_style:#x}")
        if cs.transform not in (0, 1):
            raise Jp2kError(f"unknown wavelet transform {cs.transform}")
        if scoc & 1:
            if len(sp) < 5 + cs.levels + 1:
                raise Jp2kError("truncated COC precincts")
            cs.precincts = [(v & 0xF, v >> 4)
                            for v in sp[5:5 + cs.levels + 1]]
        return ci, cs

    def _parse_quant(self, b: bytes) -> _Quant:
        if not b:
            raise Jp2kError("empty quantization segment")
        sq = b[0]
        q = _Quant(style=sq & 0x1F, guard=sq >> 5)
        if q.style == 0:            # no quantization: u8 exponents
            q.exponents = [v >> 3 for v in b[1:]]
        elif q.style in (1, 2):     # scalar derived / expounded
            vals = struct.unpack(f">{(len(b) - 1) // 2}H", b[1:])
            q.exponents = [v >> 11 for v in vals]
            q.mantissas = [v & 0x7FF for v in vals]
        else:
            raise Jp2kError(f"unknown quantization style {q.style}")
        return q

    # ------------------------------------------------------ tile decode

    def _comp_cod(self, c: int) -> _CodingStyle:
        return self.cod_per_comp.get(c, self.cod)

    def _comp_quant(self, c: int) -> _Quant:
        return self.qcd_per_comp.get(c, self.qcd)

    def decode(self) -> np.ndarray:
        """Full image -> [h, w, ncomp] (dtype per depth)."""
        out_comps = []
        for ci, comp in enumerate(self.comps):
            cw = _ceil_div(self.xsiz, comp.dx) - _ceil_div(
                self.xosiz, comp.dx)
            ch = _ceil_div(self.ysiz, comp.dy) - _ceil_div(
                self.yosiz, comp.dy)
            out_comps.append(np.zeros((ch, cw), np.float64))
        for t in range(self.ntx * self.nty):
            planes = self._decode_tile(t)
            if planes is None:
                continue
            tx = t % self.ntx
            ty = t // self.ntx
            tcx0 = max(self.xtosiz + tx * self.xtsiz, self.xosiz)
            tcy0 = max(self.ytosiz + ty * self.ytsiz, self.yosiz)
            # Inverse MCT per tile (T.800 G): applies to the first three
            # components when flagged.
            cod = self.cod
            if cod.mct and len(planes) >= 3:
                if len({p.shape for p in planes[:3]}) != 1:
                    raise Jp2kError(
                        "MCT over subsampled components is not valid")
                if cod.transform == 1:
                    planes[:3] = _inverse_rct(*planes[:3])
                else:
                    planes[:3] = _inverse_ict(*planes[:3])
            for ci, comp in enumerate(self.comps):
                px0 = _ceil_div(tcx0, comp.dx) - _ceil_div(
                    self.xosiz, comp.dx)
                py0 = _ceil_div(tcy0, comp.dy) - _ceil_div(
                    self.yosiz, comp.dy)
                p = planes[ci]
                out_comps[ci][py0:py0 + p.shape[0],
                              px0:px0 + p.shape[1]] = p
        # DC level shift + clamp to depth.
        final = []
        for ci, comp in enumerate(self.comps):
            a = out_comps[ci]
            if not comp.signed:
                a = a + (1 << (comp.depth - 1))
            lo, hi = ((-(1 << (comp.depth - 1)),
                       (1 << (comp.depth - 1)) - 1) if comp.signed
                      else (0, (1 << comp.depth) - 1))
            a = np.clip(np.round(a), lo, hi)
            dt = (np.int32 if comp.signed else np.uint32)
            if comp.depth <= 8:
                dt = np.int8 if comp.signed else np.uint8
            elif comp.depth <= 16:
                dt = np.int16 if comp.signed else np.uint16
            final.append(a.astype(dt))
        if len({c.shape for c in final}) != 1:
            # Subsampled chroma (Aperio 33003 writes 4:2:x YCbCr):
            # replicate each component up to the full grid.  Smooth
            # chroma makes pixel replication visually equivalent to
            # interpolation at WSI viewing scales.
            fh = max(c.shape[0] for c in final)
            fw = max(c.shape[1] for c in final)
            up = []
            for ci, c in enumerate(final):
                if c.shape[0] == 0 or c.shape[1] == 0:
                    # A SIZ-valid but degenerate registration can give
                    # a zero-size component grid; keep the hostile-
                    # header contract (Jp2kError, never a raw crash).
                    raise Jp2kError(
                        f"component {ci} has an empty sample grid")
                ry = _ceil_div(fh, c.shape[0])
                rx = _ceil_div(fw, c.shape[1])
                if ry > 1 or rx > 1:
                    c = np.repeat(np.repeat(c, ry, axis=0), rx,
                                  axis=1)[:fh, :fw]
                up.append(c)
            final = up
        return np.stack(final, axis=-1)

    def _decode_tile(self, t: int):
        parts = self.tile_parts.get(t)
        tx = t % self.ntx
        ty = t // self.ntx
        tcx0 = max(self.xtosiz + tx * self.xtsiz, self.xosiz)
        tcy0 = max(self.ytosiz + ty * self.ytsiz, self.yosiz)
        tcx1 = min(self.xtosiz + (tx + 1) * self.xtsiz, self.xsiz)
        tcy1 = min(self.ytosiz + (ty + 1) * self.ytsiz, self.ysiz)
        if parts is None:
            return None
        stream = b"".join(self.data[s:e] for s, e in parts)

        planes = []
        tile_bands: List[List[List[_Band]]] = []   # [comp][res][band]
        for ci, comp in enumerate(self.comps):
            cod = self._comp_cod(ci)
            cx0, cy0 = _ceil_div(tcx0, comp.dx), _ceil_div(tcy0, comp.dy)
            cx1, cy1 = _ceil_div(tcx1, comp.dx), _ceil_div(tcy1, comp.dy)
            res_bands = []
            for r in range(cod.levels + 1):
                nb = cod.levels - r
                bands = []
                if r == 0:
                    bands.append(self._make_band(
                        0, cx0, cy0, cx1, cy1, cod, r, nb))
                else:
                    for orient in (1, 2, 3):
                        bands.append(self._make_band(
                            orient, cx0, cy0, cx1, cy1, cod, r,
                            nb + 1))
                res_bands.append(bands)
            tile_bands.append(res_bands)

        self._read_packets(stream, tile_bands, tcx0, tcy0, tcx1, tcy1)

        for ci, comp in enumerate(self.comps):
            cod = self._comp_cod(ci)
            quant = self._comp_quant(ci)
            cx0, cy0 = _ceil_div(tcx0, comp.dx), _ceil_div(tcy0, comp.dy)
            cx1, cy1 = _ceil_div(tcx1, comp.dx), _ceil_div(tcy1, comp.dy)
            planes.append(self._reconstruct_component(
                ci, comp, cod, quant, tile_bands[ci],
                cx0, cy0, cx1, cy1))
        return planes

    def _make_band(self, orient: int, cx0, cy0, cx1, cy1,
                   cod: _CodingStyle, r: int, nb: int) -> _Band:
        """Band rect per T.800 B.5 (component coords -> band coords)."""
        xo = 1 if orient in (1, 3) else 0
        yo = 1 if orient in (2, 3) else 0
        if nb == 0:
            bx0, by0, bx1, by1 = cx0, cy0, cx1, cy1
        else:
            sh = 1 << nb
            half = 1 << (nb - 1)
            bx0 = _ceil_div(cx0 - half * xo, sh)
            by0 = _ceil_div(cy0 - half * yo, sh)
            bx1 = _ceil_div(cx1 - half * xo, sh)
            by1 = _ceil_div(cy1 - half * yo, sh)
        band = _Band(orient, bx0, by0, bx1, by1)
        if bx1 <= bx0 or by1 <= by0:
            return band
        # Code-block grid: global alignment on cblk-size multiples in
        # band coordinates, capped by the precinct partition.
        ppx, ppy = cod.precinct_exp(r)
        if r > 0:
            ppx, ppy = max(ppx - 1, 0), max(ppy - 1, 0)
        cbw = min(cod.cblk_w_exp, ppx)
        cbh = min(cod.cblk_h_exp, ppy)
        band.cb_w_exp, band.cb_h_exp = cbw, cbh
        gx0 = bx0 >> cbw
        gx1 = _ceil_div(bx1, 1 << cbw)
        gy0 = by0 >> cbh
        gy1 = _ceil_div(by1, 1 << cbh)
        for gy in range(gy0, gy1):
            row = []
            for gx in range(gx0, gx1):
                row.append(_CodeBlock(
                    x0=max(bx0, gx << cbw), y0=max(by0, gy << cbh),
                    x1=min(bx1, (gx + 1) << cbw),
                    y1=min(by1, (gy + 1) << cbh)))
            band.blocks.append(row)
        return band

    # ------------------------------------------------------ packet walk

    def _precinct_grid(self, comp: _Component, cod: _CodingStyle,
                       r: int, tcx0, tcy0, tcx1, tcy1):
        """Precinct count + rect helper for one resolution."""
        nb = cod.levels - r
        cx0, cy0 = _ceil_div(tcx0, comp.dx), _ceil_div(tcy0, comp.dy)
        cx1, cy1 = _ceil_div(tcx1, comp.dx), _ceil_div(tcy1, comp.dy)
        rx0, ry0 = _ceil_div(cx0, 1 << nb), _ceil_div(cy0, 1 << nb)
        rx1, ry1 = _ceil_div(cx1, 1 << nb), _ceil_div(cy1, 1 << nb)
        ppx, ppy = cod.precinct_exp(r)
        if rx1 <= rx0 or ry1 <= ry0:
            return 0, 0, (rx0, ry0, rx1, ry1), (ppx, ppy)
        npx = _ceil_div(rx1, 1 << ppx) - (rx0 >> ppx)
        npy = _ceil_div(ry1, 1 << ppy) - (ry0 >> ppy)
        return npx, npy, (rx0, ry0, rx1, ry1), (ppx, ppy)

    def _read_packets(self, stream: bytes, tile_bands,
                      tcx0, tcy0, tcx1, tcy1) -> None:
        cod = self.cod
        ncomp = len(self.comps)
        maxres = max(self._comp_cod(c).levels for c in range(ncomp)) + 1
        pos = 0

        def packet_iter():
            prog = cod.progression
            L = cod.layers
            if prog == 0:      # LRCP
                for l in range(L):
                    for r in range(maxres):
                        for c in range(ncomp):
                            yield from self._precincts_of(
                                c, r, l, tcx0, tcy0, tcx1, tcy1)
            elif prog == 1:    # RLCP
                for r in range(maxres):
                    for l in range(L):
                        for c in range(ncomp):
                            yield from self._precincts_of(
                                c, r, l, tcx0, tcy0, tcx1, tcy1)
            elif prog == 2:    # RPCL
                for r in range(maxres):
                    for p in self._positions(r, tcx0, tcy0, tcx1, tcy1):
                        for c in range(ncomp):
                            yield from self._precincts_at(
                                c, r, p, tcx0, tcy0, tcx1, tcy1)
            elif prog == 3:    # PCRL
                for p in self._positions(None, tcx0, tcy0, tcx1, tcy1):
                    for c in range(ncomp):
                        for r in range(self._comp_cod(c).levels + 1):
                            yield from self._precincts_at(
                                c, r, p, tcx0, tcy0, tcx1, tcy1)
            elif prog == 4:    # CPRL
                for c in range(ncomp):
                    for p in self._positions(None, tcx0, tcy0,
                                             tcx1, tcy1):
                        for r in range(self._comp_cod(c).levels + 1):
                            yield from self._precincts_at(
                                c, r, p, tcx0, tcy0, tcx1, tcy1)
            else:
                raise Jp2kError(f"unknown progression order {prog}")

        for (c, r, l, pi) in packet_iter():
            pos = self._read_packet(stream, pos, tile_bands, c, r, l,
                                    pi, tcx0, tcy0, tcx1, tcy1)
            if pos >= len(stream):
                # Truncated stream: whatever decoded so far stands
                # (JPEG 2000 is progressive by construction).
                break

    def _precincts_of(self, c, r, l, tcx0, tcy0, tcx1, tcy1):
        cod = self._comp_cod(c)
        if r > cod.levels:
            return
        npx, npy, _, _ = self._precinct_grid(
            self.comps[c], cod, r, tcx0, tcy0, tcx1, tcy1)
        for pi in range(npx * npy):
            yield (c, r, l, pi)

    def _positions(self, r, tcx0, tcy0, tcx1, tcy1):
        """Position (y, x) iteration for RPCL/PCRL/CPRL — the union of
        precinct origins across components (layer loop inside)."""
        seen = set()
        ncomp = len(self.comps)
        rs = [r] if r is not None else None
        for c in range(ncomp):
            cod = self._comp_cod(c)
            rr = rs if rs is not None else range(cod.levels + 1)
            for ri in rr:
                if ri > cod.levels:
                    continue
                npx, npy, (rx0, ry0, _, _), (ppx, ppy) = \
                    self._precinct_grid(self.comps[c], cod, ri,
                                        tcx0, tcy0, tcx1, tcy1)
                nb = cod.levels - ri
                for py in range(npy):
                    for px in range(npx):
                        gx = ((rx0 >> ppx) + px) << (ppx + nb)
                        gy = ((ry0 >> ppy) + py) << (ppy + nb)
                        seen.add((gy * self.comps[c].dy,
                                  gx * self.comps[c].dx))
        for p in sorted(seen):
            yield p

    def _precincts_at(self, c, r, p, tcx0, tcy0, tcx1, tcy1):
        cod = self._comp_cod(c)
        if r > cod.levels:
            return
        comp = self.comps[c]
        npx, npy, (rx0, ry0, _, _), (ppx, ppy) = self._precinct_grid(
            comp, cod, r, tcx0, tcy0, tcx1, tcy1)
        nb = cod.levels - r
        for py in range(npy):
            for px in range(npx):
                gx = ((rx0 >> ppx) + px) << (ppx + nb)
                gy = ((ry0 >> ppy) + py) << (ppy + nb)
                if (gy * comp.dy, gx * comp.dx) == p:
                    # Layers are SGcod-global (COD); a per-component
                    # COC snapshot could predate COD in the header.
                    for l in range(self.cod.layers):
                        yield (c, r, l, py * npx + px)

    def _read_packet(self, stream: bytes, pos: int, tile_bands,
                     c: int, r: int, l: int, pi: int,
                     tcx0, tcy0, tcx1, tcy1) -> int:
        cod = self._comp_cod(c)
        comp = self.comps[c]
        bands = tile_bands[c][r]
        npx, npy, (rx0, ry0, rx1, ry1), (ppx, ppy) = \
            self._precinct_grid(comp, cod, r, tcx0, tcy0, tcx1, tcy1)
        if npx == 0 or npy == 0:
            return pos
        if getattr(cod, "sop", False) and pos + 6 <= len(stream) \
                and stream[pos:pos + 2] == b"\xff\x91":
            pos += 6
        reader = _PacketBitReader(stream, pos)
        try:
            present = reader.bit()
        except Jp2kError:
            return len(stream)
        contributions = []
        if present:
            for band in bands:
                if band.x1 <= band.x0 or band.y1 <= band.y0:
                    continue
                # Precinct rect in band coords.
                pxi, pyi = pi % npx, pi // npx
                nbshift = 0 if r == 0 else 1
                bpx0 = max(band.x0,
                           (((rx0 >> ppx) + pxi) << ppx) >> nbshift)
                bpy0 = max(band.y0,
                           (((ry0 >> ppy) + pyi) << ppy) >> nbshift)
                bpx1 = min(band.x1,
                           (((rx0 >> ppx) + pxi + 1) << ppx) >> nbshift)
                bpy1 = min(band.y1,
                           (((ry0 >> ppy) + pyi + 1) << ppy) >> nbshift)
                if bpx1 <= bpx0 or bpy1 <= bpy0:
                    continue
                cbw, cbh = band.cb_w_exp, band.cb_h_exp
                gx0 = bpx0 >> cbw
                gx1 = _ceil_div(bpx1, 1 << cbw)
                gy0 = bpy0 >> cbh
                gy1 = _ceil_div(bpy1, 1 << cbh)
                band_gx0 = band.x0 >> cbw
                band_gy0 = band.y0 >> cbh
                tw, th = gx1 - gx0, gy1 - gy0
                if pi not in band.incl_tree:
                    band.incl_tree[pi] = _TagTree(tw, th)
                    band.zero_tree[pi] = _TagTree(tw, th)
                itree = band.incl_tree[pi]
                ztree = band.zero_tree[pi]
                for gy in range(gy0, gy1):
                    for gx in range(gx0, gx1):
                        cb = band.blocks[gy - band_gy0][gx - band_gx0]
                        lx, ly = gx - gx0, gy - gy0
                        if not cb.included:
                            inc = itree.decode(lx, ly, reader, l + 1)
                        else:
                            inc = bool(reader.bit())
                        if not inc:
                            continue
                        if not cb.included:
                            # Zero-bitplane tag tree, fully resolved.
                            thr = 1
                            while not ztree.decode(lx, ly, reader, thr):
                                thr += 1
                            cb.zero_planes = ztree.leaf_value(lx, ly)
                            cb.included = True
                        npasses = _decode_npasses(reader)
                        while reader.bit():
                            cb.lblock += 1
                        # Single codeword segment (no termall/bypass):
                        # one length for all new passes.
                        bits = cb.lblock + int(
                            math.floor(math.log2(npasses))
                            if npasses > 1 else 0)
                        nbytes = reader.bits(bits)
                        contributions.append((cb, npasses, nbytes))
        reader.align()
        pos = reader.pos
        if getattr(cod, "eph", False) and pos + 2 <= len(stream) \
                and stream[pos:pos + 2] == b"\xff\x92":
            pos += 2
        for cb, npasses, nbytes in contributions:
            cb.data += stream[pos:pos + nbytes]
            if pos + nbytes > len(stream):
                raise Jp2kError("packet body overruns stream")
            cb.passes += npasses
            pos += nbytes
        return pos

    # --------------------------------------------------- reconstruction

    def _reconstruct_component(self, ci, comp, cod, quant, res_bands,
                               cx0, cy0, cx1, cy1) -> np.ndarray:
        NL = cod.levels
        # Decode every code-block into its band plane, then run the
        # inverse DWT over the multi-resolution layout.
        # Band planes keyed by (resolution r, orient).
        planes: Dict[Tuple[int, int], np.ndarray] = {}
        for r in range(NL + 1):
            for band in res_bands[r]:
                bw, bh = band.x1 - band.x0, band.y1 - band.y0
                if bw <= 0 or bh <= 0:
                    planes[(r, band.orient)] = np.zeros(
                        (max(bh, 0), max(bw, 0)), np.float64)
                    continue
                arr = np.zeros((bh, bw), np.float64)
                Mb = self._band_msbs(ci, quant, r, band.orient)
                for row in band.blocks:
                    for cb in row:
                        if not cb.included or cb.passes == 0:
                            continue
                        vals = _t1(
                            bytes(cb.data), cb.x1 - cb.x0,
                            cb.y1 - cb.y0, cb.passes,
                            Mb - cb.zero_planes, band.orient,
                            bool(cod.cblk_style & 0x10),
                            quant.style != 0)
                        arr[cb.y0 - band.y0:cb.y1 - band.y0,
                            cb.x0 - band.x0:cb.x1 - band.x0] = vals
                step = self._band_step(ci, comp, quant, cod, r,
                                       band.orient)
                planes[(r, band.orient)] = arr * step
        return _inverse_dwt(planes, cod, cx0, cy0, cx1, cy1)

    def _band_gain(self, orient: int) -> int:
        return {0: 0, 1: 1, 2: 1, 3: 2}[orient]

    def _band_index(self, cod_levels: int, r: int, orient: int) -> int:
        """Index into the QCD exponent/mantissa list."""
        if r == 0:
            return 0
        return 3 * (r - 1) + orient

    def _band_msbs(self, ci: int, quant: _Quant, r: int,
                   orient: int) -> int:
        cod = self._comp_cod(ci)
        comp = self.comps[ci]
        if quant.style == 1:
            # Derived: eps_b = eps_0 - NL + nb (decomposition shift).
            eps = quant.exponents[0]
            if r == 0:
                eps_b = eps
            else:
                eps_b = eps - cod.levels + (cod.levels - r + 1)
        else:
            idx = self._band_index(cod.levels, r, orient)
            if idx >= len(quant.exponents):
                raise Jp2kError("quantization table too short")
            eps_b = quant.exponents[idx]
        # Mb = guard bits + eps_b - 1 (eps_b carries the nominal
        # range for both reversible and quantized styles).
        return quant.guard + eps_b - 1

    def _band_step(self, ci, comp, quant, cod, r, orient) -> float:
        if quant.style == 0:
            return 1.0
        gain = self._band_gain(orient)
        rb = comp.depth + gain
        if quant.style == 1:
            eps = quant.exponents[0]
            mu = quant.mantissas[0]
            eps_b = (eps - cod.levels + (cod.levels - r + 1)
                     if r else eps)
        else:
            idx = self._band_index(cod.levels, r, orient)
            eps_b = quant.exponents[idx]
            mu = quant.mantissas[idx]
        return (2.0 ** (rb - eps_b)) * (1.0 + mu / 2048.0)


def _decode_npasses(reader) -> int:
    """Number of new coding passes codeword (T.800 B.10.6)."""
    if not reader.bit():
        return 1
    if not reader.bit():
        return 2
    v = reader.bits(2)
    if v < 3:
        return 3 + v
    v = reader.bits(5)
    if v < 31:
        return 6 + v
    return 37 + reader.bits(7)


# ------------------------------------------------------------- Tier-1

# Code-blocks decoded by the native tier-1 since import: a check that the
# native decoder, not the Python one, served a decode.  Tiles decode on
# the readers' thread pool, hence the lock.
T1_NATIVE_BLOCKS = 0
_T1_COUNT_LOCK = threading.Lock()


def _t1(data, w, h, npasses, msbs, orient, segsym, half_at_zero):
    """Tier-1 of one code-block: the native decoder (~100x the Python
    loops, what makes JPEG2000 TIFFs servable).  A missing g++ or a failed
    build raises, as for the port's other native codecs."""
    global T1_NATIVE_BLOCKS
    from ..native import jp2k_t1_decode
    out = jp2k_t1_decode(data, w, h, npasses, msbs, orient, segsym,
                         half_at_zero)
    with _T1_COUNT_LOCK:
        T1_NATIVE_BLOCKS += 1
    return out


# Zero-coding context tables per band class, indexed [h][v][d] with
# h, v in 0..2 and d in 0..4 (clamped): T.800 Table D.1.
def _zc_context(h: int, v: int, d: int, orient: int) -> int:
    if orient in (0, 2):       # LL / LH: (h, v) as-is
        hh, vv = h, v
    elif orient == 1:          # HL: swap h and v
        hh, vv = v, h
    else:                      # HH
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else (4 if hv == 1 else 3)
        return 2 if hv >= 2 else hv
    if hh == 2:
        return 8
    if hh == 1:
        return 7 if vv >= 1 else (6 if d >= 1 else 5)
    if vv == 2:
        return 4
    if vv == 1:
        return 3
    return 2 if d >= 2 else d


# Sign-coding contexts + XOR bits (T.800 Table D.3): index by
# (h_contrib + 1, v_contrib + 1) where contribs are clamped to [-1, 1].
_SC_CTX = [[13, 12, 11], [10, 9, 10], [11, 12, 13]]
_SC_XOR = [[1, 1, 1], [1, 0, 0], [0, 0, 0]]


def _t1_decode(data: bytes, w: int, h: int, npasses: int, msbs: int,
               orient: int, segsym: bool,
               half_at_zero: bool = False) -> np.ndarray:
    """EBCOT Tier-1: decode one code-block's coding passes.

    Returns f64[h, w] signed coefficient values with mid-point
    reconstruction for planes never decoded.  ``half_at_zero`` adds the
    half-LSB even when every plane was decoded — the dead-zone
    quantizer's midpoint for lossy streams (reversible streams must
    stay exact, so they only midpoint truncated planes).
    """
    if msbs <= 0 or npasses <= 0:
        return np.zeros((h, w), np.float64)
    mq = _MQDecoder(data)
    sig = np.zeros((h + 2, w + 2), bool)
    sgn = np.zeros((h + 2, w + 2), np.int8)      # -1 / +1 where sig
    visited = np.zeros((h + 2, w + 2), bool)
    refined = np.zeros((h + 2, w + 2), bool)
    mag = np.zeros((h, w), np.int64)

    def neighbors(y, x):
        """(h, v, d) significance counts + sign contributions around
        padded coords (y, x)."""
        hn = int(sig[y, x - 1]) + int(sig[y, x + 1])
        vn = int(sig[y - 1, x]) + int(sig[y + 1, x])
        dn = (int(sig[y - 1, x - 1]) + int(sig[y - 1, x + 1])
              + int(sig[y + 1, x - 1]) + int(sig[y + 1, x + 1]))
        return hn, vn, dn

    def decode_sign(y, x) -> int:
        hc = min(1, max(-1, int(sgn[y, x - 1]) + int(sgn[y, x + 1])))
        vc = min(1, max(-1, int(sgn[y - 1, x]) + int(sgn[y + 1, x])))
        ctx = _SC_CTX[hc + 1][vc + 1]
        xor = _SC_XOR[hc + 1][vc + 1]
        bit = mq.decode(ctx)
        return -1 if (bit ^ xor) else 1

    plane = msbs - 1
    pass_kind = 2                  # first pass is a cleanup
    for _ in range(npasses):
        if plane < 0:
            break
        bitval = 1 << plane
        if pass_kind == 0:
            # Significance propagation.
            for y0 in range(0, h, 4):
                for x in range(w):
                    for y in range(y0, min(y0 + 4, h)):
                        py, px = y + 1, x + 1
                        if sig[py, px]:
                            continue
                        hn, vn, dn = neighbors(py, px)
                        if hn + vn + dn == 0:
                            continue
                        visited[py, px] = True
                        if mq.decode(_zc_context(
                                min(hn, 2), min(vn, 2), min(dn, 4),
                                orient)):
                            s = decode_sign(py, px)
                            sig[py, px] = True
                            sgn[py, px] = s
                            mag[y, x] = bitval
        elif pass_kind == 1:
            # Magnitude refinement.
            for y0 in range(0, h, 4):
                for x in range(w):
                    for y in range(y0, min(y0 + 4, h)):
                        py, px = y + 1, x + 1
                        if not sig[py, px] or visited[py, px]:
                            continue
                        if not refined[py, px]:
                            hn, vn, dn = neighbors(py, px)
                            ctx = 15 if hn + vn + dn else 14
                            refined[py, px] = True
                        else:
                            ctx = 16
                        if mq.decode(ctx):
                            mag[y, x] |= bitval
        else:
            # Cleanup.
            for y0 in range(0, h, 4):
                for x in range(w):
                    y = y0
                    ylim = min(y0 + 4, h)
                    # Run-length mode: full stripe column, all four
                    # insignificant with no significant neighbors.
                    if ylim - y0 == 4:
                        runnable = True
                        for yy in range(y0, ylim):
                            py, px = yy + 1, x + 1
                            if sig[py, px] or visited[py, px]:
                                runnable = False
                                break
                            hn, vn, dn = neighbors(py, px)
                            if hn + vn + dn:
                                runnable = False
                                break
                        if runnable:
                            if not mq.decode(_CTX_RL):
                                for yy in range(y0, ylim):
                                    visited[yy + 1, x + 1] = False
                                continue
                            r2 = (mq.decode(_CTX_UNI) << 1) \
                                | mq.decode(_CTX_UNI)
                            y = y0 + r2
                            py, px = y + 1, x + 1
                            s = decode_sign(py, px)
                            sig[py, px] = True
                            sgn[py, px] = s
                            mag[y, x] = bitval
                            y += 1
                    while y < ylim:
                        py, px = y + 1, x + 1
                        if sig[py, px] or visited[py, px]:
                            visited[py, px] = False
                            y += 1
                            continue
                        hn, vn, dn = neighbors(py, px)
                        if mq.decode(_zc_context(
                                min(hn, 2), min(vn, 2), min(dn, 4),
                                orient)):
                            s = decode_sign(py, px)
                            sig[py, px] = True
                            sgn[py, px] = s
                            mag[y, x] = bitval
                        y += 1
            if segsym:
                # Segmentation symbol 1010 via the uniform context;
                # mismatch means corruption — decode what we have.
                for _k in range(4):
                    mq.decode(_CTX_UNI)
            visited[:] = False
            plane -= 1
            pass_kind = 0
            continue
        if pass_kind == 0:
            pass_kind = 1      # sig-prop -> magnitude refinement
        else:
            pass_kind = 2      # magref -> cleanup (visited stays set
            #                    from sig-prop so cleanup skips those)
    # Mid-point reconstruction for undecoded planes.
    last_plane = plane + 1
    vals = mag.astype(np.float64)
    if last_plane > 0 or half_at_zero:
        nz = vals > 0
        vals[nz] += (1 << max(last_plane, 0)) * 0.5
    signs = np.where(sgn[1:h + 1, 1:w + 1] < 0, -1.0, 1.0)
    return vals * signs


# --------------------------------------------------------- inverse DWT

def _inverse_dwt(planes: Dict[Tuple[int, int], np.ndarray],
                 cod: _CodingStyle, cx0, cy0, cx1, cy1) -> np.ndarray:
    """Multi-level inverse DWT from band planes (T.800 F.3)."""
    NL = cod.levels
    ll = planes[(0, 0)]
    for r in range(1, NL + 1):
        nb = NL - r
        # Resolution rect at level r in component coords.
        ux0, uy0 = _ceil_div(cx0, 1 << nb), _ceil_div(cy0, 1 << nb)
        ux1, uy1 = _ceil_div(cx1, 1 << nb), _ceil_div(cy1, 1 << nb)
        hl = planes[(r, 1)]
        lh = planes[(r, 2)]
        hh = planes[(r, 3)]
        ll = _idwt_level(ll, hl, lh, hh, ux0, uy0, ux1, uy1,
                         cod.transform)
    return ll


def _idwt_level(ll, hl, lh, hh, ux0, uy0, ux1, uy1,
                transform: int) -> np.ndarray:
    """One 2D inverse DWT level via interleave + 1D lifting (F.3.4-8).

    ``(ux0, uy0, ux1, uy1)`` is the output rect in this level's
    coordinates; subband rects follow from its even/odd split.
    """
    h, w = uy1 - uy0, ux1 - ux0
    if h <= 0 or w <= 0:
        return np.zeros((max(h, 0), max(w, 0)), np.float64)
    a = np.zeros((h, w), np.float64)
    # Interleave: sample (u, v) is from LL/HL/LH/HH by parity of
    # (u - ?) — global coords decide parity.
    ys = np.arange(uy0, uy1)
    xs = np.arange(ux0, ux1)
    ye, yo = (ys % 2 == 0), (ys % 2 == 1)
    xe, xo = (xs % 2 == 0), (xs % 2 == 1)
    a[np.ix_(ye, xe)] = ll
    a[np.ix_(ye, xo)] = hl
    a[np.ix_(yo, xe)] = lh
    a[np.ix_(yo, xo)] = hh
    a = _lift1d(a, ux0, transform, axis=1)
    a = _lift1d(a, uy0, transform, axis=0)
    return a


def _lift1d(a: np.ndarray, i0: int, transform: int,
            axis: int) -> np.ndarray:
    """Inverse 1D lifting over axis with global offset parity (T.800
    F.3.8 symmetric extension via reflect padding)."""
    if axis == 0:
        a = a.T
        out = _lift1d(a, i0, transform, axis=1)
        return out.T
    n = a.shape[1]
    if n == 1:
        # Single-sample line: pass-through (scaled for the odd-start
        # 5/3 case per F.3.7; for 9/7 openjpeg uses the same rule).
        if i0 % 2 == 1:
            return a / 2.0 if transform == 1 else a
        return a
    # Work on an extended array so boundary taps use full symmetric
    # extension (period 2n-2, folded — lines shorter than the pad need
    # multiple reflections).  The pad must out-reach the lifting
    # cascade: each of the (up to four) steps lets a wrong outermost
    # value creep one position inward, so ext > steps keeps the output
    # region clean.
    ext = 6
    idx = np.arange(-ext, n + ext)
    period = 2 * (n - 1)
    m = np.mod(idx, period)
    ref = np.where(m >= n, period - m, m)
    x = a[:, ref]
    pos = i0 + np.arange(-ext, n + ext)
    even = (pos % 2 == 0)
    if transform == 1:
        # 5/3 reversible (F.3.8.2.1): x[2n] -= floor((x[2n-1] +
        # x[2n+1] + 2) / 4); x[2n+1] += floor((x[2n] + x[2n+2]) / 2).
        y = x.copy()
        left = np.roll(x, 1, axis=1)
        right = np.roll(x, -1, axis=1)
        upd = np.floor((left + right + 2) / 4.0)
        y = np.where(even[None, :], x - upd, y)
        yl = np.roll(y, 1, axis=1)
        yr = np.roll(y, -1, axis=1)
        pred = np.floor((yl + yr) / 2.0)
        y = np.where(~even[None, :], x + pred, y)
        return y[:, ext:ext + n]
    # 9/7 irreversible synthesis (T.800 F.4.8.2): scale low by K, high
    # by 1/K, then lifting steps -delta (even), -gamma (odd),
    # +beta (even), +alpha (odd) — each step reads already-updated
    # neighbors, symmetric extension at the borders.
    K = 1.230174104914001
    alpha, beta, gamma, delta = (1.586134342059924, 0.052980118572961,
                                 0.882911075530934, 0.443506852043971)
    y = np.where(even[None, :], x * K, x / K)
    for coef, on_even in ((-delta, True), (-gamma, False),
                          (beta, True), (alpha, False)):
        left = np.roll(y, 1, axis=1)
        right = np.roll(y, -1, axis=1)
        tgt = even if on_even else ~even
        y = np.where(tgt[None, :], y + coef * (left + right), y)
    return y[:, ext:ext + n]


# ------------------------------------------------------------------ MCT

def _inverse_rct(y, u, v):
    """T.800 G.2: comp1 = B - G, comp2 = R - G."""
    g = y - np.floor((u + v) / 4.0)
    r = v + g
    b = u + g
    return [r, g, b]


def _inverse_ict(y, cb, cr):
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return [r, g, b]


# ------------------------------------------------------------ public API

def _find_codestream(data: bytes) -> bytes:
    """Raw J2K passes through; JP2 box files yield their ``jp2c`` box."""
    if data[:2] == b"\xff\x4f":
        return data
    if data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n":
        pos = 12
        while pos + 8 <= len(data):
            lbox = struct.unpack(">I", data[pos:pos + 4])[0]
            tbox = data[pos + 4:pos + 8]
            if lbox == 1:
                xl = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
                body_start, box_end = pos + 16, pos + xl
            elif lbox == 0:
                body_start, box_end = pos + 8, len(data)
            else:
                body_start, box_end = pos + 8, pos + lbox
            if tbox == b"jp2c":
                return data[body_start:box_end]
            if box_end <= pos:
                break
            pos = box_end
        raise Jp2kError("JP2 file has no codestream box")
    raise Jp2kError("not a JPEG 2000 stream (no SOC / JP2 signature)")


def _jp2k_error_contract(fn):
    """Everything malformed must surface as :class:`Jp2kError` (a
    ValueError): these streams come from untrusted files, and server
    error mapping turns ValueError into a 4xx instead of a 500.  The
    explicit checks cover the known shapes; this net catches residual
    IndexError/struct.error/AttributeError/etc from hostile input
    (same pattern as jpegdec's _jpeg_error_contract)."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (IndexError, KeyError, AttributeError, struct.error,
                OverflowError, MemoryError, ZeroDivisionError) as e:
            raise Jp2kError(f"malformed JPEG 2000 stream: {e}") from e
    return wrapped


@_jp2k_error_contract
def decode_jp2k(data: bytes) -> np.ndarray:
    """Decode a JPEG 2000 codestream (raw J2K or JP2 file) to
    ``[h, w, ncomp]``."""
    return _Decoder(_find_codestream(bytes(data))).decode()


@_jp2k_error_contract
def decode_tiff_jp2k(data: bytes, compression: int,
                     photometric: int) -> np.ndarray:
    """Decode one TIFF 33003/33005 segment (a raw J2K codestream, the
    Aperio layout) to ``u8/u16[h, w, spp]``.

    33003 stores YCbCr planes with the codestream's own MCT off
    (openslide's AperioJp2kYCbCr); the color transform happens here.
    33005 (and MCT-on streams) come back as stored.
    """
    dec = _Decoder(_find_codestream(bytes(data)))
    out = dec.decode()
    wants_ycc = compression == 33003 or photometric == 6
    if wants_ycc and out.shape[-1] == 3 and not dec.cod.mct:
        if out.dtype.itemsize != 1:
            # ycbcr_to_rgb is 8-bit; clipping deeper data would serve
            # silently saturated garbage.
            raise Jp2kError(
                f"{out.dtype.itemsize * 8}-bit YCbCr JPEG 2000 is not "
                f"supported (8-bit only)")
        from .jpegdec import ycbcr_to_rgb
        out = ycbcr_to_rgb(out.astype(np.uint8))
    return out
