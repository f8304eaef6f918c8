"""Shared Huffman tables and JFIF framing for the device Huffman wire.

The port's copy of the parts of the JAX package's ``jfif.py`` that the
Huffman engine (``ops.jpegenc``, K5) needs:

* :func:`fixed_huffman_spec`: one DC and one AC table for all three
  components, built from a smoothed synthetic frequency profile (ITU T.81
  Annex K.2 construction), so the device can code a tile in one pass;
* :func:`symbol_frequencies` and :func:`tuned_huffman_spec`: tables tuned
  to a workload's measured symbols, every legal symbol keeping a code and
  the ZRL code held to 10 bits or less (K5 folds up to three ZRL codes
  into one 30-bit field);
* :func:`finish_fixed_stream` and :func:`finish_stream_with_spec`: the
  host tail, the device's u32 words truncated to the stream's bits,
  1-padded, 0xFF-stuffed and framed (SOI, JFIF, DQT, SOF0, DHT, SOS, EOI).

A spec is the 8-tuple ``(dc_bits, dc_vals, dc_code, dc_len, ac_bits,
ac_vals, ac_code, ac_len)``; the code and length arrays are indexed by
symbol.  Left out: the JAX package's pure-Python dense coder
(``encode_jfif``); the port's dense fallback is the native coder
(``native.jpeg_encode``).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

from .ops.jpegenc import quant_tables, zigzag_order

# ------------------------------------------------------- huffman (K.2)


def _code_sizes(freq: np.ndarray) -> np.ndarray:
    """T.81 K.2 figure K.1: the code length of each symbol from its
    frequency.  ``freq`` has 257 entries; 256 is the reserved
    pseudo-symbol of frequency 1 that keeps any real symbol off the
    all-ones code."""
    freq = freq.astype(np.int64).copy()
    codesize = np.zeros(257, dtype=np.int32)
    others = np.full(257, -1, dtype=np.int32)
    while True:
        nz = np.nonzero(freq > 0)[0]
        if len(nz) < 2:
            break
        # v1: the least frequent symbol, ties to the largest value.
        f = freq[nz]
        v1 = nz[np.flatnonzero(f == f.min())[-1]]
        rest = nz[nz != v1]
        f2 = freq[rest]
        v2 = rest[np.flatnonzero(f2 == f2.min())[-1]]
        freq[v1] += freq[v2]
        freq[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = others[v1]
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = others[v2]
            codesize[v2] += 1
    return codesize


def _limit_to_16(bits: np.ndarray) -> np.ndarray:
    """T.81 K.2 figure K.3 (ADJUST_BITS): code lengths capped at 16, then
    the reserved pseudo-symbol's code removed."""
    bits = bits.copy()
    i = len(bits) - 1
    while i > 16:
        if bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        else:
            i -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    return bits


def build_huffman_table(freq256: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal baseline table -> ``(bits i32[17], huffval)``: the count
    of codes of each length (index 0 unused) and the symbols ordered by
    (length, value), the DHT payload."""
    freq = np.zeros(257, dtype=np.int64)
    freq[:256] = freq256
    freq[256] = 1
    codesize = _code_sizes(freq)
    bits = np.zeros(33, dtype=np.int32)
    for size in codesize[codesize > 0]:
        bits[size] += 1
    bits = _limit_to_16(bits)[:17]
    order = np.argsort(codesize[:256] * 256 + np.arange(256), kind="stable")
    huffval = np.array([s for s in order if codesize[s] > 0],
                       dtype=np.uint8)
    return bits, huffval


def _codes_from_table(bits: np.ndarray, huffval: np.ndarray):
    """Canonical code assignment -> ``(code[symbol] u32[256],
    length[symbol] i32[256])``."""
    code_of = np.zeros(256, dtype=np.uint32)
    len_of = np.zeros(256, dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(int(bits[length])):
            code_of[huffval[k]] = code
            len_of[huffval[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


@functools.lru_cache(maxsize=1)
def fixed_huffman_spec():
    """The shared tables of a one-pass device coder: small runs and small
    magnitudes dominate the profile, and every legal symbol has a count,
    so every symbol has a code.  One DC and one AC table serve all three
    components."""
    dc_freq = np.zeros(256, dtype=np.int64)
    for s in range(12):
        dc_freq[s] = 1 + (1 << max(0, 14 - 2 * s))
    ac_freq = np.zeros(256, dtype=np.int64)
    for run in range(16):
        for size in range(1, 11):
            ac_freq[(run << 4) | size] = 1 + (1 << max(0, 18 - run - 2 * size))
    ac_freq[0x00] = 1 << 17   # EOB
    ac_freq[0xF0] = 1 << 8    # ZRL
    dc_bits, dc_vals = build_huffman_table(dc_freq)
    ac_bits, ac_vals = build_huffman_table(ac_freq)
    dc_code, dc_len = _codes_from_table(dc_bits, dc_vals)
    ac_code, ac_len = _codes_from_table(ac_bits, ac_vals)
    return (dc_bits, dc_vals, dc_code, dc_len,
            ac_bits, ac_vals, ac_code, ac_len)


def tuned_huffman_spec(dc_freq: np.ndarray, ac_freq: np.ndarray):
    """A spec tuned to measured symbol frequencies, the 8-tuple of
    :func:`fixed_huffman_spec`.  The tables serve the workload's later
    tiles, so every legal symbol keeps a code: the counts are scaled by
    256 and each legal symbol (DC categories 0-11; AC sizes 1-10 at every
    run, EOB and ZRL) gets one more.  The ZRL code is held to 10 bits or
    less, since K5 folds up to three ZRL codes into one 30-bit field: its
    count is raised until the bound holds."""
    dc = np.zeros(256, dtype=np.int64)
    for s in range(12):
        dc[s] = 1 + (int(dc_freq[s]) << 8)
    ac = np.zeros(256, dtype=np.int64)
    for run in range(16):
        for size in range(1, 11):
            sym = (run << 4) | size
            ac[sym] = 1 + (int(ac_freq[sym]) << 8)
    ac[0x00] = 1 + (int(ac_freq[0x00]) << 8)   # EOB
    ac[0xF0] = 1 + (int(ac_freq[0xF0]) << 8)   # ZRL
    dc_bits, dc_vals = build_huffman_table(dc)
    dc_code, dc_len = _codes_from_table(dc_bits, dc_vals)
    for _ in range(32):
        ac_bits, ac_vals = build_huffman_table(ac)
        ac_code, ac_len = _codes_from_table(ac_bits, ac_vals)
        if int(ac_len[0xF0]) <= 10:
            break
        ac[0xF0] = max(ac[0xF0] * 4, 16)
    else:                               # pragma: no cover - 4^32 floor
        raise AssertionError("ZRL code would not converge to <= 10 bits")
    return (dc_bits, dc_vals, dc_code, dc_len,
            ac_bits, ac_vals, ac_code, ac_len)


# ------------------------------------------------------- symbol stream

def _category(v: int) -> int:
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def _block_symbols(block: np.ndarray, pred: int):
    """One zigzagged block -> ``(dc symbol, dc difference, [(ac symbol,
    value), ...])``."""
    dc_diff = int(block[0]) - pred
    acs = []
    nz = np.nonzero(block[1:])[0]
    last = -1
    for idx in nz:
        run = int(idx) - last - 1
        last = int(idx)
        while run >= 16:
            acs.append((0xF0, 0))
            run -= 16
        v = int(block[1 + idx])
        acs.append(((run << 4) | _category(v), v))
    if last != 62:
        acs.append((0x00, 0))  # EOB
    return _category(dc_diff), dc_diff, acs


def _component_symbols(blocks: Sequence[np.ndarray]):
    """Blocks in order -> per-block symbol records and the DC and AC
    frequency tables."""
    dc_freq = np.zeros(256, dtype=np.int64)
    ac_freq = np.zeros(256, dtype=np.int64)
    records = []
    pred = 0
    for block in blocks:
        dc_sym, dc_val, acs = _block_symbols(block, pred)
        pred = int(block[0])
        dc_freq[dc_sym] += 1
        for sym, _ in acs:
            ac_freq[sym] += 1
        records.append((dc_sym, dc_val, acs))
    return records, dc_freq, ac_freq


def symbol_frequencies(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """``(dc_freq, ac_freq)`` of one tile's zigzag blocks, each component
    walked in its array's (raster) order, for :func:`tuned_huffman_spec`
    (all three components share one DC and one AC table, as K5 codes
    them)."""
    dc = np.zeros(256, dtype=np.int64)
    ac = np.zeros(256, dtype=np.int64)
    for comp in (y, cb, cr):
        _, dcf, acf = _component_symbols(list(comp))
        dc += dcf
        ac += acf
    return dc, ac


# ------------------------------------------------------------- framing

def _marker(tag: int, payload: bytes) -> bytes:
    return bytes([0xFF, tag]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht_payload(cls: int, ident: int, bits: np.ndarray,
                 huffval: np.ndarray) -> bytes:
    return (bytes([(cls << 4) | ident])
            + bytes(int(bits[i]) for i in range(1, 17))
            + huffval.tobytes())


def _frame_markers(width: int, height: int, quality: int) -> bytes:
    """SOI through SOF0 (everything before the Huffman tables)."""
    qy, qc = quant_tables(quality)
    zig = zigzag_order()
    out = bytearray()
    out += b"\xff\xd8"  # SOI
    out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _marker(0xDB, bytes([0]) + qy.reshape(-1)[zig].tobytes())
    out += _marker(0xDB, bytes([1]) + qc.reshape(-1)[zig].tobytes())
    out += _marker(0xC0, bytes([8])                       # SOF0: baseline
                   + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                   + bytes([3,
                            1, 0x22, 0,     # Y: 2x2 sampling, qtable 0
                            2, 0x11, 1,     # Cb: 1x1, qtable 1
                            3, 0x11, 1]))   # Cr
    return bytes(out)


_SOS = _marker(0xDA, bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0]))


@functools.lru_cache(maxsize=64)
def fixed_header_bytes(width: int, height: int, quality: int) -> bytes:
    """SOI..SOF0, the fixed spec's two DHTs and SOS: all three components
    reference DC and AC table 0."""
    dc_bits, dc_vals, _, _, ac_bits, ac_vals, _, _ = fixed_huffman_spec()
    return (_frame_markers(width, height, quality)
            + _marker(0xC4, _dht_payload(0, 0, dc_bits, dc_vals))
            + _marker(0xC4, _dht_payload(1, 0, ac_bits, ac_vals)) + _SOS)


@functools.lru_cache(maxsize=64)
def _spec_header_cached(width: int, height: int, quality: int,
                        dht: bytes) -> bytes:
    return _frame_markers(width, height, quality) + dht + _SOS


def spec_header_bytes(width: int, height: int, quality: int,
                      spec) -> bytes:
    """The header of a stream coded with ``spec``'s shared tables."""
    dc_bits, dc_vals, _, _, ac_bits, ac_vals, _, _ = spec
    dht = (_marker(0xC4, _dht_payload(0, 0, dc_bits, dc_vals))
           + _marker(0xC4, _dht_payload(1, 0, ac_bits, ac_vals)))
    return _spec_header_cached(width, height, quality, dht)


def _entropy_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """The device's u32 words (stream bit 0 at the MSB of word 0) -> the
    entropy segment: big-endian bytes cut to ``total_bits``, the last
    byte 1-padded, every 0xFF followed by 0x00."""
    n_bytes = (int(total_bits) + 7) // 8
    data = bytearray(np.ascontiguousarray(words).astype("<u4").byteswap()
                     .tobytes()[:n_bytes])
    pad = n_bytes * 8 - int(total_bits)
    if n_bytes:
        data[-1] |= (1 << pad) - 1
    return bytes(data).replace(b"\xff", b"\xff\x00")


def finish_fixed_stream(words: np.ndarray, total_bits: int, width: int,
                        height: int, quality: int = 85) -> bytes:
    """A stream packed with the fixed spec -> a complete JFIF file."""
    return (fixed_header_bytes(width, height, quality)
            + _entropy_bytes(words, total_bits) + b"\xff\xd9")


def finish_stream_with_spec(words: np.ndarray, total_bits: int,
                            width: int, height: int, quality: int,
                            spec) -> bytes:
    """A stream packed with ``spec``'s tables -> a complete JFIF file
    whose DHTs declare them."""
    return (spec_header_bytes(width, height, quality, spec)
            + _entropy_bytes(words, total_bits) + b"\xff\xd9")
