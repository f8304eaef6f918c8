"""Writers of the TIFF layouts the port's reader tests read through both
packages (not a test module).

:func:`write_tiff` writes one classic or BigTIFF file of chunky pages with
the JAX package's ``_TiffOut`` (tiled or stripped; none, deflate, LZW,
PackBits or JPEG; predictors 2 and 3; reduced-resolution pages).  The
encoders here are plain Python: :func:`lzw_encode` is TIFF 6.0 section 13
(MSB-first codes, early code-width change), :func:`packbits_encode` the
section 9 run coder, :func:`float_predictor_encode` TIFF Technical Note 3.
:func:`jpeg12_stream` is a one-block 12-bit extended-sequential JPEG (SOF1)
whose DC sets the block's level.
"""

import struct
import zlib

import numpy as np

from omero_ms_image_region_tpu.io.tiffwrite import _TiffOut

BYTE, ASCII, SHORT, LONG, LONG8 = 1, 2, 3, 4, 16


def lzw_encode(data: bytes) -> bytes:
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def emit(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    emit(256)                                     # ClearCode
    cur = b""
    for b in data:
        nxt = cur + bytes([b])
        if nxt in table:
            cur = nxt
            continue
        emit(table[cur])
        table[nxt] = len(table) + 2               # 256, 257 reserved
        cur = bytes([b])
        # The decoder's table trails ours by one entry (len + 1 of ours);
        # it widens its codes once that reaches 2^width - 1.
        if len(table) + 1 >= (1 << width) - 1:
            if width == 12:
                emit(256)
                table = {bytes([i]): i for i in range(256)}
                width = 9
            else:
                width += 1
    if cur:
        emit(table[cur])
        if len(table) + 2 >= (1 << width) - 1 and width < 12:
            width += 1
    emit(257)                                     # EOI
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def float_predictor_encode(seg: np.ndarray) -> bytes:
    """[h, w, spp] floats -> predictor-3 bytes (byte planes of the big-
    endian values, most significant first, differenced along the row in
    stride-spp chains)."""
    h, w, spp = seg.shape
    n = w * spp
    be = seg.astype(seg.dtype.newbyteorder(">")).reshape(h, n)
    planes = be.view(np.uint8).reshape(h, n, seg.dtype.itemsize)
    rows = np.ascontiguousarray(planes.transpose(0, 2, 1)).reshape(h, -1)
    chains = rows.reshape(h, -1, spp)
    diff = chains.copy()
    diff[:, 1:] = chains[:, 1:] - chains[:, :-1]
    return diff.reshape(h, -1).tobytes()


def _segments(page, tiled, tile, rows_per_strip):
    h, w = page.shape[:2]
    if tiled:
        th, tw = tile
        for gy in range(-(-h // th)):
            for gx in range(-(-w // tw)):
                seg = np.zeros((th, tw) + page.shape[2:], page.dtype)
                part = page[gy * th:(gy + 1) * th, gx * tw:(gx + 1) * tw]
                seg[:part.shape[0], :part.shape[1]] = part
                yield seg
    else:
        for y in range(0, h, rows_per_strip):
            yield page[y:y + rows_per_strip]


def _encode(seg, compression, predictor, endian="<"):
    seg = seg if seg.ndim == 3 else seg[..., None]
    if predictor == 3:
        raw = float_predictor_encode(seg)
    else:
        if predictor == 2:
            seg = seg.copy()
            seg[:, 1:] = seg[:, 1:] - seg[:, :-1]    # wraps like the spec
        raw = np.ascontiguousarray(seg).astype(
            seg.dtype.newbyteorder(endian)).tobytes()
    if compression == 8:
        return zlib.compress(raw, 6)
    if compression == 5:
        return lzw_encode(raw)
    if compression == 32773:
        return packbits_encode(raw)
    return raw


def write_tiff(path, pages, *, tiled=True, tile=(64, 64),
               rows_per_strip=16, compression=1, predictor=1,
               bigtiff=False, photometric=1, description=None,
               reduced=(), segments=None, bits=None, jpeg_tables=None,
               interchange=False):
    """Write ``pages`` ([h, w] or [h, w, spp] arrays) as one TIFF.

    ``reduced`` holds the indices of pages flagged NewSubfileType=1;
    ``segments`` (one list per page) replaces the encoded tile or strip
    bytes (a JPEG page); ``bits`` overrides BitsPerSample (12 for a 12-bit
    JPEG page); ``interchange`` points tags 513/514 at each page's first
    segment (old-style JPEG, compression 6)."""
    with open(path, "wb") as f:
        out = _TiffOut(f, bigtiff)
        off_type = LONG8 if bigtiff else LONG
        layouts = []
        for i, page in enumerate(pages):
            encoded = (segments[i] if segments is not None else
                       [_encode(s, compression, predictor) for s in
                        _segments(page, tiled, tile, rows_per_strip)])
            offs, cnts = [], []
            for data in encoded:
                out.align()
                offs.append(out.write(data))
                cnts.append(len(data))
            layouts.append((offs, cnts))
        prev_next, first = None, None
        for i, (page, (offs, cnts)) in enumerate(zip(pages, layouts)):
            h, w = page.shape[:2]
            spp = page.shape[2] if page.ndim == 3 else 1
            dt = page.dtype
            tags = [
                (256, LONG, [w]), (257, LONG, [h]),
                (258, SHORT, [bits or dt.itemsize * 8] * spp),
                (259, SHORT, [compression]), (262, SHORT, [photometric]),
                (277, SHORT, [spp]), (284, SHORT, [1]),
                (317, SHORT, [predictor]),
                (339, SHORT, [{"u": 1, "i": 2, "f": 3}[dt.kind]] * spp),
            ]
            if tiled:
                tags += [(322, LONG, [tile[1]]), (323, LONG, [tile[0]]),
                         (324, off_type, offs), (325, off_type, cnts)]
            else:
                tags += [(278, LONG, [rows_per_strip]),
                         (273, off_type, offs), (279, off_type, cnts)]
            if i in reduced:
                tags.append((254, LONG, [1]))
            if i == 0 and description is not None:
                tags.append((270, ASCII, description.encode()))
            if interchange:
                tags += [(513, LONG, offs[:1]), (514, LONG, cnts[:1])]
            if jpeg_tables is not None:
                tags.append((347, BYTE, list(jpeg_tables)))
            ifd, next_pos = out.write_ifd(tags)
            if first is None:
                first = ifd
            else:
                out.patch(prev_next, ifd)
            prev_next = next_pos
        out.patch_first_ifd(first)
    return path


def _seg(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def jpeg12_stream(diff: int) -> bytes:
    """An 8x8 12-bit SOF1 frame of one block whose DC difference is
    ``diff`` (0 <= diff < 1024): every sample decodes to diff // 8 +
    2048."""
    dqt = _seg(0xDB, bytes([0x10]) + b"\x00\x01" * 64)
    dht_dc = _seg(0xC4, bytes([0x00]) + bytes([1] + [0] * 15) + bytes([10]))
    dht_ac = _seg(0xC4, bytes([0x10]) + bytes([1] + [0] * 15) + bytes([0]))
    sof = _seg(0xC1, bytes([12]) + struct.pack(">HH", 8, 8)
               + bytes([1, 1, 0x11, 0]))
    sos = _seg(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
    bits = "0" + format(diff, "010b") + "0"
    bits += "1" * (-len(bits) % 8)
    entropy = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return (b"\xff\xd8" + dqt + dht_dc + dht_ac + sof + sos + entropy
            + b"\xff\xd9")


def split_jpeg_tables(jfif: bytes):
    """(tables, abbreviated stream) of a JFIF: the DQT and DHT segments
    move to an SOI..EOI tables stream (TIFF tag 347); the stream keeps the
    rest."""
    tables, stream, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while True:
        marker = jfif[pos + 1]
        if marker == 0xDA:                     # SOS: the rest is the scan
            stream += jfif[pos:]
            break
        n = struct.unpack(">H", jfif[pos + 2:pos + 4])[0]
        seg = jfif[pos:pos + 2 + n]
        (tables if marker in (0xDB, 0xC4) else stream).extend(seg)
        pos += 2 + n
    return bytes(tables + b"\xff\xd9"), bytes(stream)
