"""The port's JPEG 2000 decoder against the JAX package's, bit for bit.

Codestreams made with Pillow (OpenJPEG) at the JAX tests' small sizes are
decoded by the JAX ``decode_jp2k`` and by the port's, and held
``np.array_equal`` (dtype included): lossless 5/3 and lossy 9/7, tiled,
each progression order, quality layers, explicit precincts, small
code-blocks, 16-bit, MCT on and off, a raw J2K file, truncations, and
subsampled components (the JAX test's decoder-internals route, on both).
Hostile headers and the error contract raise the same error class with the
same message in both.  The port's native tier-1 equals its Python tier-1
code-block by code-block, and 33003 (YCbCr) and 33005 (RGB) TIFF regions
read equal through both packages' ``OmeTiffSource``.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import omero_ms_image_region_tpu.io.jp2k as jax_jp2k
import omero_ms_image_region_tpu_torch.io.jp2k as jp2k
from omero_ms_image_region_tpu.io.ometiff import OmeTiffSource as JaxTiff
from omero_ms_image_region_tpu_torch.io.ometiff import OmeTiffSource
from omero_ms_image_region_tpu_torch.server.region import RegionDef

from vendor_tiff import smooth_rgb, write_jp2k_tiff


def _enc(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _noise(seed, shape, dtype=np.uint8, high=256):
    return np.random.default_rng(seed).integers(0, high, shape, dtype=dtype)


STREAMS = {
    "gray_5x3_17x13": lambda: _enc(_noise(1, (17, 13)),
                                   irreversible=False),
    "gray_5x3_33x70": lambda: _enc(_noise(2, (33, 70)),
                                   irreversible=False),
    "rgb_5x3": lambda: _enc(_noise(3, (48, 80, 3)), irreversible=False),
    "rgb_5x3_layers": lambda: _enc(_noise(4, (40, 40, 3)),
                                   irreversible=False,
                                   quality_layers=[40, 20, 0]),
    "rgb_5x3_tiled": lambda: _enc(_noise(5, (48, 80, 3)),
                                  irreversible=False, tile_size=(32, 32)),
    "rgb_5x3_precincts": lambda: _enc(_noise(6, (48, 80, 3)),
                                      irreversible=False,
                                      precinct_size=(64, 64)),
    "gray_5x3_cb16": lambda: _enc(_noise(7, (48, 80)), irreversible=False,
                                  codeblock_size=(16, 16)),
    "gray_9x7": lambda: _enc((np.mgrid[0:64, 0:96][1] * 255 // 95)
                             .astype(np.uint8), irreversible=True),
    "rgb_9x7": lambda: _enc(smooth_rgb(64, 96), irreversible=True),
    "rgb_9x7_noise": lambda: _enc(_noise(9, (40, 56, 3)),
                                  irreversible=True),
    "rgb_9x7_rate": lambda: _enc(smooth_rgb(64, 96), irreversible=True,
                                 quality_layers=[30]),
    "rgb_9x7_tiled": lambda: _enc(smooth_rgb(64, 96), irreversible=True,
                                  tile_size=(32, 32)),
    "rct_mct": lambda: _enc(_noise(14, (40, 64, 3)), irreversible=False,
                            mct=1),
    "ict_mct": lambda: _enc(smooth_rgb(64, 96), irreversible=True, mct=1),
    "gray16_5x3": lambda: _enc(_noise(11, (32, 40), np.uint16, 65535),
                               irreversible=False),
    **{f"order_{o}": (lambda o=o: _enc(_noise(10, (48, 64, 3)),
                                       irreversible=False, progression=o))
       for o in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_equals_jax(name):
    data = STREAMS[name]()
    want = jax_jp2k.decode_jp2k(data)
    got = jp2k.decode_jp2k(data)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_raw_codestream_and_truncations_equal_jax(tmp_path):
    """A raw .j2k file (no JP2 box); then cuts of a stream: each decodes
    to the JAX result (a progressive stream degrades) or fails alike."""
    path = str(tmp_path / "x.j2k")
    Image.fromarray(_noise(8, (32, 32))).save(path, irreversible=False)
    data = open(path, "rb").read()
    assert data[:2] == b"\xff\x4f"
    assert np.array_equal(jp2k.decode_jp2k(data), jax_jp2k.decode_jp2k(data))
    data = _enc(_noise(12, (32, 32)), irreversible=False)
    for cut in (1, 2, 10, 40, len(data) // 2, len(data) - 4):
        outcomes = []
        for mod in (jax_jp2k, jp2k):
            try:
                outcomes.append(("ok", mod.decode_jp2k(data[:cut])))
            except ValueError as e:
                outcomes.append((type(e).__name__, str(e)))
        if outcomes[0][0] == "ok":
            assert outcomes[1][0] == "ok"
            assert np.array_equal(outcomes[0][1], outcomes[1][1])
        else:
            assert outcomes[0] == outcomes[1]


def _siz_stream(xsiz, ysiz, xtsiz, ytsiz, comps=1, depth=7):
    siz = struct.pack(">HIIIIIIIIH", 0, xsiz, ysiz, 0, 0, xtsiz, ytsiz,
                      0, 0, comps) + bytes([depth, 1, 1]) * comps
    return b"\xff\x4f\xff\x51" + struct.pack(">H", 2 + len(siz)) + siz


def _tile_part_local_cod():
    data = jax_jp2k._find_codestream(_enc(_noise(17, (16, 16)),
                                          irreversible=False))
    sot = data.index(b"\xff\x90")
    sod = data.index(b"\xff\x93", sot)
    cod = (b"\xff\x52" + struct.pack(">H", 12)
           + bytes([0, 0, 0, 1, 0, 1, 4, 4, 0, 1]))
    spliced = data[:sod] + cod + data[sod:]
    _, psot = struct.unpack(">HI", spliced[sot + 4:sot + 10])
    return (spliced[:sot + 6] + struct.pack(">I", psot + len(cod))
            + spliced[sot + 10:])


HOSTILE = {
    "huge_area": lambda: _siz_stream(100000, 100000, 100000, 100000),
    "huge_tile_grid": lambda: _siz_stream(10000, 10000, 1, 1),
    "component_count": lambda: _siz_stream(1000, 1000, 1000, 1000, 100),
    "deep_components": lambda: _siz_stream(8, 8, 8, 8, 1, 37) + b"\xff\xd9",
    "tile_part_local_cod": _tile_part_local_cod,
    "qcd_even_body": lambda: (
        b"\xff\x4f\xff\x51" + struct.pack(">H", 41)
        + struct.pack(">HIIIIIIIIH", 0, 8, 8, 0, 0, 8, 8, 0, 0, 1)
        + bytes([7, 1, 1]) + b"\xff\x5c" + struct.pack(">H", 4)
        + bytes([1, 0]) + b"\xff\xd9"),
    "truncated_jp2_box": lambda: (b"\x00\x00\x00\x0cjP  \r\n\x87\n"
                                  + struct.pack(">I", 1) + b"jp2c\x00\x00"),
    "sot_without_siz": lambda: (
        b"\xff\x4f\xff\x90" + struct.pack(">H", 10)
        + struct.pack(">HIBB", 0, 14, 0, 1) + b"\xff\x93\xff\xd9"),
    "not_jp2k": lambda: b"II*\x00plainly-not",
    **{f"garbage_{n}": (lambda n=n: b"\xff\x4f\xff\x51" + _noise(
        13 + n, n).tobytes()) for n in (0, 2, 16, 256)},
}


@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_hostile_streams_fail_as_in_jax(name):
    data = HOSTILE[name]()
    errors = []
    for mod in (jax_jp2k, jp2k):
        with pytest.raises(ValueError) as e:
            mod.decode_jp2k(data)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]
    assert errors[1][0] == "Jp2kError"


def test_subsampled_components_equal_jax(monkeypatch):
    """2x2-subsampled chroma (Aperio 33003) replicated to the full grid:
    no encoder here writes one, so both decoders take the JAX test's
    route, a full-resolution stream presented as subsampled."""
    data = _enc(_noise(18, (32, 32, 3)), irreversible=False)
    outs = []
    for mod in (jax_jp2k, jp2k):
        orig = mod._Decoder._decode_tile

        def shrunk(self, t, orig=orig):
            for c in self.comps:
                c.dx = c.dy = 1
            try:
                planes = orig(self, t)
            finally:
                for c in self.comps[1:]:
                    c.dx = c.dy = 2
            return None if planes is None else [
                planes[0], planes[1][::2, ::2], planes[2][::2, ::2]]

        monkeypatch.setattr(mod._Decoder, "_decode_tile", shrunk)
        dec = mod._Decoder(mod._find_codestream(data))
        for c in dec.comps[1:]:
            c.dx = c.dy = 2
        outs.append(dec.decode())
    assert outs[0].shape == (32, 32, 3)
    assert np.array_equal(outs[0], outs[1])


def test_native_tier1_equals_python_per_block(monkeypatch):
    """Every code-block of a lossy and a lossless stream, decoded by the
    native tier-1 and by the Python one: equal; and the decode the reader
    runs counts native blocks."""
    from omero_ms_image_region_tpu_torch import native

    seen = []

    def spy(data, w, h, npasses, msbs, orient, segsym, half_at_zero):
        args = (data, w, h, npasses, msbs, orient, segsym, half_at_zero)
        out = jp2k._t1_decode(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(jp2k, "_t1", spy)
    for data in (_enc(_noise(16, (48, 48)), irreversible=True,
                      codeblock_size=(16, 16)),
                 _enc(_noise(15, (32, 48, 3)), irreversible=False)):
        python = jp2k.decode_jp2k(data)
        assert np.array_equal(python, jax_jp2k.decode_jp2k(data))
    assert len(seen) > 20
    for args, want in seen:
        assert np.array_equal(native.jp2k_t1_decode(*args), want)
    monkeypatch.undo()
    before = jp2k.T1_NATIVE_BLOCKS
    assert np.array_equal(jp2k.decode_jp2k(data), python)
    assert jp2k.T1_NATIVE_BLOCKS > before


@pytest.mark.parametrize("compression", [33003, 33005])
def test_tiff_regions_equal_jax(tmp_path, compression):
    arr = smooth_rgb(100, 150)
    path = str(tmp_path / "a.tif")
    write_jp2k_tiff(path, arr, compression, tile=64,
                    ycc=compression == 33003)
    jax, src = JaxTiff(path), OmeTiffSource(path)
    assert src.size_c == jax.size_c == 3
    for region in (RegionDef(10, 20, 80, 60), RegionDef(0, 0, 150, 100),
                   RegionDef(128, 64, 22, 36)):
        for c in range(3):
            want = jax.get_region(0, c, 0, region, 0)
            assert np.array_equal(src.get_region(0, c, 0, region, 0), want)
    if compression == 33005:       # lossless RGB tiles: the pixels back
        assert np.array_equal(
            src.get_region(0, 1, 0, RegionDef(10, 20, 80, 60), 0),
            arr[20:80, 10:90, 1])
    src.close()
    jax.close()
