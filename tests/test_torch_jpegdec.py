"""The port's JPEG decoders and native bit codecs against the JAX
package's.

Streams: baseline 4:2:0 and 4:4:4, grayscale, progressive, restart
markers, an abbreviated stream with its JPEGTables and a 12-bit frame,
each through ``decode_tiff_jpeg`` with photometric 1 (raw components) and,
for three components, 6 (YCbCr -> RGB).  Byte for byte: the port's native
decoder against the JAX package's ``decode_tiff_jpeg`` (which takes its
native decoder for 8-bit frames), and the port's Python decoder
(``decode_baseline_jpeg`` and ``ycbcr_to_rgb``, the plain version) against
the JAX package's.  The two decoders differ from each other only by their
IDCT rounding: at most 1 per raw component (2 after the colour transform),
as in the JAX package's own test of its decoders.

The LZW and ``bits_unpack_msb`` bindings are held against the JAX
package's bindings and its Python LZW decoder.
"""

import io

import numpy as np
import pytest
from PIL import Image

from omero_ms_image_region_tpu import native as jax_native
from omero_ms_image_region_tpu.io.jpegdec import (
    decode_baseline_jpeg as jax_python_decode)
from omero_ms_image_region_tpu.io.jpegdec import (
    decode_tiff_jpeg as jax_decode_tiff_jpeg)
from omero_ms_image_region_tpu.io.jpegdec import parse_jpeg_tables
from omero_ms_image_region_tpu.io.jpegdec import (
    ycbcr_to_rgb as jax_ycbcr_to_rgb)
from omero_ms_image_region_tpu.io.tiff import _lzw_decode as jax_lzw_python
from omero_ms_image_region_tpu_torch import native
from omero_ms_image_region_tpu_torch.io.jpegdec import (
    JpegError, decode_baseline_jpeg, decode_tiff_jpeg)
from omero_ms_image_region_tpu_torch.io.jpegdec import (
    parse_jpeg_tables as port_parse_jpeg_tables)
from omero_ms_image_region_tpu_torch.io.jpegdec import ycbcr_to_rgb
from omero_ms_image_region_tpu_torch.io.tiff import _lzw_decode

from torch_tiff_fixtures import jpeg12_stream, lzw_encode, split_jpeg_tables
from vendor_tiff import smooth_rgb


def _jfif(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "jpeg", **kw)
    return buf.getvalue()


def _content(h, w, seed):
    """Smooth colour with noise: both smooth regions (where the IDCTs
    round apart) and busy ones."""
    noise = np.random.default_rng(seed).integers(-24, 24, (h, w, 3))
    return (smooth_rgb(h, w).astype(np.int16) + noise).clip(0, 255) \
        .astype(np.uint8)


def _abbreviated():
    tables, stream = split_jpeg_tables(_jfif(_content(64, 80, 5),
                                             quality=80))
    return stream, tables


STREAMS = {
    "baseline_420": lambda: (_jfif(_content(72, 88, 1), quality=85), None),
    "baseline_444": lambda: (_jfif(_content(72, 88, 2), quality=90,
                                   subsampling=0), None),
    "grayscale": lambda: (_jfif(_content(50, 70, 3)[..., 0]), None),
    "progressive": lambda: (_jfif(_content(61, 83, 4), quality=80,
                                  progressive=True), None),
    "restart_markers": lambda: (_jfif(_content(64, 96, 6),
                                      restart_marker_rows=1), None),
    "abbreviated_with_tables": _abbreviated,
}


def _jax_python(data, tables, photometric):
    ts = parse_jpeg_tables(tables) if tables else None
    out = jax_python_decode(data, ts)
    return jax_ycbcr_to_rgb(out) if photometric == 6 else out


@pytest.mark.parametrize("photometric", [1, 6])
@pytest.mark.parametrize("name", list(STREAMS))
def test_decoders_match_jax(name, photometric):
    data, tables = STREAMS[name]()
    if name == "restart_markers":
        assert b"\xff\xdd" in data
    if name == "abbreviated_with_tables":
        assert b"\xff\xc4" not in data and b"\xff\xc4" in tables
    if name == "grayscale" and photometric == 6:
        with pytest.raises(JpegError, match="YCbCr"):
            decode_tiff_jpeg(data, tables, photometric)
        return
    want = jax_decode_tiff_jpeg(data, tables, photometric)
    got = decode_tiff_jpeg(data, tables, photometric)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    plain = decode_baseline_jpeg(
        data, port_parse_jpeg_tables(tables) if tables else None)
    if photometric == 6:
        plain = ycbcr_to_rgb(plain)
    assert np.array_equal(plain, _jax_python(data, tables, photometric))
    limit = 2 if photometric == 6 else 1
    assert np.abs(plain.astype(int) - got.astype(int)).max() <= limit


def test_twelve_bit_frames_take_the_python_decoder():
    data = jpeg12_stream(1000)
    got = decode_tiff_jpeg(data, None, 1)
    assert got.dtype == np.uint16
    assert np.array_equal(got, jax_decode_tiff_jpeg(data, None, 1))
    assert int(got[0, 0, 0]) == 1000 // 8 + 2048
    with pytest.raises(ValueError):
        native.jpeg_decode_baseline(data, None)


def test_native_decoder_refuses_what_jax_refuses():
    data = _jfif(_content(32, 32, 7))
    for bad in (data[:40], b"\xff\xd8garbage", data[:-200]):
        with pytest.raises(ValueError):
            jax_native.jpeg_decode_baseline(bad, None)
        with pytest.raises(ValueError):
            native.jpeg_decode_baseline(bad, None)


@pytest.mark.parametrize("kind", ["random", "runs", "empty"])
def test_lzw_binding_matches_jax(kind):
    rng = np.random.default_rng(8)
    data = {"random": rng.integers(0, 256, 20000, dtype=np.uint8),
            "runs": np.repeat(rng.integers(0, 5, 3000, dtype=np.uint8), 9),
            "empty": np.zeros(0, np.uint8)}[kind].tobytes()
    stream = lzw_encode(data)
    got = native.tiff_lzw_decode(stream, len(data))
    assert got == jax_native.tiff_lzw_decode(stream, len(data)) == data
    assert _lzw_decode(stream) == jax_lzw_python(stream) == data
    if data:
        # A short cap is refused by both bindings.
        with pytest.raises(ValueError):
            native.tiff_lzw_decode(stream, len(data) - 1)
        with pytest.raises(ValueError):
            jax_native.tiff_lzw_decode(stream, len(data) - 1)


@pytest.mark.parametrize("n_bits", [0, 1, 13, 64, 1001])
def test_bits_unpack_msb_matches_jax(n_bits):
    data = np.random.default_rng(n_bits).integers(
        0, 256, (n_bits + 7) // 8 + 2, dtype=np.uint8).tobytes()
    got = native.unpack_bits_msb(data, n_bits)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jax_native.unpack_bits_msb(data, n_bits))
    assert np.array_equal(got, np.unpackbits(np.frombuffer(
        data, np.uint8))[:n_bits])
