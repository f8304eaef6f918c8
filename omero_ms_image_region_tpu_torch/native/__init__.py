"""The native JFIF entropy coder (``jpegenc.cpp``), built and loaded.

The C++ source is compiled with ``g++ -O3 -std=c++17 -shared -fPIC
-fopenmp`` on first use into ``_build/`` beside this file, once per source
content (an edited source rebuilds; concurrent builds agree, each writing a
private file and renaming it into place), and loaded with ``ctypes``.  A
missing compiler or a failed build raises: there is no pure-Python coder
to fall back on.

ctypes releases the GIL for the whole call, so concurrent requests entropy
code at the same time on their worker threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "jpegenc.cpp"
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class SparseOverflowError(ValueError):
    """The wire buffer dropped entries (content denser than its cap)."""


def build() -> Path:
    """Compile ``jpegenc.cpp`` into ``_build/`` unless it is built."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libjpegenc_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libjpegenc_{tag}.{os.getpid()}.tmp.so"
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native JPEG coder needs g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded coder, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.jpeg_encode.restype = ctypes.c_longlong
            lib.jpeg_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.jpeg_encode_sparse.restype = ctypes.c_longlong
            lib.jpeg_encode_sparse.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t,
            ]
            _lib = lib
        return _lib


def jpeg_encode(y, cb, cr, width: int, height: int, quality: int) -> bytes:
    """Entropy-code one image's dense coefficients to JFIF.

    ``y``/``cb``/``cr`` are the int16 zigzagged raster-order blocks of
    ``ops.jpegenc.packed_to_jpeg_coefficients`` for one image, covering
    ceil(height/16) x ceil(width/16) MCUs.
    """
    lib = library()
    y = np.ascontiguousarray(y, dtype=np.int16)
    cb = np.ascontiguousarray(cb, dtype=np.int16)
    cr = np.ascontiguousarray(cr, dtype=np.int16)
    h16, w16 = (height + 15) // 16, (width + 15) // 16
    if (y.size != h16 * w16 * 4 * 64 or cb.size != h16 * w16 * 64
            or cr.size != cb.size):
        raise ValueError(
            f"coefficient sizes {y.size}/{cb.size}/{cr.size} do not match "
            f"a {w16}x{h16}-MCU frame")
    # The coder returns -needed on a short buffer; ~4 bytes a coefficient
    # covers even max-entropy tiles, so one call is the rule.
    cap = (y.size + cb.size + cr.size) * 4 + 4096
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.jpeg_encode(y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
                            width, height, quality, out, cap)
        if n >= 0:
            return out.raw[:n]
        if n == -1:
            raise ValueError("jpeg_encode: invalid arguments")
        cap = -n


def jpeg_encode_sparse(buf, width: int, height: int, quality: int,
                       cap: int) -> bytes:
    """JFIF-encode one tile from its sparse wire row (``[total i32 LE |
    counts | 18-bit entries]``; any length past the used prefix decodes).

    Raises :class:`SparseOverflowError` when the row dropped entries
    (total > ``cap``): the caller takes the dense route.
    """
    lib = library()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    true_len = buf.size
    # 4 bytes of pad keep the coder's 32-bit window reads at the stream
    # tail in bounds; it validates against the true length.
    buf = np.pad(buf, (0, 4))
    out_cap = buf.size * 4 + 65536
    while True:
        out = ctypes.create_string_buffer(out_cap)
        n = lib.jpeg_encode_sparse(buf.ctypes.data, true_len, width, height,
                                   quality, cap, out, out_cap)
        if n >= 0:
            return out.raw[:n]
        if n == -2:
            raise SparseOverflowError(f"sparse buffer overflow (cap={cap})")
        if n == -1:
            raise ValueError("jpeg_encode_sparse: invalid arguments")
        out_cap = -n
