"""The native host codecs, built and loaded: the JFIF entropy coder
(``jpegenc.cpp``), the JPEG decoder (``jpegdec.cpp``), the TIFF LZW
decoder, the bit unpacker and the byte caches' LRU tier
(``tilecache.cpp``, :class:`NativeLRUCache`), the JPEG 2000 tier-1
decoder (``jp2kt1.cpp``) and the packed staging's packer
(``wirepack.cpp``, :func:`wirepack_pack16`).

Each C++ source is compiled with ``g++ -O3 -std=c++17 -shared -fPIC
-fopenmp`` on first use into ``_build/`` beside this file, once per source
content (an edited source rebuilds; concurrent builds agree, each process
and thread writing a private file and renaming it into place), and loaded
with ``ctypes``; with a build store (:func:`use_store`,
``server.execcache``, handed over by the app when ``persistence.enabled``
is on) a library missing from ``_build/`` comes from the store when it
holds one for this toolchain, and a library built or found is stored.  A
missing compiler or a failed build raises.  The coder has no pure-Python
counterpart to fall back on; the decoders' Python counterparts
(``io.jpegdec``, ``io.tiff._lzw_decode``, ``io.jp2k._t1_decode``) are the
plain versions the tests hold these against, and the readers call the
native ones.

ctypes releases the GIL for the whole call, so concurrent requests code and
decode at the same time on their worker threads; every output buffer is
allocated per call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "jpegenc.cpp"
JPEGDEC_SOURCE = _HERE / "jpegdec.cpp"
TILECACHE_SOURCE = _HERE / "tilecache.cpp"
JP2KT1_SOURCE = _HERE / "jp2kt1.cpp"
WIREPACK_SOURCE = _HERE / "wirepack.cpp"
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_store = None       # server.execcache.ExecutableCache, or None


def use_store(store) -> None:
    """Consult ``store`` (an ``ExecutableCache``; None: none) in
    :func:`build` from now on, and store the libraries this process has
    already loaded."""
    global _store
    _store = store
    if store is not None:
        with _lock:
            paths = [Path(lib._name) for lib in _libs.values()]
        for path in paths:
            store.save("g++", path)


class SparseOverflowError(ValueError):
    """The wire buffer dropped entries (content denser than its cap)."""


def build(source: Optional[Path] = None) -> Path:
    """Compile ``source`` (default: the coder, ``jpegenc.cpp``) into
    ``_build/`` unless it is built."""
    source = SOURCE if source is None else source
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    store = _store
    if lib.exists():
        if store is not None:
            store.save("g++", lib)
        return lib
    if store is not None and store.fetch("g++", lib):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Private to this thread: the prewarm's build_all and a first use on
    # another thread may build the same source at once.
    tmp = (BUILD_DIR / f"lib{source.stem}_{tag}.{os.getpid()}."
           f"{threading.get_ident()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native codecs need g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    if store is not None:
        store.save("g++", lib)
    return lib


def build_all() -> None:
    """Build the five sources at once, one g++ each."""
    import concurrent.futures as cf

    sources = (SOURCE, JPEGDEC_SOURCE, TILECACHE_SOURCE, JP2KT1_SOURCE,
               WIREPACK_SOURCE)
    with cf.ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(build, s) for s in sources]:
            f.result()


def _load(source: Path,
          configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source.name)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            configure(lib)
            _libs[source.name] = lib
        return lib


def _configure_coder(lib: ctypes.CDLL) -> None:
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


def _configure_decoder(lib: ctypes.CDLL) -> None:
    lib.jpeg_decode_baseline.restype = ctypes.c_longlong
    lib.jpeg_decode_baseline.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]


def _configure_bitops(lib: ctypes.CDLL) -> None:
    lib.tc_create.restype = ctypes.c_void_p
    lib.tc_create.argtypes = [ctypes.c_size_t, ctypes.c_uint]
    lib.tc_destroy.restype = None
    lib.tc_destroy.argtypes = [ctypes.c_void_p]
    lib.tc_put.restype = ctypes.c_int
    lib.tc_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_size_t, ctypes.c_char_p,
                           ctypes.c_size_t]
    lib.tc_get.restype = ctypes.c_longlong
    lib.tc_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_size_t,
                           ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.tc_free.restype = None
    lib.tc_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    for fn in (lib.tc_hits, lib.tc_misses, lib.tc_size_bytes):
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    lib.bits_unpack_msb.restype = None
    lib.bits_unpack_msb.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_void_p]
    lib.tiff_lzw_decode.restype = ctypes.c_longlong
    lib.tiff_lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]


def _configure_jp2kt1(lib: ctypes.CDLL) -> None:
    lib.jp2k_t1_decode.restype = ctypes.c_longlong
    lib.jp2k_t1_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


def _configure_wirepack(lib: ctypes.CDLL) -> None:
    lib.wirepack_pack16.restype = ctypes.c_longlong
    lib.wirepack_pack16.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ]


def library() -> ctypes.CDLL:
    """The loaded coder, built on first use."""
    return _load(SOURCE, _configure_coder)


def decoder_library() -> ctypes.CDLL:
    """The loaded JPEG decoder, built on first use."""
    return _load(JPEGDEC_SOURCE, _configure_decoder)


def bitops_library() -> ctypes.CDLL:
    """The loaded LZW decoder and bit unpacker, built on first use."""
    return _load(TILECACHE_SOURCE, _configure_bitops)


def jp2k_library() -> ctypes.CDLL:
    """The loaded JPEG 2000 tier-1 decoder, built on first use."""
    return _load(JP2KT1_SOURCE, _configure_jp2kt1)


def wirepack_library() -> ctypes.CDLL:
    """The loaded packer, built on first use."""
    return _load(WIREPACK_SOURCE, _configure_wirepack)


def wirepack_pack16(arr: np.ndarray):
    """Pack a uint16 array (rows: all leading dims) into ``(words u32[n],
    widths u8[n_rows * ceil(W / 32)])``, the JAX ``wirepack_pack16``'s
    bytes (``wirepack.cpp`` has the layout; K10 is the device inverse).
    A packer that does not build raises: nothing falls back."""
    lib = wirepack_library()
    arr = np.ascontiguousarray(arr, dtype=np.uint16)
    width = arr.shape[-1]
    n_rows = arr.size // max(width, 1)
    bpr = (width + 31) // 32
    widths = np.empty(n_rows * bpr, np.uint8)
    # Worst case: every block at 17 bits a sample over 32 slots (edge
    # blocks take whole slots), 17 words a block.
    cap = n_rows * bpr * 17 + 2
    words = np.empty(cap, np.uint32)
    n = lib.wirepack_pack16(arr.ctypes.data, n_rows, width,
                            widths.ctypes.data, words.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("wirepack_pack16: capacity underestimated")
    return words[:n].copy(), widths


def jp2k_t1_decode(data: bytes, w: int, h: int, npasses: int, msbs: int,
                   orient: int, segsym: bool,
                   half_at_zero: bool) -> np.ndarray:
    """EBCOT tier-1 decode of one code-block to f64[h, w] (the native
    mirror of ``io.jp2k._t1_decode``, same arguments, same values)."""
    out = np.zeros((h, w), np.float64)
    rc = jp2k_library().jp2k_t1_decode(
        data, len(data), w, h, npasses, msbs, orient, int(segsym),
        int(half_at_zero), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError("jp2k_t1_decode: invalid arguments")
    return out


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


def jpeg_decode_baseline(data: bytes, tables: Optional[bytes]) -> np.ndarray:
    """Decode one 8-bit JPEG (optionally abbreviated, with a TIFF
    JPEGTables stream) to ``u8[h, w, ncomp]`` raw components.

    The native mirror of ``io.jpegdec.decode_baseline_jpeg``: baseline
    SOF0/1 and progressive SOF2, sampling 1-2, DRI/RST, inter-scan table
    updates.  Raises ValueError on a malformed or unsupported stream."""
    lib = decoder_library()
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    tb = tables or b""
    # A zero-capacity call sizes the frame from the headers and returns
    # -2 (too small; -1 = malformed).
    n = lib.jpeg_decode_baseline(data, len(data), tb, len(tb), None, 0,
                                 ctypes.byref(w), ctypes.byref(h),
                                 ctypes.byref(nc))
    if n != -2:
        raise ValueError("malformed or unsupported JPEG stream")
    out = np.empty(w.value * h.value * nc.value, np.uint8)
    n = lib.jpeg_decode_baseline(data, len(data), tb, len(tb),
                                 out.ctypes.data, out.size, ctypes.byref(w),
                                 ctypes.byref(h), ctypes.byref(nc))
    if n != out.size:
        raise ValueError("malformed or unsupported JPEG stream")
    return out.reshape(h.value, w.value, nc.value)


def tiff_lzw_decode(data: bytes, dst_cap: int) -> bytes:
    """TIFF-variant LZW decode into at most ``dst_cap`` bytes.  Raises
    ValueError on a malformed stream or when the output passes the cap."""
    lib = bitops_library()
    out = ctypes.create_string_buffer(max(dst_cap, 1))
    n = lib.tiff_lzw_decode(data, len(data), out, dst_cap)
    if n < 0:
        raise ValueError("malformed TIFF LZW stream (or output cap "
                         "exceeded)")
    return ctypes.string_at(out, n)


class NativeLRUCache:
    """A byte-cache tier over the C++ sharded LRU (``tc_*`` in
    ``tilecache.cpp``), in place of ``services.cache.MemoryLRUCache``: the
    JAX package's binding, the same face and counters (no evictions
    count, as there).  Each call releases the GIL."""

    def __init__(self, max_bytes: int = 256 * 1024 * 1024,
                 shards: int = 16):
        lib = bitops_library()
        self._lib = lib
        self._handle = lib.tc_create(max_bytes, shards)
        if not self._handle:
            raise MemoryError("tc_create failed")
        self.max_bytes = max_bytes

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tc_destroy(handle)
            self._handle = None

    def get_sync(self, key: str) -> Optional[bytes]:
        kb = key.encode()
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.tc_get(self._handle, kb, len(kb), ctypes.byref(out))
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.tc_free(out)

    def set_sync(self, key: str, value: bytes) -> None:
        kb = key.encode()
        self._lib.tc_put(self._handle, kb, len(kb), bytes(value),
                         len(value))

    async def get(self, key: str) -> Optional[bytes]:
        return self.get_sync(key)

    async def set(self, key: str, value: bytes) -> None:
        self.set_sync(key, value)

    @property
    def hits(self) -> int:
        return int(self._lib.tc_hits(self._handle))

    @property
    def misses(self) -> int:
        return int(self._lib.tc_misses(self._handle))

    @property
    def size_bytes(self) -> int:
        return int(self._lib.tc_size_bytes(self._handle))


def unpack_bits_msb(data: bytes, n_bits: int) -> np.ndarray:
    """MSB-first 1-bit unpack to a u8 0/1 array of ``n_bits``."""
    if len(data) * 8 < n_bits:
        raise ValueError(f"{len(data)} bytes hold no {n_bits} bits")
    out = np.empty(n_bits, dtype=np.uint8)
    bitops_library().bits_unpack_msb(data, n_bits, out.ctypes.data)
    return out
