"""Build and load a CUDA source with nvcc: the one helper every kernel
module of the port uses.

A source under ``csrc/`` with a plain ``extern "C"`` interface is compiled
by ``nvcc`` for ``sm_90a`` into ``_build/`` beside this file, once per
(source bytes, the bytes of the local headers it includes, flags): an
edited source or header or a changed flag rebuilds, and
concurrent builds agree (each process and thread writes a private file
and renames it into place).  The library is loaded with ``ctypes``.  A
missing ``nvcc`` or a failed build raises; nothing falls back.

With a build store (:func:`use_store`, ``server.execcache``; the app hands
one over when ``persistence.enabled`` is on) a library missing from
``_build/`` is taken from the store when it holds one for this toolchain
and card, and a library built or found here is stored for the next
deploy.  Without one nothing changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")
LIB_FLAGS = ("-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_logs: Dict[str, str] = {}
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
            store.save("nvcc", path)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                       "CUDA kernels are built from source on first use")


def _source_bytes(source: Path, seen=None) -> bytes:
    """``source``'s bytes followed by those of each local header it
    includes (``#include "name"``, beside it), recursively, each once."""
    seen = set() if seen is None else seen
    seen.add(source)
    data = source.read_bytes()
    out = data
    for line in data.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not (line.startswith("#include") and '"' in line):
            continue
        header = source.parent / line.split('"')[1]
        if header not in seen and header.exists():
            out += _source_bytes(header, seen)
    return out


def build(source: Path, flags: Sequence[str]) -> Tuple[Path, str]:
    """Compile ``source`` into ``_build/`` unless a library of the same
    source and flags is there; returns its path and the compiler's output
    (``-Xptxas=-v`` register and shared-memory report; empty when the
    library was already built or came from the build store)."""
    flags = tuple(flags)
    tag = hashlib.sha256(
        _source_bytes(source) + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    store = _store
    if lib.exists():
        if store is not None:
            store.save("nvcc", lib)
        return lib, ""
    if store is not None and store.fetch("nvcc", lib):
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Private to this thread: build_all and a load() on another thread may
    # build the same source at once.
    tmp = (BUILD_DIR / f"lib{source.stem}_{tag}.{os.getpid()}."
           f"{threading.get_ident()}.tmp.so")
    cmd = [nvcc(), *flags, *LIB_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    if store is not None:
        store.save("nvcc", lib)
    return lib, proc.stdout + proc.stderr


def load(source: Path, flags: Sequence[str],
         configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source`` built with ``flags``, built on
    first use; ``configure`` sets the ctypes prototypes once."""
    key = (str(source), tuple(flags))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path, log = build(source, flags)
            if log:
                _logs[source.name] = log
            lib = ctypes.CDLL(str(path))
            configure(lib)
            _libs[key] = lib
        return lib


def build_log(source_name: str) -> str:
    """The compiler output of the build that loaded ``source_name`` in
    this process ("" if it was loaded from an earlier build)."""
    return _logs.get(source_name, "")


def build_all(sources: Sequence[Tuple[Path, Sequence[str]]]) -> None:
    """Build several sources at once, one nvcc process each (a build is
    mostly one compiler thread, so this takes the longest build's time
    rather than the sum)."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(len(sources) or 1) as pool:
        built = list(pool.map(lambda sf: build(*sf), sources))
    for (source, _), (_, log) in zip(sources, built):
        if log:
            _logs[source.name] = log
