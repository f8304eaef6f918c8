"""The build store: built kernel and codec libraries that survive a deploy.

Counterpart of the JAX package's ``server/execcache.py``.  There the cost
of a fresh process is XLA's compile of every serving program, and the
module keeps the compiled executables on disk.  In the port it is the
``nvcc`` builds of ``kernels/csrc/*.cu`` (``kernels.build``) and the
``g++`` builds of ``native/*.cpp`` (``native``): tens of seconds, into a
``_build/`` directory inside the package that a deploy replaces.  With
``persistence.enabled`` (and ``persistence.executables``) the app hands
both build helpers an :class:`ExecutableCache` over
``persistence.dir/executables``:

* a library not in ``_build/`` is looked up here first; a verified entry
  is written into ``_build/`` (tmp file and ``os.replace``) and loaded
  from there with ``ctypes`` as a fresh build would be, so ``ctypes``
  never opens a half-written file;
* a library that was built, or found in ``_build/``, is stored here if it
  is not already.

Keying: an entry's key is a BLAKE2b over the toolchain and card
fingerprint (:func:`toolchain_fingerprint`: ``torch.__version__``,
``torch.version.cuda``, the ``nvcc --version`` and ``g++ --version``
text, the card's name and compute capability, and the installed CUDA
version as ``cudaDriverGetVersion`` reports it), the
compiler and the library's file name, which already holds the digest of
its source and flags.  A library stored for another card or toolchain
loads with ``ctypes`` and fails only at its first launch ("no kernel image
is available"), so a fingerprint that differs is a clean miss: the helper
builds with ``nvcc`` or ``g++`` as without a store, and saves the result.
Nothing falls back to a plain version.

Entries: ``<key>.lib`` = ``IRX1`` | u32 header length | header (JSON:
envelope version, fingerprint, compiler, file name, size and BLAKE2b of
the library) | the library's bytes.  A torn, truncated or foreign entry
is deleted and counted (``telemetry.PERSIST.execcache_corrupt``), and the
library is built again.  Loads and saves are ``execcache.load`` and
``execcache.save`` flight events.

Of the JAX class's interface the port keeps what the warm-state manifest
and the shutdown chain use: :meth:`ExecutableCache.fingerprint`,
:meth:`~ExecutableCache.stored_keys`, :meth:`~ExecutableCache.preload`,
:meth:`~ExecutableCache.drain` and the ``hits`` / ``misses`` / ``loaded``
/ ``saved`` counters.  ``lookup``, ``ensure``, ``capture_async`` and
``invalidate`` wrap XLA executables and have no counterpart: a library is
looked up by the build helpers themselves.  CUDA graphs of the serving
launches are not stored: capturing them would change the serving path.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

from ..utils import telemetry

log = logging.getLogger("omero_ms_image_region_tpu_torch.execcache")

_ENVELOPE_VERSION = 1
_MAGIC = b"IRX1"
_HEAD = struct.Struct("<4sI")
_SUFFIX = ".lib"
_COMPILERS = ("nvcc", "g++")


def _version_text(cmd: List[str]) -> Optional[str]:
    try:
        proc = subprocess.run(cmd + ["--version"], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def toolchain_fingerprint(device="cpu") -> str:
    """Everything a built library's validity depends on, as sorted JSON:
    the torch and CUDA versions, the compilers' ``--version`` text, and on
    a card its name, compute capability and ``cudaDriverGetVersion``."""
    import torch

    from ..kernels import build

    try:
        nvcc_text = _version_text([build.nvcc()])
    except RuntimeError:
        nvcc_text = None
    device = torch.device(device)
    doc = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": nvcc_text, "g++": _version_text(["g++"]),
           "device": device.type, "name": None, "capability": None,
           "cuda_installed": None}
    if device.type == "cuda":
        index = device.index if device.index is not None else 0
        doc["name"] = torch.cuda.get_device_name(index)
        doc["capability"] = list(torch.cuda.get_device_capability(index))
        installed = getattr(torch._C, "_cuda_getDriverVersion", None)
        doc["cuda_installed"] = installed() if installed else None
    return json.dumps(doc, sort_keys=True)


def _digest(payload: bytes) -> str:
    return hashlib.blake2b(payload, digest_size=32).hexdigest()


def build_dir(compiler: str) -> Path:
    """Where ``compiler``'s libraries are loaded from: ``kernels/_build``
    for nvcc, ``native/_build`` for g++."""
    if compiler == "nvcc":
        from ..kernels import build
        return build.BUILD_DIR
    from .. import native
    return native.BUILD_DIR


def install(store: Optional["ExecutableCache"]) -> None:
    """Hand ``store`` to both build helpers (None: build without one)."""
    from .. import native
    from ..kernels import build

    build.use_store(store)
    native.use_store(store)


def uninstall(store: Optional["ExecutableCache"]) -> None:
    """Take ``store`` back from the build helpers if they still hold it
    (an app's cleanup)."""
    from ..kernels import build

    if store is not None and build._store is store:
        install(None)


class ExecutableCache:
    """The build store over ``directory`` (``persistence.dir/
    executables``) for libraries built on ``device``."""

    def __init__(self, directory: str, device="cpu"):
        self.directory = directory
        self.device = device
        self._fingerprint: Optional[str] = None
        self._lock = threading.Lock()
        # One writer at a time into _build/: a library is placed, counted
        # and recorded once, whether a lookup or the preload gets there
        # first.
        self._place_lock = threading.Lock()
        self._busy = 0                  # saves in flight (drain)
        self._idle = threading.Condition(self._lock)
        self.hits = 0                   # lookups a stored entry answered
        self.misses = 0                 # lookups that had to build
        self.loaded = 0                 # entries written into _build/
        self.saved = 0                  # entries stored

    # ------------------------------------------------------------- keys

    def fingerprint(self) -> str:
        if self._fingerprint is None:
            self._fingerprint = toolchain_fingerprint(self.device)
        return self._fingerprint

    def _key(self, compiler: str, name: str) -> str:
        h = hashlib.blake2b(digest_size=16)
        for part in (self.fingerprint(), compiler, name):
            h.update(part.encode())
            h.update(b"\0")
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key + _SUFFIX)

    # ------------------------------------------------------------ reads

    def _read(self, key: str) -> Optional[tuple]:
        """``(header, payload)`` of a verified entry of this fingerprint;
        None when there is no entry, or (deleted and counted) when it is
        torn, truncated or foreign."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        try:
            magic, head_len = _HEAD.unpack_from(blob)
            if magic != _MAGIC:
                raise ValueError("bad magic")
            start = _HEAD.size + head_len
            header = json.loads(blob[_HEAD.size:start].decode())
            payload = blob[start:]
            if (header.get("version") != _ENVELOPE_VERSION
                    or header.get("fingerprint") != self.fingerprint()
                    or header.get("compiler") not in _COMPILERS
                    or self._key(header["compiler"], header["name"]) != key
                    or header.get("size") != len(payload)
                    or header.get("digest") != _digest(payload)):
                raise ValueError("entry does not verify")
        except Exception:
            log.warning("build store entry %s is corrupt or foreign; "
                        "removing it", path)
            telemetry.PERSIST.count_exec_corrupt()
            self._remove(path)
            return None
        return header, payload

    def _remove(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def _place(self, compiler: str, payload: bytes, dest: Path) -> None:
        """Write ``payload`` to ``dest`` unless it is there, through a
        private tmp file and ``os.replace`` (``dest`` exists only
        whole)."""
        with self._place_lock:
            if dest.exists():
                return
            dest.parent.mkdir(parents=True, exist_ok=True)
            tmp = dest.with_name(f"{dest.name}.{os.getpid()}."
                                 f"{threading.get_ident()}.store.tmp")
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, dest)
            with self._lock:
                self.loaded += 1
        telemetry.FLIGHT.record("execcache.load", compiler=compiler,
                                lib=dest.name)

    def fetch(self, compiler: str, dest: Path) -> bool:
        """Write the stored library named ``dest.name`` to ``dest``; False
        (a miss: the caller builds) when there is none that verifies."""
        entry = self._read(self._key(compiler, dest.name))
        if entry is None:
            with self._lock:
                self.misses += 1
            return False
        self._place(compiler, entry[1], dest)
        with self._lock:
            self.hits += 1
        return True

    # ----------------------------------------------------------- writes

    def save(self, compiler: str, lib: Path) -> None:
        """Store the library at ``lib`` unless an entry that verifies
        holds it already.  A failed write is logged; the library still
        serves this process."""
        key = self._key(compiler, lib.name)
        with self._lock:
            self._busy += 1
        try:
            if self._read(key) is not None:
                return
            payload = lib.read_bytes()
            header = json.dumps({
                "version": _ENVELOPE_VERSION,
                "fingerprint": self.fingerprint(), "compiler": compiler,
                "name": lib.name, "size": len(payload),
                "digest": _digest(payload)}).encode()
            os.makedirs(self.directory, exist_ok=True)
            path = self._path(key)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(_HEAD.pack(_MAGIC, len(header)) + header + payload)
            os.replace(tmp, path)
            with self._lock:
                self.saved += 1
            telemetry.FLIGHT.record("execcache.save", compiler=compiler,
                                    lib=lib.name)
        except OSError:
            log.warning("build store write of %s failed", lib.name,
                        exc_info=True)
        finally:
            with self._lock:
                self._busy -= 1
                self._idle.notify_all()

    def drain(self, timeout_s: float = 30.0) -> None:
        """Wait (bounded) for the saves in flight: a library stored now is
        one the next life does not build."""
        with self._lock:
            self._idle.wait_for(lambda: self._busy == 0, timeout=timeout_s)

    # ------------------------------------------------------ enumeration

    def stored_keys(self) -> List[str]:
        """The keys on disk (the warm-state manifest's ``executables``)."""
        try:
            return sorted(name[:-len(_SUFFIX)]
                          for name in os.listdir(self.directory)
                          if name.endswith(_SUFFIX))
        except OSError:
            return []

    def preload(self, keys: List[str]) -> int:
        """Boot rehydrate: write each stored library of ``keys`` into its
        ``_build/`` (a library already there is left as it is), so the
        prewarm and the first requests load instead of building.  Returns
        how many are in place; an entry that does not verify is skipped
        (deleted and counted)."""
        n = 0
        for key in keys:
            entry = self._read(key)
            if entry is None:
                continue
            header, payload = entry
            self._place(header["compiler"], payload,
                        build_dir(header["compiler"]) / header["name"])
            n += 1
        return n
