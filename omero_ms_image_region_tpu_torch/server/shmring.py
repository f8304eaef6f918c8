"""Same-host shared-memory ring for the sidecar wire (protocol v3).

A copy of the JAX package's ``server/shmring.py``: the same 32-byte
header, the same cursors and the same descriptor checks, so a port peer
and a JAX peer share rings.

The frontend<->sidecar socket is a fine control plane but a poor data
plane: every MB-scale body (a ``plane_put`` upload, a rendered tile)
pays two kernel copies and a socket traversal, on top of the ``_pack``
concatenation the frame writer already avoids.  When both processes
share a host, bodies can ride a ``multiprocessing.shared_memory``
ring instead: the producer memcpys the body into the ring and ships a
tiny ``ring: [offset, length]`` descriptor on the socket; the consumer
copies it back out at frame-decode time.  One memcpy each way, zero
socket bytes for the body, and the descriptor coalesces into the same
vectored flush as everything else.

Layout (little-endian, 32-byte header then ``size`` data bytes)::

    u32 magic "SRG1" | u32 version | u64 size | u64 head | u64 tail

``head`` and ``tail`` are MONOTONIC byte counters (never wrapped):
``pos = counter % size``.  The producer owns ``head``, the consumer
owns ``tail``, and the SOCKET is the synchronization: a consumer only
reads regions named by a descriptor (sent strictly after the body
landed and ``head`` advanced), and a producer only reuses space the
consumer has released by advancing ``tail`` — a stale ``tail`` read
is merely conservative (less apparent free space -> socket fallback).
Allocations never wrap mid-body: when the body would cross the end of
the buffer the producer skips to the next lap, and the consumer's
``tail = offset + length`` release frees the skipped pad implicitly.

Both segments of a connection are CREATED (and unlinked) by the
client; the server only attaches.  That keeps the lifecycle one-owner
— and means the client can always resolve the server's descriptors,
so negotiation needs no third leg.

Descriptors are hostile input (the socket is unauthenticated on a
private interface): :meth:`read_release` re-validates every offset and
length against the live window and raises :class:`RingError` — a
malformed descriptor degrades to a clean op-error, never an
out-of-window read.
"""

from __future__ import annotations

import secrets
import struct
from typing import Optional

_MAGIC = 0x31475253          # "SRG1"
_VERSION = 1
_HEADER = struct.Struct("<IIQQQ")      # magic, version, size, head, tail
HEADER_BYTES = _HEADER.size
_OFF_HEAD = 16
_OFF_TAIL = 24
_U64 = struct.Struct("<Q")


class RingError(Exception):
    """A descriptor (or the ring header) failed validation: the body
    cannot be resolved.  Callers map this to a clean protocol error —
    it must never surface as garbage bytes."""


class ShmRing:
    """One direction of the same-host body plane.

    Single producer (the connection's frame writer) and single consumer
    (the peer's read loop); both run on their process's event loop, so
    neither side needs a lock of its own.
    """

    def __init__(self, shm, size: int, created: bool):
        self._shm = shm
        self.size = size
        self.created = created
        self.closed = False

    # ------------------------------------------------------------ setup

    @classmethod
    def create(cls, size: int) -> "ShmRing":
        """Create a fresh ring segment of ``size`` data bytes."""
        from multiprocessing import shared_memory

        if size < 4096:
            raise ValueError(f"ring size {size} is below the 4 KiB floor")
        name = f"imgregion-ring-{secrets.token_hex(6)}"
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=HEADER_BYTES + size)
        _HEADER.pack_into(shm.buf, 0, _MAGIC, _VERSION, size, 0, 0)
        return cls(shm, size, created=True)

    @classmethod
    def attach(cls, name: str, size: int) -> "ShmRing":
        """Attach to a peer-created segment; validates the header
        against the negotiated ``size`` so a name collision (or a
        hostile hello) cannot alias another segment."""
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        try:
            # The attaching side must NOT let Python's resource tracker
            # adopt the segment: the creator owns unlink, and a
            # tracker-driven unlink at THIS process's exit would tear
            # the ring out from under a still-serving peer (bpo-39959).
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        try:
            magic, version, stored, _h, _t = _HEADER.unpack_from(shm.buf, 0)
            if magic != _MAGIC or version != _VERSION:
                raise RingError(f"segment {name!r} is not a wire ring")
            if stored != size or shm.size < HEADER_BYTES + size:
                raise RingError(
                    f"segment {name!r} declares {stored} data bytes, "
                    f"hello said {size}")
        except RingError:
            shm.close()
            raise
        return cls(shm, size, created=False)

    @property
    def name(self) -> str:
        return self._shm.name

    # ----------------------------------------------------------- cursors

    @property
    def head(self) -> int:
        return _U64.unpack_from(self._shm.buf, _OFF_HEAD)[0]

    @property
    def tail(self) -> int:
        return _U64.unpack_from(self._shm.buf, _OFF_TAIL)[0]

    def _set_head(self, v: int) -> None:
        _U64.pack_into(self._shm.buf, _OFF_HEAD, v)

    def _set_tail(self, v: int) -> None:
        _U64.pack_into(self._shm.buf, _OFF_TAIL, v)

    # ---------------------------------------------------------- producer

    def alloc_write(self, body) -> Optional[int]:
        """Copy ``body`` into the ring; returns its absolute offset, or
        None when the ring lacks room (the caller falls back to the
        socket body — exhaustion is a slow path, never an error)."""
        if self.closed:
            return None
        n = len(body)
        if n == 0 or n > self.size:
            return None
        head, tail = self.head, self.tail
        if not 0 <= head - tail <= self.size:
            # Torn/garbled header (should not happen; both cursors are
            # aligned single-writer u64s) — refuse rather than overwrite
            # unconsumed bytes.
            return None
        pos = head % self.size
        skip = self.size - pos if pos + n > self.size else 0
        if (head + skip + n) - tail > self.size:
            return None
        off = head + skip
        start = HEADER_BYTES + (off % self.size)
        self._shm.buf[start:start + n] = bytes(body) \
            if not isinstance(body, (bytes, bytearray, memoryview)) \
            else body
        self._set_head(off + n)
        return off

    # ---------------------------------------------------------- consumer

    def read_release(self, off: int, n: int) -> bytes:
        """Copy a descriptor's body out and release the ring through
        it.  Every field is re-validated: descriptors are peer input."""
        if self.closed:
            raise RingError("ring is closed")
        try:
            off, n = int(off), int(n)
        except (TypeError, ValueError):
            raise RingError("non-integer ring descriptor")
        head, tail = self.head, self.tail
        if n <= 0 or n > self.size:
            raise RingError(f"descriptor length {n} outside (0, "
                            f"{self.size}]")
        if off < tail or off + n > head:
            raise RingError(
                f"descriptor [{off}, {off + n}) outside the live "
                f"window [{tail}, {head})")
        pos = off % self.size
        if pos + n > self.size:
            raise RingError("descriptor wraps the ring end")
        start = HEADER_BYTES + pos
        data = bytes(self._shm.buf[start:start + n])
        self._set_tail(off + n)
        return data

    # ----------------------------------------------------------- teardown

    def close(self) -> None:
        """Detach; the creator also unlinks (one-owner lifecycle)."""
        if self.closed:
            return
        self.closed = True
        try:
            self._shm.close()
        except Exception:
            pass
        if self.created:
            try:
                # Re-register first so unlink()'s unregister always
                # balances: an in-process attacher (tests, combined
                # harnesses) shares this tracker and its attach-side
                # unregister already removed the creator's entry —
                # registration is a set, so this is a no-op when the
                # entry still exists.
                from multiprocessing import resource_tracker
                resource_tracker.register(self._shm._name,
                                          "shared_memory")
            except Exception:
                pass
            try:
                self._shm.unlink()
            except Exception:
                pass
