"""SipHash-2-4 with Guava-compatible output formatting.

The reference derives its Redis cache keys with Guava's
``Hashing.sipHash24()`` over a canonical parameter string
(``ImageRegionCtx.java:165-177``).  To stay cache-compatible with a Java
deployment (same Redis, same keys), this module reproduces:

  * the SipHash-2-4 algorithm (Aumasson & Bernstein) with Guava's default
    seed k0=0x0706050403020100, k1=0x0f0e0d0c0b0a0908,
  * Guava's ``HashCode.toString()`` formatting: the 64-bit result printed
    as its 8 bytes in little-endian order, lower-case hex.

Pure Python: one hash per request over a short parameter string.
"""

from __future__ import annotations

MASK = 0xFFFFFFFFFFFFFFFF

GUAVA_K0 = 0x0706050403020100
GUAVA_K1 = 0x0F0E0D0C0B0A0908


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & MASK


def siphash24(data: bytes, k0: int = GUAVA_K0, k1: int = GUAVA_K1) -> int:
    """SipHash-2-4 of ``data``; returns the 64-bit hash as an int."""
    v0 = 0x736F6D6570736575 ^ k0
    v1 = 0x646F72616E646F6D ^ k1
    v2 = 0x6C7967656E657261 ^ k0
    v3 = 0x7465646279746573 ^ k1

    def sipround():
        nonlocal v0, v1, v2, v3
        v0 = (v0 + v1) & MASK
        v1 = _rotl(v1, 13)
        v1 ^= v0
        v0 = _rotl(v0, 32)
        v2 = (v2 + v3) & MASK
        v3 = _rotl(v3, 16)
        v3 ^= v2
        v0 = (v0 + v3) & MASK
        v3 = _rotl(v3, 21)
        v3 ^= v0
        v2 = (v2 + v1) & MASK
        v1 = _rotl(v1, 17)
        v1 ^= v2
        v2 = _rotl(v2, 32)

    n = len(data)
    end = n - (n % 8)
    for off in range(0, end, 8):
        m = int.from_bytes(data[off:off + 8], "little")
        v3 ^= m
        sipround()
        sipround()
        v0 ^= m

    b = (n & 0xFF) << 56
    tail = data[end:]
    for i, byte in enumerate(tail):
        b |= byte << (8 * i)
    v3 ^= b
    sipround()
    sipround()
    v0 ^= b

    v2 ^= 0xFF
    sipround()
    sipround()
    sipround()
    sipround()
    return (v0 ^ v1 ^ v2 ^ v3) & MASK


def guava_siphash24_hex(text: str) -> str:
    """Hash a string as Guava's ``sipHash24().hashString(s, UTF_8).toString()``
    would: UTF-8 encode, SipHash-2-4, print result bytes little-endian hex."""
    h = siphash24(text.encode("utf-8"))
    return h.to_bytes(8, "little").hex()
