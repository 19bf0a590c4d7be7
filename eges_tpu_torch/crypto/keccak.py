"""Keccak-256 (Ethereum's pre-NIST padding), pure Python.

As in the reference, ``keccak256`` dispatches to the native library
(``crypto/native.py``) when it is built; the pure-Python function stays
as ``keccak256_py``.  The host oracle for the keccak kernel and for ``chip_smoke.py``.  Note
``hashlib.sha3_256`` is NIST SHA-3 (domain byte 0x06) and gives other
digests; Ethereum's Keccak-256 pads with 0x01.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

# Round constants of Keccak-f[1600].
ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets r[x][y] as a flat 5x5 (index x + 5*y).
ROTATIONS = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)

RATE_BYTES = 136  # 1088-bit rate for Keccak-256


def _rotl(value: int, shift: int) -> int:
    shift %= 64
    return ((value << shift) | (value >> (64 - shift))) & _MASK


def keccak_f1600(lanes: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation over 25 64-bit lanes (x + 5*y)."""
    a = lanes
    for rc in ROUND_CONSTANTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    a[x + 5 * y], ROTATIONS[x + 5 * y])
        a = [b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)])
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)] & _MASK)
             for i in range(25)]
        a[0] ^= rc
    return a


def keccak256_py(data: bytes) -> bytes:
    """Ethereum-style Keccak-256 digest of ``data``."""
    state = [0] * 25
    padded = bytearray(data)
    pad_len = RATE_BYTES - (len(padded) % RATE_BYTES)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off:off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f1600(state)
    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        out += state[i].to_bytes(8, "little")
    return bytes(out)


def _dispatch_keccak256():
    """Prefer the native C++ core when built (the reference's asm-core
    role, crypto/sha3/keccakf_amd64.s); pure Python stays the golden
    fallback."""
    try:
        from eges_tpu_torch.crypto import native

        if native.available():
            return lambda data: native.keccak256(bytes(data))
    # analysis: allow-swallow(optional native-accel probe; falls back to python)
    except Exception:
        pass
    return keccak256_py


keccak256 = _dispatch_keccak256()
