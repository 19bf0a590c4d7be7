"""Seeded inputs for the tests and ``chip_smoke.py``: field values with
the extremes, curve points, signed recovery rows and one row of each
invalid class.  Everything is made from a ``numpy.random.Generator``,
so a seed fixes every byte.
"""

from __future__ import annotations

import numpy as np

from eges_tpu_torch.crypto import secp256k1 as host
from eges_tpu_torch.ops.bigint import N, P, int_to_limbs

# every invalid class of ecrecover, in the order invalid_rows makes them
INVALID_CLASSES = ("r_zero", "s_ge_n", "v_ge_4", "x_ge_p", "r_not_x")


def rand_int(rng: np.random.Generator, bound: int) -> int:
    """Uniform int in [0, bound) from 256 random bits."""
    return int.from_bytes(rng.bytes(40), "big") % bound


def limb_rows(vals) -> np.ndarray:
    """Python ints -> ``[len, 16]`` uint32 limbs."""
    return np.stack([int_to_limbs(v) for v in vals]).astype(np.uint32)


def field_values(rng: np.random.Generator, n: int, bound: int = 1 << 256):
    """n ints below ``bound``: the extremes 0, 1, P-1, P, N-1, N, 2^256-1
    and all-0xFFFF limbs first (those below ``bound``), then random."""
    ext = [0, 1, P - 1, P, N - 1, N, (1 << 256) - 1, (1 << 255) + 12345]
    vals = [v for v in ext if v < bound]
    vals += [rand_int(rng, bound) for _ in range(max(0, n - len(vals)))]
    return vals[:n]


def curve_points(rng: np.random.Generator, n: int):
    """n random affine points d*G as ``(x [n, 16], y [n, 16])`` limbs."""
    pts = [host.point_mul(1 + rand_int(rng, N - 1), host.G) for _ in range(n)]
    return limb_rows([p[0] for p in pts]), limb_rows([p[1] for p in pts])


def _is_x(x: int) -> bool:
    """x^3 + 7 is a square mod P."""
    return pow((pow(x, 3, P) + 7) % P, (P - 1) // 2, P) == 1


def signed_rows(rng: np.random.Generator, n: int):
    """n valid signatures over random hashes with random keys.  Returns
    ``(sigs [n, 65] u8, hashes [n, 32] u8, addrs list of 20-byte)``."""
    sigs = np.zeros((n, 65), np.uint8)
    hashes = np.zeros((n, 32), np.uint8)
    addrs = []
    for i in range(n):
        msg = rng.bytes(32)
        priv = (1 + rand_int(rng, N - 1)).to_bytes(32, "big")
        sigs[i] = np.frombuffer(host.ecdsa_sign(msg, priv), np.uint8)
        hashes[i] = np.frombuffer(msg, np.uint8)
        addrs.append(host.pubkey_to_address(host.privkey_to_pubkey(priv)))
    return sigs, hashes, addrs


def high_x_rows(rng: np.random.Generator, n: int):
    """n rows with recovery id 2 or 3 (R.x = r + N), which honest signers
    almost never produce: r is chosen so that r + N is an x coordinate,
    s and the hash at random.  Every such row recovers a key."""
    sigs = np.zeros((n, 65), np.uint8)
    hashes = np.zeros((n, 32), np.uint8)
    i = 0
    while i < n:
        r = 1 + rand_int(rng, P - N - 1)
        if not _is_x(r + N):
            continue
        s = 1 + rand_int(rng, N - 1)
        sigs[i, :32] = np.frombuffer(r.to_bytes(32, "big"), np.uint8)
        sigs[i, 32:64] = np.frombuffer(s.to_bytes(32, "big"), np.uint8)
        sigs[i, 64] = 2 + (i & 1)
        hashes[i] = np.frombuffer(rng.bytes(32), np.uint8)
        i += 1
    return sigs, hashes


def invalid_rows(rng: np.random.Generator, sig: np.ndarray,
                 msg: np.ndarray):
    """One row of each class in INVALID_CLASSES, made from a valid
    ``sig [65]`` / ``msg [32]``: r = 0, s = N, v = 4, r + N >= P with
    v = 2, and an r whose x^3 + 7 has no square root."""
    rows = np.repeat(sig[None], len(INVALID_CLASSES), axis=0)
    rows[0, :32] = 0
    rows[1, 32:64] = np.frombuffer(N.to_bytes(32, "big"), np.uint8)
    rows[2, 64] = 4
    rows[3, :32] = np.frombuffer((P - N).to_bytes(32, "big"), np.uint8)
    rows[3, 64] = 2
    while True:
        r = 1 + rand_int(rng, N - 1)
        if not _is_x(r):
            break
    rows[4, :32] = np.frombuffer(r.to_bytes(32, "big"), np.uint8)
    rows[4, 64] = 0
    return rows, np.repeat(msg[None], len(INVALID_CLASSES), axis=0)


def host_recover(sig: np.ndarray, msg: np.ndarray):
    """The host model's answer for one row: (address, 64-byte public
    key) or None for an invalid row."""
    try:
        pub = host.ecdsa_recover(bytes(msg), bytes(sig))
    except ValueError:
        return None
    return host.pubkey_to_address(pub), pub
