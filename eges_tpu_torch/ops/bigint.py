"""256-bit integers as 16 little-endian 16-bit limbs.

The limb layout of ``eges_tpu.ops.bigint``, kept so that the port's
values and the reference's compare array with array: a field element is
a ``[..., 16]`` array of limbs, least significant first, each below
2^16.  Python ints and numpy only; the arithmetic lives in
``ops/field.py`` (PyTorch) and ``ops/csrc/field.cuh`` (CUDA).
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
NLIMBS = 16  # 256 bits
MASK = (1 << LIMB_BITS) - 1

# secp256k1 field prime and group order
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    """Python int -> n little-endian 16-bit limbs (numpy uint32)."""
    if x < 0 or x >= 1 << (LIMB_BITS * n):
        raise ValueError("out of range")
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(n)],
                    dtype=np.uint32)


def limbs_to_int(a) -> int:
    """Limb array (last axis) -> Python int."""
    a = np.asarray(a)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a.reshape(-1)))


def bytes_be_to_limbs(b: np.ndarray) -> np.ndarray:
    """``[..., 32]`` big-endian bytes (uint8) -> ``[..., 16]`` limbs
    (uint32)."""
    le = np.asarray(b)[..., ::-1].astype(np.uint32)
    pairs = le.reshape(*le.shape[:-1], NLIMBS, 2)
    return pairs[..., 0] | (pairs[..., 1] << 8)
