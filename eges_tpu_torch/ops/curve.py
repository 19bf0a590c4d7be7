"""secp256k1 curve constants shared by the kernels and the pipeline:
the generator, the GLV endomorphism and lattice, and the fixed-base
window tables d*G and d*(lambda*G) built with the host model.  The
underscore names keep the reference's (``eges_tpu/ops/ec.py``); the
ones ``kernels`` and ``ec`` read are blessed with ``# api:``."""

from __future__ import annotations

import functools

import numpy as np

from eges_tpu_torch.ops.field import N, NLIMBS, P, int_to_limbs, limbs_to_int

GX_INT = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY_INT = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# GLV endomorphism: lam^3 = 1 mod N, beta^3 = 1 mod P,
# lam * (x, y) = (beta * x, y)
GLV_LAM = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_G_A1 = 0x3086D221A7D46BCDE86C90E49284EB15  # api: _G_A1
_G_B1N = 0xE4437ED6010E88286F547FA90ABFE4C3  # -b1 (b1 < 0); api: _G_B1N
_G_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8  # api: _G_A2
_G_B2 = _G_A1  # api: _G_B2
# c_i = (k * g_i) >> 384 approximates round(k * b_i / N)
_G_G1 = ((_G_B2 << 384) + N // 2) // N  # api: _G_G1
_G_G2 = ((_G_B1N << 384) + N // 2) // N  # api: _G_G2
GLV_WINDOWS = 33  # 132 bits cover |k| <= 2^129


def glv_consts() -> tuple[tuple[int, ...], ...]:
    """Limbs of (g1, g2, a1, a2, -b1, b2), the order the GLV split reads."""
    return tuple(tuple(int(v) for v in int_to_limbs(x))
                 for x in (_G_G1, _G_G2, _G_A1, _G_A2, _G_B1N, _G_B2))


@functools.lru_cache(maxsize=1)
def _g_table16() -> tuple[np.ndarray, np.ndarray]:  # api: _g_table16
    """Fixed-base window table ``T[d] = d * G`` affine, d in 0..15, as
    ``[16, 16]`` uint32 limbs (row 0 zero: a zero digit adds nothing)."""
    from eges_tpu_torch.crypto import secp256k1 as host

    tx = np.zeros((16, NLIMBS), np.uint32)
    ty = np.zeros((16, NLIMBS), np.uint32)
    pt = None
    for d in range(1, 16):
        pt = host.point_add(pt, (GX_INT, GY_INT))
        tx[d] = int_to_limbs(pt[0])
        ty[d] = int_to_limbs(pt[1])
    return tx, ty


@functools.lru_cache(maxsize=1)
def _g_lam_table16() -> tuple[np.ndarray, np.ndarray]:  # api: _g_lam_table16
    """Constant affine table ``d * (lam*G) = (beta * x_d, y_d)``."""
    tx, ty = _g_table16()
    ltx = tx.copy()
    for d in range(1, 16):
        ltx[d] = int_to_limbs(GLV_BETA * limbs_to_int(tx[d]) % P)
    return ltx, ty.copy()
