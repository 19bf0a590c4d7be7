"""secp256k1 recovery and classic verify on the kernels of
``ops/kernels.py``.

The port of the fused branch of ``eges_tpu/ops/ec.py``: the per-row
window tables of R, the GLV/Strauss double-scalar multiply,
``ecrecover_point_fused``, which runs the whole recovery in 17 kernel
launches from wire bytes to the padded keccak block of the public key
(the keccak tail in ``crypto/verifier.py`` is the 18th), and
``ecdsa_verify_point``, which runs classic verify in 26.  Values are
``[B, 16]`` int32 limb tensors; everything stays on the tensors' device.
The curve and GLV constants and the fixed-base tables ``_g_table16`` and
``_g_lam_table16`` live in ``ops/curve.py``, which the kernels share.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from eges_tpu_torch.ops import field
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import NLIMBS, N, P, int_to_limbs
from eges_tpu_torch.ops.curve import GLV_BETA


@functools.lru_cache(maxsize=16)
def _const_rows(x: int, rows: int, device: torch.device) -> torch.Tensor:
    """``rows`` copies of the constant ``x`` as ``[rows, 16]`` limbs, made
    once per (constant, rows, device): the kernels only read them."""
    limbs = torch.from_numpy(int_to_limbs(x).astype("int32")).to(device)
    return limbs.expand(rows, NLIMBS).contiguous()


def _build_point_table(px: torch.Tensor, py: torch.Tensor):
    """Per-row Jacobian table ``d * R`` for d in 0..15, each of X, Y, Z
    ``[16, B, 16]``: infinity (0, 1, 0), R itself, then the 14 entries of
    the table kernel."""
    B = px.shape[0]
    rest = K.point_table_pallas(px, py)
    zero = torch.zeros_like(px)
    one = _const_rows(1, B, px.device)
    tx = torch.cat([zero[None], px[None], rest[0]])
    ty = torch.cat([one[None], py[None], rest[1]])
    tz = torch.cat([zero[None], one[None], rest[2]])
    return tx, ty, tz


def _build_affine_table(px: torch.Tensor, py: torch.Tensor):
    """Affine table ``d * R``, d in 0..15, each ``[16, B, 16]``: the
    Jacobian table normalised with one Z^-1 per entry (the pow kernel
    over all 16*B entries, canonicalised as the reference's batched
    inverse is).  Entry 0 has Z = 0, so Z^-1 = 0 and it normalises to
    zeros."""
    tx, ty, tz = _build_point_table(px, py)
    flat = (-1, NLIMBS)
    zi = K.fp_canon_pallas(K.pow_mod_pallas(tz.reshape(flat), P - 2, "p"))
    zi2 = K.fp_mul_pallas(zi, zi)
    ax = K.fp_mul_pallas(tx.reshape(flat), zi2)
    ay = K.fp_mul_pallas(ty.reshape(flat), K.fp_mul_pallas(zi, zi2))
    return ax.reshape(tx.shape), ay.reshape(ty.shape)


def _table_rows(tab: torch.Tensor, B: int) -> torch.Tensor:
    """``[16, B, 16]`` entry-stacked table -> ``[256, Bpad]`` (row
    ``16*d + k`` = limb k of entry d), the strauss_tab layout."""
    rows = tab.permute(0, 2, 1).reshape(16 * NLIMBS, B)
    return F.pad(rows, (0, K.bpad(B) - B)).contiguous()


def strauss_gR(u1: torch.Tensor, u2: torch.Tensor, rx: torch.Tensor,
               ry: torch.Tensor):
    """GLV/Strauss ``u1*G + u2*R`` for affine per-row R: the GLV kernel
    turns both scalars into ladder digits and signs, the R tables are
    built and normalised, and the ladder kernel does its own table
    lookups.  Returns Jacobian ``(X, Y, Z)`` each ``[B, 16]``."""
    B = rx.shape[0]
    dig, neg = K.glv_digits_pallas(u1, u2)
    trx, try_ = _build_affine_table(rx, ry)
    flat = trx.reshape(-1, NLIMBS)
    tlrx = K.fp_mul_pallas(flat, _const_rows(GLV_BETA, flat.shape[0],
                                             flat.device))
    return K.strauss_tab(dig, neg, _table_rows(trx, B),
                         _table_rows(tlrx.reshape(trx.shape), B),
                         _table_rows(try_, B), B)


def ecrecover_point_fused(sigs: torch.Tensor, hashes: torch.Tensor):
    """Wire bytes in (``sigs [B, 65]``, ``hashes [B, 32]`` uint8):
    returns ``(qx, qy, ok, words)``: affine ``qx, qy [B, 16]`` (zero
    where ``ok == 0``), ``ok [B]``, and ``words [34, Bpad]``, the padded
    keccak block of ``qx || qy``."""
    x, y_sq, ok0, r, s, z, v = K.recover_prelude_pallas(sigs, hashes)
    root = K.pow_mod_pallas(y_sq, (P + 1) // 4, "p")
    y, y_ok = K.y_fix_pallas(root, y_sq, v)
    r_inv = K.pow_mod_pallas(r, N - 2, "n")
    u1, u2 = K.u1u2_pallas(z, s, r_inv)
    q = strauss_gR(u1, u2, x, y)
    zi_raw = K.pow_mod_pallas(q[2], P - 2, "p")
    return K.recover_finish_pallas(q[0], q[1], q[2], zi_raw, ok0 * y_ok)


# ---------------------------------------------------------------------------
# classic verify
# ---------------------------------------------------------------------------

SEVEN = 7
# s is accepted up to N // 2: s < N // 2 + 1 (the low-s rule)
_HALF_N1_LIMBS = tuple(int(v) for v in int_to_limbs(N // 2 + 1))


def _flag_lt(a: torch.Tensor, m_limbs) -> torch.Tensor:
    return field.lt_const(a, m_limbs).to(torch.int32)


def _flag_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1).to(torch.int32)


def _flag_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1).to(torch.int32)


def on_curve(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row flag ``y^2 == x^3 + 7`` in F_P for relaxed x, y: three
    F_P products, one F_P add and two canonicalisations, in the
    reference's order."""
    lhs = K.fp_mul_pallas(y, y)
    seven = _const_rows(SEVEN, x.shape[0], x.device)
    rhs = K.fp_add_pallas(K.fp_mul_pallas(K.fp_mul_pallas(x, x), x), seven)
    return _flag_eq(K.fp_canon_pallas(lhs), K.fp_canon_pallas(rhs))


def to_affine_x(X: torch.Tensor, Z: torch.Tensor):
    """Jacobian ``(X, Z)`` -> ``(x, not_inf)``: the canonical affine x
    (zero at infinity) and the 0/1 flag of a finite point.  The x half
    of the reference's ``to_affine``: verify reads only x, so the y half
    (two F_P products and a canonicalisation) is not computed."""
    # Z == 0 or Z == P: the relaxed zero (a cached row of P, so no
    # host-to-device copy waits on the stream here)
    inf = _flag_zero(Z) | _flag_eq(Z, _const_rows(P, 1, Z.device))
    zi = K.fp_canon_pallas(K.pow_mod_pallas(Z, P - 2, "p"))
    zi2 = K.fp_mul_pallas(zi, zi)
    x = K.fp_canon_pallas(K.fp_mul_pallas(X, zi2))
    return torch.where(inf[:, None] != 0, torch.zeros_like(x), x), 1 - inf


def _pad17(a: torch.Tensor) -> torch.Tensor:
    """``[B, 16]`` limbs -> ``[B, 17]`` columns with a zero top."""
    return F.pad(a, (0, 1)).contiguous()


def ecdsa_verify_point(z, r, s, qx, qy) -> torch.Tensor:
    """Batched classic ECDSA verify against known public keys: hash
    ``z``, signature ``(r, s)`` and key ``(qx, qy)`` as ``[B, 16]`` int32
    limbs (the key relaxed: any encoding below 2^256).  Returns ``ok
    [B]`` int32.  Rejects r or s out of range, high-s signatures
    (s > N // 2, the malleable twin), keys off the curve and a result at
    infinity, as the reference does; 26 kernel launches."""
    r_ok = (1 - _flag_zero(r)) * _flag_lt(r, field.N_LIMBS)
    s_ok = (1 - _flag_zero(s)) * _flag_lt(s, _HALF_N1_LIMBS)
    q_ok = on_curve(qx, qy)
    s_inv = K.pow_mod_pallas(s, N - 2, "n")
    z_mod = K.fn_red17_pallas(_pad17(z))
    u1 = K.fn_mul_pallas(z_mod, s_inv)
    u2 = K.fn_mul_pallas(r, s_inv)
    X, _, Z = strauss_gR(u1, u2, qx, qy)
    px, not_inf = to_affine_x(X, Z)
    px_mod = K.fn_red17_pallas(_pad17(px))
    return r_ok * s_ok * q_ok * not_inf * _flag_eq(px_mod, r)
