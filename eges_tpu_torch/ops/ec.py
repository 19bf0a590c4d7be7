"""secp256k1 recovery and classic verify on the kernels of
``ops/kernels.py``, for operands of any leading shape.

The port of ``eges_tpu/ops/ec.py``.  Values are ``[..., 16]`` int32 limb
tensors and points Jacobian ``(X, Y, Z)`` triples of them; everything
stays on the tensors' device.  Two paths, chosen by the operands' shape
as the reference chooses them:

- ``[B, 16]`` (a 2-D batch) takes the fused branch: the GLV kernel, the
  per-row window tables of R built by the table kernel, and the ladder
  kernel.  ``ecrecover_point_fused`` runs the whole recovery in 17
  kernel launches from wire bytes to the padded keccak block of the
  public key (the keccak tail in ``crypto/verifier.py`` is the 18th);
  ``ecdsa_verify_point`` runs classic verify in 26.
- Any other shape (a stacked ``[K, N, 16]`` window, a single ``[16]``
  row) takes the un-fused path of ``ecrecover_point``, call for call
  the reference's: the point formulas ``jac_double`` and
  ``jac_add_mixed`` on the ``FP`` front door of ``ops/bigint.py``, the
  GLV split ``_glv_decompose`` on ``FN``, the 14-step table scan and the
  33-window ladder of 4 doublings and 4 sign-folded mixed adds.  Every
  field operation is one launch of a glue kernel, about 8,400 a batch
  whatever its rows.

The curve and GLV constants and the fixed-base tables live in
``ops/curve.py``, which the kernels share.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from eges_tpu_torch.ops import curve
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import (FN, FP, NLIMBS, N, P, big_add, big_lt,
                                       const_row, eq, is_zero, select)
from eges_tpu_torch.ops.curve import GLV_BETA, GLV_WINDOWS

SEVEN = 7
WINDOW = 4


# ---------------------------------------------------------------------------
# the group law (branchless over the exceptional cases)
# ---------------------------------------------------------------------------

def infinity(like: torch.Tensor):
    """Points at infinity (0, 1, 0) in the shape of ``like``."""
    return FP.const(0, like), FP.const(1, like), torch.zeros_like(like)


def jac_double(pt):
    """Point doubling, a = 0 (dbl-2009-l); 18 launches."""
    X1, Y1, Z1 = pt
    A = FP.sqr(X1)
    B = FP.sqr(Y1)
    C = FP.sqr(B)
    t = FP.sqr(FP.add(X1, B))
    D = FP.mul_small(FP.sub(FP.sub(t, A), C), 2)
    E = FP.mul_small(A, 3)
    Fv = FP.sqr(E)
    X3 = FP.sub(Fv, FP.mul_small(D, 2))
    Y3 = FP.sub(FP.mul(E, FP.sub(D, X3)), FP.mul_small(C, 8))
    Z3 = FP.mul_small(FP.mul(Y1, Z1), 2)
    return X3, Y3, Z3


def jac_add_mixed(pt, x2: torch.Tensor, y2: torch.Tensor):
    """Mixed addition ``pt + (x2, y2)`` (madd-2007-bl), branchless: pt at
    infinity gives (x2, y2, 1), equal points the doubling (computed on
    every row and selected, as the reference does), opposite points
    infinity; 40 launches."""
    X1, Y1, Z1 = pt
    Z1Z1 = FP.sqr(Z1)
    U2 = FP.mul(x2, Z1Z1)
    S2 = FP.mul(FP.mul(y2, Z1), Z1Z1)
    H = FP.sub(U2, X1)
    r = FP.sub(S2, Y1)

    HH = FP.sqr(H)
    I = FP.mul_small(HH, 4)
    J = FP.mul(H, I)
    rr = FP.mul_small(r, 2)
    V = FP.mul(X1, I)
    X3 = FP.sub(FP.sub(FP.sqr(rr), J), FP.mul_small(V, 2))
    Y3 = FP.sub(FP.mul(rr, FP.sub(V, X3)), FP.mul_small(FP.mul(Y1, J), 2))
    Z3 = FP.mul(FP.mul_small(Z1, 2), H)

    DX, DY, DZ = jac_double(pt)

    h0 = FP.is_zero_mod(H)
    r0 = FP.is_zero_mod(r)
    p1_inf = FP.is_zero_mod(Z1)
    dbl = h0 * r0
    opp = h0 * (1 - r0)

    one = FP.const(1, Z1)
    X = select(dbl, DX, X3)
    Y = select(dbl, DY, Y3)
    Z = select(dbl, DZ, Z3)
    Z = select(opp, torch.zeros_like(Z), Z)
    Y = select(opp, one, Y)
    X = select(p1_inf, x2, X)
    Y = select(p1_inf, y2, Y)
    Z = select(p1_inf, one, Z)
    return X, Y, Z


def to_affine(pt):
    """Jacobian -> affine ``(x, y, ok)``, canonical; infinity rows give
    x = y = 0 and ok = 0."""
    X, Y, Z = pt
    inf = FP.is_zero_mod(Z)
    zi = FP.inv_batched(Z)
    zi2 = FP.sqr(zi)
    x = FP.canon(FP.mul(X, zi2))
    y = FP.canon(FP.mul(Y, FP.mul(zi, zi2)))
    zero = torch.zeros_like(x)
    return select(inf, zero, x), select(inf, zero, y), 1 - inf


def to_affine_x(X: torch.Tensor, Z: torch.Tensor):
    """Jacobian ``(X, Z)`` -> ``(x, not_inf)``: the x half of
    ``to_affine``, for the 2-D verify path, which reads only x (two F_P
    products and a canonicalisation fewer)."""
    inf = FP.is_zero_mod(Z)
    zi2 = FP.sqr(FP.inv_batched(Z))
    x = FP.canon(FP.mul(X, zi2))
    return select(inf, torch.zeros_like(x), x), 1 - inf


def on_curve(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row flag ``y^2 == x^3 + 7`` in F_P for relaxed x, y."""
    lhs = FP.sqr(y)
    rhs = FP.add(FP.mul(FP.sqr(x), x), FP.const(SEVEN, x))
    return FP.eq_mod(lhs, rhs)


# ---------------------------------------------------------------------------
# window tables of R
# ---------------------------------------------------------------------------

def _build_point_table(px: torch.Tensor, py: torch.Tensor):
    """Per-row Jacobian table ``d * R`` for d in 0..15, each of X, Y, Z
    ``[16, ..., 16]``: infinity, R itself, then 14 mixed adds.  A 2-D
    batch runs them in the table kernel, other shapes as 14 steps of
    ``jac_add_mixed`` (the reference's scan)."""
    inf = infinity(px)
    one = (px, py, FP.const(1, px))
    if px.dim() == 2:
        rest = K.point_table_pallas(px, py)
    else:
        steps = []
        cur = one
        for _ in range(14):
            cur = jac_add_mixed(cur, px, py)
            steps.append(cur)
        rest = [torch.stack([s[c] for s in steps]) for c in range(3)]
    return tuple(torch.cat([inf[c][None], one[c][None], rest[c]])
                 for c in range(3))


def _build_affine_table(px: torch.Tensor, py: torch.Tensor):
    """Affine table ``d * R``, d in 0..15, each ``[16, ..., 16]``: the
    Jacobian table normalised with one Z^-1 per entry (the pow kernel
    over all 16 x rows entries, canonicalised).  Entry 0 has Z = 0, so
    Z^-1 = 0 and it normalises to zeros; the ladder masks it."""
    tx, ty, tz = (t.reshape(-1, NLIMBS) for t in _build_point_table(px, py))
    zi = FP.inv_batched(tz)
    zi2 = FP.sqr(zi)
    shape = (16, *px.shape)
    return (FP.mul(tx, zi2).reshape(shape),
            FP.mul(ty, FP.mul(zi, zi2)).reshape(shape))


def _table_rows(tab: torch.Tensor, B: int) -> torch.Tensor:
    """``[16, B, 16]`` entry-stacked table -> ``[256, Bpad]`` (row
    ``16*d + k`` = limb k of entry d), the strauss_tab layout."""
    rows = tab.permute(0, 2, 1).reshape(16 * NLIMBS, B)
    return F.pad(rows, (0, K.bpad(B) - B)).contiguous()


def _table_lookup(tab: torch.Tensor, digit: torch.Tensor) -> torch.Tensor:
    """Per-row gather from a ``[16, ..., 16]`` entry-stacked table by
    ``digit [...]``."""
    idx = digit[None, ..., None].expand(1, *tab.shape[1:])
    return torch.gather(tab, 0, idx)[0]


@functools.lru_cache(maxsize=4)
def _g_tables(device: torch.device):
    """The fixed-base affine tables d*G and d*(lambda*G) as int32
    ``[16, 16]`` tensors on ``device``: (x of d*G, y of d*G, x of
    d*lambda*G; the y of both is the same)."""
    tgx, tgy = curve._g_table16()
    tlx, _ = curve._g_lam_table16()
    return tuple(K.from_reference(t, device) for t in (tgx, tgy, tlx))


# ---------------------------------------------------------------------------
# GLV split and the double-scalar multiply
# ---------------------------------------------------------------------------

def _scalar_digits(k: torch.Tensor) -> torch.Tensor:
    """``[..., 16]`` limbs -> ``[..., 64]`` base-16 digits, LSD first."""
    shifts = torch.arange(0, 16, WINDOW, dtype=k.dtype, device=k.device)
    digs = (k[..., :, None] >> shifts) & 0xF
    return digs.reshape(*k.shape[:-1], 64)


def _digits33(k: torch.Tensor) -> torch.Tensor:
    """``[..., 16]`` limbs -> ``[..., 33]`` base-16 digits, LSD first
    (132 bits: the GLV half-scalar width)."""
    return _scalar_digits(k)[..., :GLV_WINDOWS]


def _glv_decompose(k: torch.Tensor):
    """``k`` (canonical mod N) -> ``(k1_abs, neg1, k2_abs, neg2)`` with
    ``k = +-k1 + lambda * (+-k2) (mod N)``, both magnitudes below 2^129:
    two mulhi8 launches for ``(k * g_i) >> 384``, then four products,
    three differences and the sign splits mod N.  A negative residue is
    recognised by size: a magnitude above 2^140 must be a small negative
    number."""
    lead = k.shape[:-1]
    flat = k.reshape(-1, NLIMBS).contiguous()
    c1, c2 = (F.pad(K.mulhi8_pallas(flat, g).reshape(*lead, 8), (0, 8))
              for g in (curve._G_G1, curve._G_G2))
    a1, a2, b1n, b2 = (FN.const(x, k) for x in (
        curve._G_A1, curve._G_A2, curve._G_B1N, curve._G_B2))
    # k1 = k - c1*a1 - c2*a2 (mod N);  k2 = c1*(-b1) - c2*b2 (mod N)
    k1 = FN.sub(FN.sub(k, FN.mul(c1, a1)), FN.mul(c2, a2))
    k2 = FN.sub(FN.mul(c1, b1n), FN.mul(c2, b2))
    thresh = FN.const(1 << 140, k)

    def sign_split(v):
        neg = 1 - big_lt(v, thresh)
        return select(neg, FN.neg(v), v), neg

    return (*sign_split(k1), *sign_split(k2))


def _r_tables(rx: torch.Tensor, ry: torch.Tensor):
    """The affine tables of R and lambda*R (beta * x per entry, same y):
    ``(trx, try_, tlrx)``."""
    trx, try_ = _build_affine_table(rx, ry)
    return trx, try_, FP.mul(trx, FP.const(GLV_BETA, trx))


def strauss_inputs(u1: torch.Tensor, u2: torch.Tensor, rx: torch.Tensor,
                   ry: torch.Tensor):
    """The ladder kernel's inputs for a ``[B, 16]`` batch: ``(dig, neg,
    trx, tlrx, try_)`` in :func:`kernels.strauss_tab`'s layout, the R
    tables built and normalised, then the GLV digits and signs."""
    B = rx.shape[0]
    trx, try_, tlrx = _r_tables(rx, ry)
    dig, neg = K.glv_digits_pallas(u1, u2)
    return (dig, neg, _table_rows(trx, B), _table_rows(tlrx, B),
            _table_rows(try_, B))


def strauss_gR(u1: torch.Tensor, u2: torch.Tensor, rx: torch.Tensor,
               ry: torch.Tensor):
    """GLV/Strauss ``u1*G + u2*R`` for affine per-row R; Jacobian
    ``(X, Y, Z)``.

    A 2-D batch: the GLV kernel turns both scalars into ladder digits and
    signs, the R tables are built and normalised, and the ladder kernel
    does its own table lookups.  Other shapes: the reference's 33-window
    loop, each window 4 doublings, then for the four operands (+-G,
    +-lambda*G, +-R, +-lambda*R, digits MSD first) a negation of the
    looked-up y where the half-scalar is negative and a mixed add kept
    where the digit is not 0: 4 x 18 + 4 x 41 launches a window.
    """
    if rx.dim() == 2:
        return K.strauss_tab(*strauss_inputs(u1, u2, rx, ry), rx.shape[0])
    trx, try_, tlrx = _r_tables(rx, ry)

    # both scalars split in one stacked [2, ...] decomposition; digits
    # LSD first, int64 for the gathers
    k1s, n1s, k2s, n2s = _glv_decompose(torch.stack([u1, u2]))
    digits = [_digits33(k).long() for k in (k1s[0], k2s[0], k1s[1], k2s[1])]
    negs = (n1s[0], n2s[0], n1s[1], n2s[1])
    tgx, tgy, tlx = _g_tables(rx.device)
    acc = infinity(rx)
    for i in range(GLV_WINDOWS):
        j = GLV_WINDOWS - 1 - i
        for _ in range(WINDOW):
            acc = jac_double(acc)
        dj = [d[..., j] for d in digits]
        xs = (tgx[dj[0]], tlx[dj[1]], _table_lookup(trx, dj[2]),
              _table_lookup(tlrx, dj[3]))
        ys = (tgy[dj[0]], tgy[dj[1]], _table_lookup(try_, dj[2]),
              _table_lookup(try_, dj[3]))
        for t in range(4):
            y_t = select(negs[t], FP.neg(ys[t]), ys[t])
            added = jac_add_mixed(acc, xs[t], y_t)
            acc = tuple(select(dj[t], n, o) for n, o in zip(added, acc))
    return acc


# ---------------------------------------------------------------------------
# recovery and classic verify
# ---------------------------------------------------------------------------

def ecrecover_point_fused(sigs: torch.Tensor, hashes: torch.Tensor):
    """Wire bytes in (``sigs [B, W]`` for any W >= 65, read in place by
    the prelude, and ``hashes [B, 32]``, uint8):
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


def _pad17(a: torch.Tensor) -> torch.Tensor:
    """``[..., 16]`` limbs -> ``[..., 17]`` columns with a zero top."""
    return F.pad(a, (0, 1))


def ecrecover_point(z: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                    v: torch.Tensor):
    """The un-fused recovery core: ``z`` (message hash), ``r``, ``s`` as
    ``[..., 16]`` limbs and the recovery id ``v [...]`` -> affine
    ``(qx, qy, ok)``, the rows with ``ok == 0`` zeroed: r or s out of
    range, v >= 4, x = r (+ N for v >= 2) not below P or no x
    coordinate, or a result at infinity.  The reference's
    ``ecrecover_point`` (eges_tpu/ops/ec.py:583) call for call; about
    8,390 kernel launches."""
    n_lim = FN.m_limbs(r)
    p_lim = FP.m_limbs(r)
    r_ok = (1 - is_zero(r)) * big_lt(r, n_lim)
    s_ok = (1 - is_zero(s)) * big_lt(s, n_lim)
    v_ok = (v < 4).to(torch.int32)

    # x = r + (v >= 2 ? N : 0), must be below P
    hi = (v >= 2).to(torch.int32)
    x_wide = big_add(r, select(hi, n_lim, torch.zeros_like(r)), NLIMBS + 1)
    x_ok = is_zero(x_wide[..., NLIMBS:]) * big_lt(x_wide[..., :NLIMBS],
                                                  p_lim)
    x = x_wide[..., :NLIMBS].contiguous()

    # y from x^3 + 7, its parity fixed to v & 1 on the canonical root
    y_sq = FP.add(FP.mul(FP.sqr(x), x), FP.const(SEVEN, x))
    y, y_ok = FP.sqrt(y_sq)
    y = FP.canon(y)
    flip = (v & 1) ^ (y[..., 0] & 1)
    y = select(flip, FP.neg(y), y)

    # u1 = -z/r mod N, u2 = s/r mod N
    r_inv = FN.inv_batched(r)
    z_mod = FN.red(_pad17(z))
    u1 = FN.neg(FN.mul(z_mod, r_inv))
    u2 = FN.mul(s, r_inv)

    qx, qy, not_inf = to_affine(strauss_gR(u1, u2, x, y))
    ok = r_ok * s_ok * v_ok * x_ok * y_ok * not_inf
    zero = torch.zeros_like(qx)
    return select(ok, qx, zero), select(ok, qy, zero), ok


def ecdsa_verify_point(z, r, s, qx, qy) -> torch.Tensor:
    """Batched classic ECDSA verify against known public keys: hash
    ``z``, signature ``(r, s)`` and key ``(qx, qy)`` as ``[..., 16]``
    int32 limbs (the key relaxed: any encoding below 2^256).  Returns
    ``ok [...]`` int32.  Rejects r or s out of range, high-s signatures
    (s > N // 2, the malleable twin), keys off the curve and a result at
    infinity, as the reference does.  A 2-D batch takes 26 kernel
    launches and reads only x of the result; other shapes run the
    un-fused ladder and the whole ``to_affine``, as the reference does
    (about 8,385 launches)."""
    r_ok = (1 - is_zero(r)) * big_lt(r, FN.m_limbs(r))
    # the low-s rule: s < N // 2 + 1
    s_ok = (1 - is_zero(s)) * big_lt(s, const_row(N // 2 + 1, s.device))
    q_ok = on_curve(qx, qy)
    s_inv = FN.inv_batched(s)
    z_mod = FN.red(_pad17(z))
    u1 = FN.mul(z_mod, s_inv)
    u2 = FN.mul(r, s_inv)
    X, Y, Z = strauss_gR(u1, u2, qx, qy)
    if r.dim() == 2:
        px, not_inf = to_affine_x(X, Z)
    else:
        px, _, not_inf = to_affine((X, Y, Z))
    px_mod = FN.red(_pad17(px))
    return r_ok * s_ok * q_ok * not_inf * eq(px_mod, r)
