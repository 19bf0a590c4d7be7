"""alt_bn128 (BN254) curve operations and the optimal-ate pairing.

The port's copy of ``eges_tpu/crypto/bn254.py``, unchanged (pure Python).

Role parity with the reference's ``crypto/bn256`` (ref: crypto/bn256/
bn256_fast.go re-exporting the cloudflare implementation; consumed by
the EVM precompiles at addresses 0x06-0x08, core/vm/contracts.go
bn256Add/bn256ScalarMul/bn256Pairing).  Pure-Python reimplementation
from the curve definition (EIP-196/197 semantics) — the reference's
is Go+assembly; nothing is shared but the published curve constants.

Structure: F_p -> F_p2 (i^2 = -1) -> F_p12 (w^6 = 9 + i) tower, G2 on
the sextic twist, Miller loop over the 6u+2 NAF, final exponentiation
split into the easy (Frobenius) and hard parts.
"""

from __future__ import annotations

# field modulus and group order (EIP-196)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
N = 21888242871839275222246405745257275088548364400416034343698204186575808495617
U = 4965661367192848881  # BN parameter
H1 = 1  # G1 cofactor (prime-order curve)


def _inv(a: int, m: int = P) -> int:
    return pow(a, m - 2, m)


# ---------------------------------------------------------------------------
# F_p2 = F_p[i]/(i^2 + 1); elements (a, b) = a + b*i
# ---------------------------------------------------------------------------

def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


def f2_mul(x, y):
    a = (x[0] * y[0] - x[1] * y[1]) % P
    b = (x[0] * y[1] + x[1] * y[0]) % P
    return (a, b)


def f2_muls(x, s: int):
    return ((x[0] * s) % P, (x[1] * s) % P)


def f2_sqr(x):
    return f2_mul(x, x)


def f2_inv(x):
    d = _inv((x[0] * x[0] + x[1] * x[1]) % P)
    return ((x[0] * d) % P, (-x[1] * d) % P)


def f2_conj(x):
    return (x[0], (-x[1]) % P)


F2_ONE = (1, 0)
F2_ZERO = (0, 0)
XI = (9, 1)  # the twist constant 9 + i


# ---------------------------------------------------------------------------
# F_p12 as a 12-vector of F_p coefficients is clumsy; use F_p2[w]/(w^6 - xi):
# an element is a 6-tuple of F_p2 coefficients c0..c5 (w powers).
# ---------------------------------------------------------------------------

F12_ONE = (F2_ONE,) + (F2_ZERO,) * 5
F12_ZERO = (F2_ZERO,) * 6


def f12_mul(x, y):
    out = [F2_ZERO] * 11
    for i in range(6):
        if y[i] == F2_ZERO:
            continue
        for j in range(6):
            if x[j] == F2_ZERO:
                continue
            out[i + j] = f2_add(out[i + j], f2_mul(x[j], y[i]))
    # reduce w^k for k >= 6: w^6 = xi
    for k in range(10, 5, -1):
        if out[k] != F2_ZERO:
            out[k - 6] = f2_add(out[k - 6], f2_mul(out[k], XI))
    return tuple(out[:6])


def f12_sqr(x):
    return f12_mul(x, x)


def f12_conj(x):
    """Conjugate in F_p12/F_p6: negate odd w-powers."""
    return tuple(c if k % 2 == 0 else f2_neg(c) for k, c in enumerate(x))


def f12_inv(x):
    """Inverse via the tower norm down to F_p2 (compute adjugate through
    the conjugate chain: for w^6 = xi, use N(x) = prod of Galois
    conjugates; implemented with linear algebra over F_p2)."""
    # Solve x * y = 1 as a 6x6 linear system over F_p2 (Gaussian
    # elimination).  Slow but correct; pairing checks per txn are few.
    rows = []
    for j in range(6):
        # column j of multiplication-by-x matrix: x * w^j
        col = [F2_ZERO] * 11
        for i in range(6):
            col[i + j] = x[i]
        for k in range(10, 5, -1):
            if col[k] != F2_ZERO:
                col[k - 6] = f2_add(col[k - 6], f2_mul(col[k], XI))
        rows.append(col[:6])
    # build augmented system M * y = e0 where M[i][j] = rows[j][i]
    M = [[rows[j][i] for j in range(6)] for i in range(6)]
    rhs = [F2_ONE if i == 0 else F2_ZERO for i in range(6)]
    for c in range(6):
        piv = next(r for r in range(c, 6) if M[r][c] != F2_ZERO)
        M[c], M[piv] = M[piv], M[c]
        rhs[c], rhs[piv] = rhs[piv], rhs[c]
        inv_p = f2_inv(M[c][c])
        M[c] = [f2_mul(v, inv_p) for v in M[c]]
        rhs[c] = f2_mul(rhs[c], inv_p)
        for r in range(6):
            if r != c and M[r][c] != F2_ZERO:
                f = M[r][c]
                M[r] = [f2_sub(v, f2_mul(f, vc))
                        for v, vc in zip(M[r], M[c])]
                rhs[r] = f2_sub(rhs[r], f2_mul(f, rhs[c]))
    return tuple(rhs)


def f12_pow(x, e: int):
    out = F12_ONE
    base = x
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sqr(base)
        e >>= 1
    return out


# Frobenius: x -> x^p. On coefficients: c_k -> conj(c_k) * gamma_k where
# gamma_k = xi^(k*(p-1)/6).
_GAMMA = []


def _gammas():
    global _GAMMA
    if _GAMMA:
        return _GAMMA
    e = (P - 1) // 6
    # xi^e in F_p2
    g1 = _f2_pow(XI, e)
    cur = F2_ONE
    out = []
    for _ in range(6):
        out.append(cur)
        cur = f2_mul(cur, g1)
    _GAMMA = out
    return out


def _f2_pow(x, e: int):
    out = F2_ONE
    base = x
    while e:
        if e & 1:
            out = f2_mul(out, base)
        base = f2_sqr(base)
        e >>= 1
    return out


def f12_frobenius(x):
    g = _gammas()
    return tuple(f2_mul(f2_conj(c), g[k]) for k, c in enumerate(x))


# ---------------------------------------------------------------------------
# G1 (over F_p) and G2 (over F_p2, the twist y^2 = x^3 + 3/xi)
# ---------------------------------------------------------------------------

B1 = 3
B2 = f2_mul((3, 0), f2_inv(XI))

G1 = (1, 2)
G2 = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - x * x * x - B1) % P == 0


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_mul(k: int, pt):
    # NO reduction mod N, mirroring g2_mul and bls12_381.g1_mul: the
    # `order*pt == O` subgroup checks there rely on the full scalar, and
    # the two curve modules keep one scalar-mult contract (bn254 G1 has
    # cofactor 1, so reduction would be harmless HERE — but restoring it
    # would fork the contract and invite the vacuous-check bug back)
    if k < 0:
        raise ValueError("negative scalar")
    out = None
    add = pt
    while k:
        if k & 1:
            out = g1_add(out, add)
        add = g1_add(add, add)
        k >>= 1
    return out


def g1_in_subgroup(pt) -> bool:
    """G1 has cofactor 1 (prime-order curve): on-curve IS in-subgroup."""
    return g1_is_on_curve(pt)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = f2_sqr(y)
    rhs = f2_add(f2_mul(f2_sqr(x), x), B2)
    return lhs == rhs


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_muls(f2_sqr(x1), 3), f2_inv(f2_muls(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_mul(k: int, pt):
    if k < 0:  # see g1_mul: no reduction, subgroup checks need N*pt
        raise ValueError("negative scalar")
    out = None
    add = pt
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


def g2_neg(pt):
    return None if pt is None else (pt[0], f2_neg(pt[1]))


def g2_in_subgroup(pt) -> bool:
    """G2's curve has cofactor > 1: membership of the order-N subgroup
    must be checked explicitly (the reference's bn256 enforces this in
    unmarshalling)."""
    return g2_is_on_curve(pt) and g2_mul(N, pt) is None


# ---------------------------------------------------------------------------
# optimal ate pairing
# ---------------------------------------------------------------------------


def _line(Q1, Q2, Pp):
    """Line through Q1,Q2 (G2 twist coords) evaluated at the G1 point
    ``Pp``, as a sparse F_p12 element.

    Untwisting sends a G2 point (x', y') to (x'·w^2, y'·w^3), so a
    twist-coordinate slope ``lam`` becomes ``lam·w`` in F_p12, and

        l(P) = (yP - yR) - lam12·(xP - xR)
             = yP·w^0 - (lam·xP)·w^1 + (lam·x1 - y1)·w^3

    The vertical line (R + (-R)) degenerates to x-coordinates only:
    ``xP·w^0 - x1·w^2``.
    """
    x1, y1 = Q1
    x2, y2 = Q2
    xp, yp = Pp
    out = [F2_ZERO] * 6
    if x1 == x2 and f2_add(y1, y2) == F2_ZERO:
        out[0] = (xp % P, 0)
        out[2] = f2_neg(x1)
        return tuple(out)
    if x1 == x2 and y1 == y2:
        lam = f2_mul(f2_muls(f2_sqr(x1), 3), f2_inv(f2_muls(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    out[0] = (yp % P, 0)
    out[1] = f2_neg(f2_muls(lam, xp))
    out[3] = f2_sub(f2_mul(lam, x1), y1)
    return tuple(out)


def _miller(Q, Pp):
    """Miller loop over 6u+2 with the two Frobenius line corrections."""
    t = 6 * U + 2
    f = F12_ONE
    R = Q
    for bit in bin(t)[3:]:
        f = f12_mul(f12_sqr(f), _line(R, R, Pp))
        R = g2_add(R, R)
        if bit == "1":
            f = f12_mul(f, _line(R, Q, Pp))
            R = g2_add(R, Q)
    # Frobenius corrections: Q1 = pi_p(Q), Q2 = -pi_p^2(Q)
    q1 = _g2_frob(Q)
    q2 = g2_neg(_g2_frob(q1))
    f = f12_mul(f, _line(R, q1, Pp))
    R = g2_add(R, q1)
    f = f12_mul(f, _line(R, q2, Pp))
    return f


_FROB_X = None
_FROB_Y = None


def _g2_frob(pt):
    """pi_p on the twist: (x, y) -> (conj(x)*c_x, conj(y)*c_y) with
    c_x = xi^((p-1)/3), c_y = xi^((p-1)/2)."""
    global _FROB_X, _FROB_Y
    if _FROB_X is None:
        _FROB_X = _f2_pow(XI, (P - 1) // 3)
        _FROB_Y = _f2_pow(XI, (P - 1) // 2)
    x, y = pt
    return (f2_mul(f2_conj(x), _FROB_X), f2_mul(f2_conj(y), _FROB_Y))


def _final_exp(f):
    """f^((p^12 - 1)/N): easy part (p^6-1)(p^2+1), then the hard part by
    plain exponentiation of the cofactor (slow-but-simple; the pairing
    precompile is not on the consensus hot path)."""
    # easy: f^(p^6 - 1) = conj(f) * f^-1 ; then ^(p^2 + 1)
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frobenius(f12_frobenius(f)), f)
    # hard part: (p^4 - p^2 + 1)/N
    hard = (P**4 - P**2 + 1) // N
    return f12_pow(f, hard)


def pairing_check(pairs) -> bool:
    """True iff prod e(P_i, Q_i) == 1 (the 0x08 precompile's predicate,
    EIP-197).  ``pairs``: list of (g1_point|None, g2_point|None)."""
    f = F12_ONE
    for Pp, Q in pairs:
        if Pp is None or Q is None:
            continue  # e(0, Q) = e(P, 0) = 1
        f = f12_mul(f, _miller(Q, Pp))
    return _final_exp(f) == F12_ONE


def pairing(Pp, Q):
    """e(P, Q) as an F_p12 element (tests/bilinearity checks)."""
    if Pp is None or Q is None:
        return F12_ONE
    return _final_exp(_miller(Q, Pp))
