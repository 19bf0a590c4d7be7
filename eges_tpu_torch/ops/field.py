"""Plain PyTorch versions of the field library the recovery kernels share.

Each function here is the twin of one ``_k_<name>`` helper of
``eges_tpu/ops/pallas_kernels.py`` (mod P ``:80-251``, mod N
``:1026-1190``, keccak ``:686-736``, the pipeline stages ``:1463-1670``),
and of the ``__device__`` function of the same name in
``csrc/field.cuh``.  Results are bit-identical to both: same 16-bit limbs,
same fold constants and fold order, same relaxed representation (F_P
values may sit anywhere in [0, 2^256)).

A value is one ``[..., 16]`` int64 tensor of limbs, least significant
first, and a per-row flag a ``[...]`` int64 tensor of 0/1.  int64 holds
every intermediate the uint32 arithmetic of the kernels produces without
wrapping; the only places where uint32 would wrap are the keccak lanes,
which are masked to 32 bits here.  Everything runs on any device, so
the same code is the CPU path of the port and the yardstick the kernels
are held against on the card.

The limb layout's constants and conversions (``P``, ``N``, ``NLIMBS``,
``int_to_limbs``, ``limbs_to_int``) are defined here, in the module the
rest of ``ops/`` builds on, and ``ops/bigint.py`` re-exports them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

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

M32 = 0xFFFFFFFF


def _limbs(x: int, n: int = NLIMBS) -> tuple[int, ...]:
    return tuple(int(v) for v in int_to_limbs(x, n))


P_LIMBS = _limbs(P)
# a - b == a + (0xFFFF - b) + SUBC (mod P), column-wise without borrows
SUBC_LIMBS = _limbs((1 << 256) - 2 * ((1 << 256) - P) + 1)
N_LIMBS = _limbs(N)
_N_DELTA = (1 << 256) - N
N_DELTA_LIMBS = _limbs(_N_DELTA, (_N_DELTA.bit_length() + 15) // 16)  # 9
# a - b == a + (0xFFFF - b) + FN_SUBC (mod N), both canonical
FN_SUBC_LIMBS = _limbs(2 * N - (1 << 256) + 1)


def const(limbs, like: torch.Tensor) -> torch.Tensor:
    """Limb constant as an int64 tensor on ``like``'s device."""
    return torch.tensor(limbs, dtype=torch.int64, device=like.device)


# ---------------------------------------------------------------------------
# mod P
# ---------------------------------------------------------------------------

def carry_tail(cols: torch.Tensor) -> torch.Tensor:
    """16 columns (each < 2^31) -> relaxed 16-limb value: two full carry
    chains with the 2^256 = 2^32 + 977 fold after each, then the closing
    5-step chain.  A chain is exact addition, so it runs here two limbs
    to an int64 word (8 steps, not 16) with the same result bit for bit;
    the closing chain drops the carry out of limb 4, as the kernel's
    does."""
    w = list((cols[..., 0::2] + (cols[..., 1::2] << 16)).unbind(-1))
    for _ in range(2):
        c = 0
        for j in range(8):
            t = w[j] + c
            w[j] = t & M32
            c = t >> 32
        w[0] = w[0] + c * 977      # limb 0
        w[1] = w[1] + c            # limb 2
    c = w[0] >> 32
    w[0] = w[0] & M32
    t = w[1] + c
    w[1] = t & M32
    w[2] = (w[2] & (MASK << 16)) | ((w[2] + (t >> 32)) & MASK)
    words = torch.stack(w, dim=-1)
    return torch.stack([words & MASK, words >> 16], dim=-1).reshape(
        cols.shape)


def mul_cols_vv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Uncarried schoolbook columns of ``a * b``: ``[..., na+nb]``.
    Column k sums lo(a_i b_j) over i+j = k and hi(a_i b_j) over
    i+j = k-1 (each < 2^21 for 16 x 16 limbs).  The ``[na, nb]`` partial
    products are sheared so that row i moves i places right (pad each
    row to na + nb, flatten, drop the last na, reshape to na + nb - 1
    columns), which lines the anti-diagonals up as columns."""
    na, nb = a.shape[-1], b.shape[-1]
    prod = a[..., :, None] * b[..., None, :]
    halves = torch.stack([prod & MASK, prod >> 16], dim=-3)
    w = na + nb
    sheared = F.pad(halves, (0, na)).flatten(-2)[..., :na * (w - 1)]
    cols = sheared.reshape(*halves.shape[:-2], na, w - 1).sum(-2)
    return F.pad(cols[..., 0, :], (0, 1)) + F.pad(cols[..., 1, :], (1, 0))


def mul_cols(a: torch.Tensor, b_const) -> torch.Tensor:
    """Uncarried columns of ``a`` times a limb constant (Python ints)."""
    b = const(b_const, a).expand(*a.shape[:-1], len(b_const))
    return mul_cols_vv(a, b)


def _fold_p(cols: torch.Tensor) -> torch.Tensor:
    """Fold columns >= 16 back via 2^256 = 2^32 + 977, as many passes as
    the width needs (two for a product)."""
    while cols.shape[-1] > 16:
        h = cols.shape[-1] - 16
        w = max(16, h + 2)
        hi = cols[..., 16:]
        cols = (F.pad(cols[..., :16], (0, w - 16))
                + F.pad(hi * 977, (0, w - h))
                + F.pad(hi, (2, w - h - 2)))
    return cols


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relaxed F_P product."""
    return carry_tail(_fold_p(mul_cols_vv(a, b)))


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry_tail(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Branchless a - b: a + (0xFFFF - b) + (2^256 - 2*delta + 1)."""
    return carry_tail(a + (MASK - b) + const(SUBC_LIMBS, a))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    if not 0 <= k < 16:
        raise ValueError("mul_small takes 0 <= k < 16")
    return carry_tail(a * k)


def is_zero_mod(a: torch.Tensor) -> torch.Tensor:
    """Relaxed a == 0 (mod P): the limbs are exactly 0 or exactly P."""
    z = (a == 0).all(-1)
    p = (a == const(P_LIMBS, a)).all(-1)
    return (z | p).to(torch.int64)


def select(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """flag ? a : b per row, flag a ``[...]`` tensor (nonzero = true)."""
    return torch.where((flag != 0)[..., None], a, b)


def jac_double(X1, Y1, Z1):
    """Jacobian doubling, a = 0 (dbl-2009-l)."""
    A = sqr(X1)
    B = sqr(Y1)
    C = sqr(B)
    t = sqr(add(X1, B))
    D = mul_small(sub(sub(t, A), C), 2)
    E = mul_small(A, 3)
    Fv = sqr(E)
    X3 = sub(Fv, mul_small(D, 2))
    Y3 = sub(mul(E, sub(D, X3)), mul_small(C, 8))
    Z3 = mul_small(mul(Y1, Z1), 2)
    return X3, Y3, Z3


def jac_add_mixed(X1, Y1, Z1, x2, y2):
    """Jacobian + affine (madd-2007-bl) with the exceptional cases taken
    branch-free: P1 at infinity, equal points (doubling), opposite
    points (infinity)."""
    Z1Z1 = sqr(Z1)
    U2 = mul(x2, Z1Z1)
    S2 = mul(mul(y2, Z1), Z1Z1)
    H = sub(U2, X1)
    r = sub(S2, Y1)

    HH = sqr(H)
    I = mul_small(HH, 4)
    J = mul(H, I)
    rr = mul_small(r, 2)
    V = mul(X1, I)
    X3 = sub(sub(sqr(rr), J), mul_small(V, 2))
    Y3 = sub(mul(rr, sub(V, X3)), mul_small(mul(Y1, J), 2))
    Z3 = mul(mul_small(Z1, 2), H)

    DX, DY, DZ = jac_double(X1, Y1, Z1)

    h0 = is_zero_mod(H)
    r0 = is_zero_mod(r)
    p1_inf = is_zero_mod(Z1)
    dbl = h0 * r0
    opp = h0 * (1 - r0)

    one = torch.zeros_like(X1)
    one[..., 0] = 1
    zero = torch.zeros_like(X1)
    X = select(dbl, DX, X3)
    Y = select(dbl, DY, Y3)
    Z = select(dbl, DZ, Z3)
    Z = select(opp, zero, Z)
    Y = select(opp, one, Y)
    X = select(p1_inf, x2, X)
    Y = select(p1_inf, y2, Y)
    Z = select(p1_inf, one, Z)
    return X, Y, Z


# ---------------------------------------------------------------------------
# mod N
# ---------------------------------------------------------------------------

def carry(cols: torch.Tensor, n_out: int) -> torch.Tensor:
    """Carry chain over small (< 2^31) columns -> ``n_out`` limbs."""
    out = []
    c = 0
    for t in cols.unbind(-1):
        t = t + c
        out.append(t & MASK)
        c = t >> 16
    while len(out) < n_out:
        out.append(c & MASK)
        c = c >> 16
    return torch.stack(out[:n_out], dim=-1)


def sub_const_chain(a: torch.Tensor, m_limbs):
    """Borrow chain ``a - const``: (difference limbs, borrow), borrow 1
    iff a < const."""
    out = []
    borrow = 0
    for k in range(16):
        t = a[..., k] + ((1 << 16) - m_limbs[k]) - borrow
        out.append(t & MASK)
        borrow = 1 - (t >> 16)
    return torch.stack(out, dim=-1), borrow


def cond_sub(a: torch.Tensor, m_limbs) -> torch.Tensor:
    """One conditional subtract of the constant ``m_limbs``."""
    out, borrow = sub_const_chain(a, m_limbs)
    return select(borrow, a, out)


def cond_sub_n(a: torch.Tensor) -> torch.Tensor:
    return cond_sub(a, N_LIMBS)


def cond_sub_p(a: torch.Tensor) -> torch.Tensor:
    """Relaxed F_P value -> canonical [0, P)."""
    return cond_sub(a, P_LIMBS)


@functools.lru_cache(maxsize=16)
def _limb_row(m_limbs: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(m_limbs, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=4)
def _limb_index(device: torch.device) -> torch.Tensor:
    return torch.arange(NLIMBS, device=device)


def lt_const(a: torch.Tensor, m_limbs) -> torch.Tensor:
    """a < const as a 0/1 flag, for limbs below 2^16: the most
    significant limb where the two differ decides.  The same flag as the
    borrow of ``sub_const_chain``, in a few whole-value operations (on
    the card the borrow chain is some eighty small launches), with the
    constant made once per device."""
    d = a - _limb_row(tuple(m_limbs), a.device)
    top = torch.where(d != 0, _limb_index(a.device), -1).amax(-1,
                                                            keepdim=True)
    lt = torch.gather(d, -1, top.clamp(min=0)) < 0
    return (lt & (top >= 0)).squeeze(-1).to(torch.int64)


def fn_red_cols(cols: torch.Tensor) -> torch.Tensor:
    """Small (< 2^31) columns, any width in [16, 32] -> canonical mod N:
    delta folds (32 -> 26 -> 20 -> 16 columns for a product), then two
    top-limb folds and two conditional subtracts."""
    while cols.shape[-1] > 16:
        lo = cols[..., :16]
        hi = carry(cols[..., 16:], cols.shape[-1] - 16 + 1)
        prod = mul_cols(hi, N_DELTA_LIMBS)
        w = max(16, prod.shape[-1])
        cols = F.pad(lo, (0, w - 16)) + F.pad(prod, (0, w - prod.shape[-1]))
    a17 = carry(cols, 17)
    for _ in range(2):
        fold = mul_cols(a17[..., 16:17], N_DELTA_LIMBS)[..., :16]
        fold = F.pad(fold, (0, 16 - fold.shape[-1]))
        a17 = carry(a17[..., :16] + fold, 17)
    return cond_sub_n(cond_sub_n(a17[..., :16]))


def fn_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a - b mod N (both canonical)."""
    return fn_red_cols(a + (MASK - b) + const(FN_SUBC_LIMBS, a))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1).to(torch.int64)


def fn_neg(a: torch.Tensor) -> torch.Tensor:
    """Canonical -a mod N (0 -> 0)."""
    zero = torch.zeros_like(a)
    return select(is_zero(a), zero, fn_sub(zero, a))


def fn_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical mod-N product."""
    return fn_red_cols(mul_cols_vv(a, b))


def mulhi8(a: torch.Tensor, g_limbs) -> torch.Tensor:
    """Limbs 24..31 of ``a`` times a 16-limb constant: ``(a * g) >> 384``
    as ``[..., 8]``, the GLV rounding step."""
    return carry(mul_cols(a, g_limbs), 32)[..., 24:32]


# ---------------------------------------------------------------------------
# keccak: 64-bit lanes as (lo, hi) pairs of 32-bit words held in int64
# ---------------------------------------------------------------------------

KECCAK_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
KECCAK_ROT = ((0, 36, 3, 41, 18), (1, 44, 10, 45, 2),
              (62, 6, 43, 15, 61), (28, 55, 25, 21, 56),
              (27, 20, 39, 8, 14))  # [x][y], lane x + 5y


def rot64(lo: torch.Tensor, hi: torch.Tensor, r: int):
    """Rotate the 64-bit lane (lo, hi) left by r."""
    r %= 64
    if r >= 32:
        lo, hi = hi, lo
        r -= 32
    if r == 0:
        return lo, hi
    return (((lo << r) & M32) | (hi >> (32 - r)),
            ((hi << r) & M32) | (lo >> (32 - r)))


# the digest words lo0 hi0 lo1 hi1 lo2 hi2 lo3 hi3 among the 50 words of
# a keccak_state
KECCAK_DIGEST_ROWS = (0, 25, 1, 26, 2, 27, 3, 28)


def keccak_words(w: torch.Tensor) -> torch.Tensor:
    """``[..., 34]`` little-endian 32-bit words of one padded 136-byte
    block -> ``[..., 8]`` digest words (Keccak-f[1600], 24 rounds)."""
    return keccak_state(w)[..., list(KECCAK_DIGEST_ROWS)]


def keccak_state(w: torch.Tensor) -> torch.Tensor:
    """``[..., 34]`` little-endian 32-bit words of one padded 136-byte
    block -> ``[..., 50]``: the state after Keccak-f[1600], the lo halves
    of lanes 0..24 then their hi halves (the TPU round-grid kernel's
    output block)."""
    words = w.unbind(-1)
    zero = torch.zeros_like(words[0])
    lo = [words[2 * i] for i in range(17)] + [zero] * 8
    hi = [words[2 * i + 1] for i in range(17)] + [zero] * 8
    for rnd in range(24):
        clo = [lo[x] ^ lo[x + 5] ^ lo[x + 10] ^ lo[x + 15] ^ lo[x + 20]
               for x in range(5)]
        chi_ = [hi[x] ^ hi[x + 5] ^ hi[x + 10] ^ hi[x + 15] ^ hi[x + 20]
                for x in range(5)]
        for x in range(5):
            rl, rh = rot64(clo[(x + 1) % 5], chi_[(x + 1) % 5], 1)
            dlo, dhi = clo[(x + 4) % 5] ^ rl, chi_[(x + 4) % 5] ^ rh
            for y in range(5):
                lo[x + 5 * y] = lo[x + 5 * y] ^ dlo
                hi[x + 5 * y] = hi[x + 5 * y] ^ dhi
        blo, bhi = [None] * 25, [None] * 25
        for x in range(5):
            for y in range(5):
                d = y + 5 * ((2 * x + 3 * y) % 5)
                blo[d], bhi[d] = rot64(lo[x + 5 * y], hi[x + 5 * y],
                                       KECCAK_ROT[x][y])
        for y in range(5):
            rl = blo[5 * y:5 * y + 5]
            rh = bhi[5 * y:5 * y + 5]
            for x in range(5):
                # (~a & b) with 32-bit words: (a ^ M32) & b
                lo[x + 5 * y] = rl[x] ^ ((rl[(x + 1) % 5] ^ M32)
                                         & rl[(x + 2) % 5])
                hi[x + 5 * y] = rh[x] ^ ((rh[(x + 1) % 5] ^ M32)
                                         & rh[(x + 2) % 5])
        lo[0] = lo[0] ^ (KECCAK_RC[rnd] & M32)
        hi[0] = hi[0] ^ (KECCAK_RC[rnd] >> 32)
    return torch.stack(lo + hi, dim=-1)


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------

def unpack_be(rows: torch.Tensor, off: int) -> torch.Tensor:
    """32 big-endian bytes of ``rows[..., off:off+32]`` (an integer type
    wider than a byte) -> 16 limbs, least significant first."""
    pairs = rows[..., off:off + 32].reshape(*rows.shape[:-1], 16, 2)
    return ((pairs[..., 0] << 8) | pairs[..., 1]).flip(-1)


def recover_prelude(r, s, v):
    """Range checks, the x candidate and y^2 = x^3 + 7 (relaxed).  ``v``
    is the raw recovery byte.  Returns (x, y_sq, ok)."""
    r_ok = (1 - is_zero(r)) * lt_const(r, N_LIMBS)
    s_ok = (1 - is_zero(s)) * lt_const(s, N_LIMBS)
    v_ok = (v < 4).to(torch.int64)
    hi = (v >= 2).to(torch.int64)
    # x = r + (v >= 2 ? N : 0), 17-limb carry chain
    x17 = carry(r + hi[..., None] * const(N_LIMBS, r), 17)
    x = x17[..., :16]
    x_ok = (x17[..., 16] == 0).to(torch.int64) * lt_const(x, P_LIMBS)
    seven = torch.zeros_like(x)
    seven[..., 0] = 7
    y_sq = carry_tail(mul(sqr(x), x) + seven)
    return x, y_sq, r_ok * s_ok * v_ok * x_ok


def y_fix(root, y_sq, v):
    """After the sqrt pow: canonicalise the root, check root^2 == y^2,
    and flip y to the parity v & 1.  Returns (y, y_ok)."""
    rc = cond_sub_p(sqr(root))
    ac = cond_sub_p(y_sq)
    y_ok = (rc == ac).all(-1).to(torch.int64)
    y0 = cond_sub_p(root)
    flip = (v & 1) ^ (y0[..., 0] & 1)
    return select(flip, neg(y0), y0), y_ok


def u1u2(z, s, r_inv):
    """u1 = -(z mod N) * r^-1, u2 = s * r^-1 (canonical mod N)."""
    z_mod = fn_red_cols(F.pad(z, (0, 1)))
    return fn_neg(fn_mul(z_mod, r_inv)), fn_mul(s, r_inv)


GLV_WINDOWS = 33


def glv_track(u, consts):
    """One scalar's GLV split: canonical mod-N ``u`` -> (k1 digits, neg1,
    k2 digits, neg2), each digit row ``[..., 33]`` MSD first.  ``consts``
    holds the limbs of (g1, g2, a1, a2, -b1, b2)."""
    g1, g2, a1, a2, b1n, b2 = consts

    def fn_mul_const(a, c):
        return fn_red_cols(mul_cols(a, c))

    # c_i = (u * g_i) >> 384, widened back to 16 limbs
    c1 = F.pad(mulhi8(u, g1), (0, 8))
    c2 = F.pad(mulhi8(u, g2), (0, 8))
    k1 = fn_sub(fn_sub(u, fn_mul_const(c1, a1)), fn_mul_const(c2, a2))
    k2 = fn_sub(fn_mul_const(c1, b1n), fn_mul_const(c2, b2))

    def sign_split(v):
        # a negative residue is recognised by size: |k| < 2^140 always
        hi = v[..., 8] >> 12
        for k in range(9, 16):
            hi = hi | v[..., k]
        n = (hi != 0).to(torch.int64)
        return select(n, fn_neg(v), v), n

    def digits(v):
        j = torch.arange(GLV_WINDOWS - 1, -1, -1, device=v.device)
        return (v[..., j // 4] >> (4 * (j % 4))) & 0xF

    k1m, n1 = sign_split(k1)
    k2m, n2 = sign_split(k2)
    return digits(k1m), n1, digits(k2m), n2


def limbs_to_words_be(a: torch.Tensor) -> torch.Tensor:
    """16 limbs -> 8 little-endian 32-bit words of the value's big-endian
    byte string (the keccak input order)."""
    w = torch.arange(8, device=a.device)
    hi_l = a[..., 15 - 2 * w]
    lo_l = a[..., 14 - 2 * w]
    return ((hi_l >> 8) | ((hi_l & 0xFF) << 8) | ((lo_l >> 8) << 16)
            | ((lo_l & 0xFF) << 24))


def recover_finish(X, Y, Z, zi_raw, ok_in):
    """Jacobian result + raw Z^-1 + accumulated validity -> affine
    (qx, qy) masked by the final ok, and the padded keccak block words
    of qx || qy (``[..., 34]``)."""
    inf = is_zero_mod(Z)
    zi = cond_sub_p(zi_raw)
    zi2 = sqr(zi)
    x = cond_sub_p(mul(X, zi2))
    y = cond_sub_p(mul(Y, mul(zi, zi2)))
    zero = torch.zeros_like(x)
    x = select(inf, zero, x)
    y = select(inf, zero, y)
    ok = ok_in * (1 - inf)
    qx = select(ok, x, zero)
    qy = select(ok, y, zero)
    # keccak padding of a 64-byte message in a 136-byte block: byte 64 =
    # 0x01 (word 16 lsb), byte 135 = 0x80 (word 33 msb)
    pad = torch.zeros(*qx.shape[:-1], 18, dtype=torch.int64,
                      device=qx.device)
    pad[..., 0] = 1
    pad[..., 17] = 0x80000000
    words = torch.cat([limbs_to_words_be(qx), limbs_to_words_be(qy), pad],
                      dim=-1)
    return qx, qy, ok, words
