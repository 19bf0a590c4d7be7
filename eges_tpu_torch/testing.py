"""Seeded inputs for the tests and ``chip_smoke.py``: field values with
the extremes, GLV scalars and values to canonicalise with theirs, curve
points, signed recovery rows and one row of each
invalid class, and classic-verify rows of every class with the host
model's answer.  Everything is made from a ``numpy.random.Generator``,
so a seed fixes every byte.  Also the pinned launch counts of each path,
the switch into the reference's TPU-tiling configuration, and the
transfer-flood sims the tests and ``chip_smoke.py`` phase ``sim`` run
(:func:`flood_sim`, :func:`sim_outcome`, :func:`canonical_dump`).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from eges_tpu_torch.crypto import secp256k1 as host
from eges_tpu_torch.ops.bigint import N, P, int_to_limbs
from eges_tpu_torch.ops.curve import GLV_LAM

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


def glv_scalars(rng: np.random.Generator, n: int):
    """n canonical mod-N scalars for the GLV split (#5): the edges 0, 1,
    2, N - 2, N - 1, lambda, lambda + 1 and N - lambda first, then random
    ones, about half of which split into a negative k1 or k2."""
    ext = [0, 1, 2, N - 2, N - 1, GLV_LAM, GLV_LAM + 1, N - GLV_LAM]
    vals = ext + [rand_int(rng, N) for _ in range(max(0, n - len(ext)))]
    return vals[:n]


def canon_values(rng: np.random.Generator, n: int):
    """n relaxed F_P values for the canonicalisation (#8): 0, 1, P - 2,
    P - 1, P, P + 1, 2^256 - 2 and 2^256 - 1 first, then values in
    [P, 2^256) (the ones it subtracts P from) alternating with values
    below 2^256."""
    ext = [0, 1, P - 2, P - 1, P, P + 1, (1 << 256) - 2, (1 << 256) - 1]
    vals = ext + [P + rand_int(rng, (1 << 256) - P) if i % 2 == 0
                  else rand_int(rng, 1 << 256)
                  for i in range(max(0, n - len(ext)))]
    return vals[:n]


def curve_points(rng: np.random.Generator, n: int):
    """n random affine points d*G as ``(x [n, 16], y [n, 16])`` limbs."""
    pts = [host.point_mul(1 + rand_int(rng, N - 1), host.G) for _ in range(n)]
    return limb_rows([p[0] for p in pts]), limb_rows([p[1] for p in pts])


def table_points(rng: np.random.Generator, n: int):
    """``point_table`` inputs: n rows of R as ``(x [n, 16], y [n, 16])``
    limbs whose classes alternate so that neighbouring rows part: row
    ``b % 4 == 0`` a curve point d*G; 1 a zero row; 2 the R that a
    zero-byte pad signature gives (x = 0, y the even root of 7, which is
    no square: not on the curve); 3 random values, not on the curve, the
    extremes of :func:`field_values` first.  Rows of x = 0 meet their own
    point at some entries of the table (the doubling path)."""
    y7 = pow(7, (P + 1) // 4, P)
    y7 = P - y7 if y7 & 1 else y7
    xs = field_values(rng, n)
    ys = [rand_int(rng, 1 << 256) for _ in range(n)]
    for b in range(n):
        if b % 4 == 0:
            xs[b], ys[b] = host.point_mul(1 + rand_int(rng, N - 1), host.G)
        elif b % 4 == 1:
            xs[b] = ys[b] = 0
        elif b % 4 == 2:
            xs[b], ys[b] = 0, y7
    return limb_rows(xs), limb_rows(ys)


def ladder_inputs(rng: np.random.Generator, B: int, wide: int,
                  windows: int = 33):
    """``strauss_tab`` inputs for ``B`` rows of ``wide`` columns (numpy
    uint32 ``dig [windows, 8, wide]``, ``neg [8, wide]``, ``trx``, ``tlrx``,
    ``try_ [256, wide]``) whose rows take every branch of the ladder,
    interleaved so that neighbouring rows part: row ``b % 4 == 0`` random
    digits and signs over random tables; 1 and 2 the tables of R = G with
    window 0 adding d*G and then d*R: the doubling path on row 1, and on
    row 2, whose third sign is set, opposite points (infinity, which the
    next adds start from); 3 random tables with half its digits zero."""
    from eges_tpu_torch.ops import curve

    tgx, tgy = curve._g_table16()
    tlx, _ = curve._g_lam_table16()
    g_rows = [np.asarray(t, np.uint32).reshape(256) for t in (tgx, tlx, tgy)]
    dig = rng.integers(0, 16, (windows, 8, wide)).astype(np.uint32)
    dig[:, 4:] = 0
    neg = rng.integers(0, 2, (8, wide)).astype(np.uint32)
    neg[4:] = 0
    tabs = [rng.integers(0, 1 << 16, (256, wide)).astype(np.uint32)
            for _ in range(3)]
    kind = np.arange(wide) % 4
    same = (kind == 1) | (kind == 2)
    for tab, g in zip(tabs, g_rows):
        tab[:, same] = g[:, None]
    d = rng.integers(1, 16, wide).astype(np.uint32)
    dig[0, 0, same] = d[same]
    dig[0, 1, same] = 0
    dig[0, 2, same] = d[same]
    dig[0, 3, same] = 0
    neg[0, same] = 0
    neg[2, same] = (kind[same] == 2).astype(np.uint32)
    zero = (kind == 3)[None, None, :] & (rng.integers(0, 2, dig.shape) == 0)
    dig[zero] = 0
    dig[:, :, B:] = 0
    neg[:, B:] = 0
    return dig, neg, *tabs


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


def prelude_rows(rng: np.random.Generator, n: int):
    """``n`` rows (n >= 21) for the prelude (#1), no signing needed (the
    prelude reads no key): first one of each class its checks tell apart,
    then random bytes with recovery ids 0-5.  The classes: r an x
    coordinate with v = 0 and 1; r + N one with v = 2 and 3; r = 0; s = N,
    N + 1 and 2^256 - 1; v = 4, 27 and 255; r = P - N with v = 2 (x = P);
    r + N past 2^256 (r = 2^256 - 1, and 2^256 - N: x = 2^256); an r that
    is no x coordinate; r = N - 1 (also with v = 2), r = N, s = N - 1; a
    row of 0xFF bytes; the hashes 0 and 2^256 - 1.  Returns ``(sigs [n,
    65] u8, hashes [n, 32] u8)``."""
    top = (1 << 256) - 1

    def x_coordinate(lo, hi, shift=0):
        while True:
            r = lo + rand_int(rng, hi - lo)
            if _is_x(r + shift):
                return r

    def no_x():
        while True:
            r = 1 + rand_int(rng, N - 1)
            if not _is_x(r):
                return r

    s = 1 + rand_int(rng, N - 1)
    classes = [(x_coordinate(1, N), s, 0), (x_coordinate(1, N), s, 1),
               (x_coordinate(1, P - N, N), s, 2),
               (x_coordinate(1, P - N, N), s, 3), (0, s, 0), (s, N, 0),
               (s, N + 1, 1), (s, top, 0), (s, s, 4), (s, s, 27),
               (s, s, 255), (P - N, s, 2), (top, s, 2), (top + 1 - N, s, 3),
               (no_x(), s, 0), (N - 1, s, 1), (N - 1, s, 2), (N, s, 0),
               (s, N - 1, 1), (top, top, 255), (s, s, 0)]
    if n < len(classes):
        raise ValueError(f"prelude_rows needs n >= {len(classes)}")
    sigs = rng.integers(0, 256, (n, 65), dtype=np.uint8)
    sigs[:, 64] = rng.integers(0, 6, n)
    hashes = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for i, (r, sv, v) in enumerate(classes):
        sigs[i, :32] = _be(r)
        sigs[i, 32:64] = _be(sv)
        sigs[i, 64] = v
    hashes[0], hashes[1] = 0, 0xFF
    return sigs, hashes


def pitched_rows(sigs, pitch: int, offset: int = 0):
    """``sigs [n, 65]`` uint8 rows (a tensor) laid out as the prelude may
    find them: each row ``pitch`` bytes after the one before, from
    ``offset`` bytes into a fresh buffer on their device, 0xAB in the
    bytes past 65.  Returns the ``[n, pitch]`` view."""
    import torch

    n = sigs.shape[0]
    buf = torch.full((n * pitch + offset,), 0xAB, dtype=torch.uint8,
                     device=sigs.device)
    view = buf[offset:].view(n, pitch)
    view[:, :65] = sigs
    return view


def host_recover(sig: np.ndarray, msg: np.ndarray):
    """The host model's answer for one row: (address, 64-byte public
    key) or None for an invalid row."""
    try:
        pub = host.ecdsa_recover(bytes(msg), bytes(sig))
    except ValueError:
        return None
    return host.pubkey_to_address(pub), pub


# ---------------------------------------------------------------------------
# classic verify
# ---------------------------------------------------------------------------

# every row class of classic verify, in the order verify_rows makes them;
# VERIFY_VALID are the classes the host model accepts
VERIFY_CLASSES = (
    "valid",          # a signed row (low s)
    "high_s_twin",    # (r, N - s) of a valid row: satisfies the curve
                      # equation, rejected by the low-s rule
    "wrong_pub",      # a valid row checked against another key
    "wrong_hash",     # a valid row checked against another hash
    "r_zero", "r_ge_n", "s_zero",
    "pub_off_curve",  # y + 1
    "pub_zero",       # (0, 0)
    "hash_zero",      # signed over 32 zero bytes: u1 = 0
    "hash_ge_n",      # signed over a hash >= N: z is reduced mod N
    "pub_x_plus_p",   # a key whose x is sent as x + P (relaxed encoding)
    "rx_ge_n",        # u1*G + u2*Q has x >= N: px is reduced mod N
    "s_half",         # s = N // 2, the largest s accepted
    "s_half_plus_1",  # s = N // 2 + 1, rejected by the low-s rule
)
VERIFY_VALID = ("valid", "hash_zero", "hash_ge_n", "pub_x_plus_p",
                "rx_ge_n", "s_half")


def _be(x: int, n: int = 32) -> np.ndarray:
    return np.frombuffer(x.to_bytes(n, "big"), np.uint8)


def _row(r: int, s: int, z: int, q, v: int = 0):
    """(sig [65], hash [32], pub [64]) uint8 of ints (the key's x may be
    a relaxed encoding below 2^256)."""
    return (np.concatenate([_be(r), _be(s), [v]]).astype(np.uint8), _be(z),
            np.concatenate([_be(q[0]), _be(q[1])]))


def _rand_point(rng: np.random.Generator):
    return host.point_mul(1 + rand_int(rng, N - 1), host.G)


def forge_for_pub(rng: np.random.Generator, q):
    """A signature ``(r, s, z)`` that verifies against the key ``q``
    without its private key: R = u1*G + u2*Q for random u1, u2, then
    r = R.x mod N, s = r / u2, z = u1 * s (mod N), drawn again until
    s <= N // 2."""
    while True:
        u1, u2 = 1 + rand_int(rng, N - 1), 1 + rand_int(rng, N - 1)
        pt = host.point_add(host.point_mul(u1, host.G),
                            host.point_mul(u2, q))
        if pt is None or pt[0] % N == 0:
            continue
        r = pt[0] % N
        s = r * pow(u2, -1, N) % N
        if s <= N // 2:
            return r, s, u1 * s % N


def forge_for_point(rng: np.random.Generator, pt, s: int):
    """A key ``q`` and hash ``z`` for which ``(r, s)`` with r = pt.x mod N
    verifies and u1*G + u2*Q lands on ``pt``: z = u1 * s for a random u1,
    u2 = r / s, Q = (pt - u1*G) / u2.  Returns (r, z, q)."""
    r = pt[0] % N
    u1 = 1 + rand_int(rng, N - 1)
    u2 = r * pow(s, -1, N) % N
    diff = host.point_add(pt, host.point_mul(N - u1, host.G))
    return r, u1 * s % N, host.point_mul(pow(u2, -1, N), diff)


def _point_with_x(x: int, odd: int):
    """The curve point with this x and y parity, or None."""
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    return (x, y if (y & 1) == odd else P - y)


def verify_rows(rng: np.random.Generator, n_valid: int):
    """``n_valid`` signed rows, then one row of each other class of
    VERIFY_CLASSES.  Returns ``(sigs [n, 65], hashes [n, 32], pubs
    [n, 64])`` uint8 and the class of each row."""
    rows, kinds = [], []

    def add(kind, sig, msg, pub):
        rows.append((sig, msg, pub))
        kinds.append(kind)

    def signed(msg: bytes):
        priv = (1 + rand_int(rng, N - 1)).to_bytes(32, "big")
        sig = np.frombuffer(host.ecdsa_sign(msg, priv), np.uint8)
        pub = np.frombuffer(host.privkey_to_pubkey(priv), np.uint8)
        return sig, np.frombuffer(msg, np.uint8), pub

    for _ in range(max(n_valid, 3)):
        add("valid", *signed(rng.bytes(32)))
    base = list(rows[:3])
    del rows[n_valid:], kinds[n_valid:]
    sig, msg, pub = base[0]
    twin = sig.copy()
    s = int.from_bytes(bytes(sig[32:64]), "big")
    twin[32:64] = _be(N - s)
    add("high_s_twin", twin, msg, pub)
    add("wrong_pub", base[1][0], base[1][1], base[2][2])
    add("wrong_hash", base[1][0], np.frombuffer(rng.bytes(32), np.uint8),
        base[1][2])
    for kind, lo, val in (("r_zero", 0, 0), ("r_ge_n", 0, N),
                          ("s_zero", 32, 0)):
        bad = sig.copy()
        bad[lo:lo + 32] = _be(val)
        add(kind, bad, msg, pub)
    off = pub.copy()
    off[32:] = _be((int.from_bytes(bytes(pub[32:]), "big") + 1) % P)
    add("pub_off_curve", sig, msg, off)
    add("pub_zero", sig, msg, np.zeros(64, np.uint8))
    add("hash_zero", *signed(bytes(32)))
    add("hash_ge_n", *signed(b"\xff" * 32))
    x = 1
    while (q := _point_with_x(x, 0)) is None:
        x += 1
    relaxed = (q[0] + P, q[1])             # x + P < 2^256 for x < 2^32 + 977
    r, s, z = forge_for_pub(rng, q)
    add("pub_x_plus_p", *_row(r, s, z, relaxed))
    while True:
        pt = _point_with_x(N + rand_int(rng, P - N), int(rng.integers(2)))
        if pt is not None:
            break
    s = 1 + rand_int(rng, N // 2)
    r, z, q = forge_for_point(rng, pt, s)
    add("rx_ge_n", *_row(r, s, z, q))
    for kind, s in (("s_half", N // 2), ("s_half_plus_1", N // 2 + 1)):
        r, z, q = forge_for_point(rng, _rand_point(rng), s)
        add(kind, *_row(r, s, z, q))
    sigs, hashes, pubs = (np.stack(c).astype(np.uint8) for c in zip(*rows))
    return sigs, hashes, pubs, kinds


def host_verify(sig: np.ndarray, msg: np.ndarray, pub: np.ndarray) -> bool:
    """The host model's answer for one classic-verify row."""
    return host.ecdsa_verify(bytes(msg), bytes(sig[:64]), bytes(pub))


# ---------------------------------------------------------------------------
# the un-fused path (stacked [K, N, ...] windows and single rows)
# ---------------------------------------------------------------------------

# Kernel launches of one un-fused batch, whatever its rows.  The ladder
# is 33 windows of 4 doublings (jac_double: 7 fp_mul, 5 fp_sub, 5
# fp_mul_small, 1 fp_add) and 4 adds (an fp_neg of the looked-up y, then
# jac_add_mixed: 11 fp_mul, 6 fp_sub, 5 fp_mul_small and a doubling);
# the R table is 14 more adds, normalised by a pow, an fp_canon and 4
# fp_mul, with 1 fp_mul for beta * x; the GLV split of both scalars is 2
# mulhi8, 4 fn_mul, 3 fn_sub and 2 fn_neg; to_affine is a pow, 4 fp_mul
# and 3 fp_canon.  Recovery adds y^2 (2 fp_mul, 1 fp_add), the root (a
# pow, 1 fp_mul and 3 fp_canon, 1 fp_neg), r^-1 (a pow), z mod N
# (fn_red17), u1 and u2 (2 fn_mul, 1 fn_neg); verify adds on_curve (3
# fp_mul, 1 fp_add, 2 fp_canon), s^-1 (a pow), z and px mod N (2
# fn_red17) and u1 and u2 (2 fn_mul).
UNFUSED_RECOVER_LAUNCHES = {
    "fp_mul": 3564, "fp_sub": 2266, "fp_mul_small": 2120, "fp_add": 279,
    "fp_neg": 133, "fp_canon": 7, "fn_mul": 6, "pow_mod": 4, "fn_sub": 3,
    "fn_neg": 3, "mulhi8": 2, "fn_red17": 1}
UNFUSED_VERIFY_LAUNCHES = {
    "fp_mul": 3564, "fp_sub": 2266, "fp_mul_small": 2120, "fp_add": 279,
    "fp_neg": 132, "fp_canon": 6, "fn_mul": 6, "pow_mod": 3, "fn_sub": 3,
    "fn_neg": 2, "mulhi8": 2, "fn_red17": 2}


def recover_class_rows(rng: np.random.Generator, n_signed: int = 3):
    """Rows of every recovery class: ``n_signed`` signed rows (more if
    they lack a parity), two recovery-id 2/3 rows (R.x = r + N) and one
    row of each of INVALID_CLASSES.  Returns ``(sigs [n, 65] u8, hashes [n, 32] u8,
    kinds)``."""
    sigs, hashes, _ = signed_rows(rng, n_signed)
    while len(set(sigs[:, 64])) < 2:        # both parities
        s, h, _ = signed_rows(rng, 1)
        sigs, hashes = np.concatenate([sigs, s]), np.concatenate([hashes, h])
    hx_s, hx_h = high_x_rows(rng, 2)
    bad_s, bad_h = invalid_rows(rng, sigs[0], hashes[0])
    kinds = (["signed"] * len(sigs) + ["high_x"] * 2
             + list(INVALID_CLASSES))
    return (np.concatenate([sigs, hx_s, bad_s]),
            np.concatenate([hashes, hx_h, bad_h]), kinds)


# ---------------------------------------------------------------------------
# the reference's TPU-tiling configuration
# ---------------------------------------------------------------------------

# the variables of harness/tpu_watch.py's rows8_1024 and kgrid16384 runs
TILING_ENV = {"EGES_TPU_LANE_BLOCK": "1024", "EGES_TPU_ROWS8": "1",
              "EGES_TPU_KECCAK_GRID": "1"}


@contextlib.contextmanager
def tiling_config(enabled: bool = True):
    """Run the body under the tiling configuration (``enabled=False``:
    with its three variables unset, the default configuration), then
    restore the variables as they were."""
    saved = {k: os.environ.get(k) for k in TILING_ENV}
    try:
        for k, v in TILING_ENV.items():
            if enabled:
                os.environ[k] = v
            else:
                os.environ.pop(k, None)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# Kernel launches of one fused batch under the tiling configuration: the
# default path's 18 and 26, with the pow, ladder and keccak launches on
# the tiling kernels.  The keccak path is one keccak_rows_grid a call.
TILING_RECOVER_LAUNCHES = {
    "recover_prelude": 1, "pow_mod_rows8": 4, "y_fix": 1, "u1u2": 1,
    "glv_digits": 1, "point_table": 1, "fp_mul": 5, "fp_canon": 1,
    "strauss_tab_rows8": 1, "recover_finish": 1, "keccak_rows_grid": 1}
TILING_VERIFY_LAUNCHES = {
    "pow_mod_rows8": 3, "fp_mul": 10, "fp_canon": 5, "fp_add": 1,
    "fn_red17": 2, "fn_mul": 2, "glv_digits": 1, "point_table": 1,
    "strauss_tab_rows8": 1}
# the un-fused path's pows go through pow_mod_rows8
TILING_UNFUSED_RECOVER_LAUNCHES = {
    ("pow_mod_rows8" if k == "pow_mod" else k): v
    for k, v in UNFUSED_RECOVER_LAUNCHES.items()}


# -- simulated clusters ---------------------------------------------------

# journal attrs measured in wall-clock time, per event type: a copy of
# the reference's harness/chaos.py VOLATILE_KEYS (the port may not import
# it), stripped before two runs' journals are compared
VOLATILE_KEYS = {
    "verifier_flush": ("waited_ms",),
    "block_committed": ("dt",),
    "verifier_mesh_dispatch": ("queue_wait_ms", "device", "occupancy",
                               "rows", "diverted"),
    "verifier_aot_load": ("load_s", "compile_s", "cold_start_s"),
    "telemetry_sample": ("metrics",),
    "commit_anatomy": ("wait_ms", "stage_ms", "compute_ms", "lane",
                       "trace", "traces"),
    "slo_firing": ("phase", "phase_share", "lane"),
    "ingress_ledger": ("costs",),
    "sched_adapt": ("window_ms", "target_rows", "burn_fast",
                    "burn_slow", "p99_ms", "wait_p50_ms", "decision"),
}

# Events that describe the verifier's windows, not the protocol: left
# out where a sim over the card is compared with one over a host
# verifier.  ``verifier_flush`` is one event per scheduler window: its
# rows, bucket and flush reason follow the 2 ms wall-clock deadline,
# and a host target serves singleton windows on the host (``diverted``)
# where the card takes them.  The ``verify_window`` stage of
# ``commit_anatomy`` mirrors each ``verifier_flush``.
VERIFIER_ONLY = {
    "verifier_flush": "one per scheduler window: rows, bucket and reason "
                      "follow the wall-clock deadline; a host target "
                      "diverts singletons, the card takes them",
    "commit_anatomy:verify_window": "mirrors verifier_flush, window by "
                                    "window",
}


def verifier_only(ev: dict) -> bool:
    """Whether a journal event is one of :data:`VERIFIER_ONLY`."""
    kind = ev.get("type")
    return kind in VERIFIER_ONLY or (
        f"{kind}:{ev.get('stage')}" in VERIFIER_ONLY)


def canonical_dump(by_node: dict, drop=None) -> bytes:
    """The reference's ``harness/chaos.py`` ``canonical_dump``: sorted
    node order, sorted JSON keys, :data:`VOLATILE_KEYS` stripped; events
    for which ``drop(ev)`` is true are left out."""
    import json

    lines = []
    for name in sorted(by_node):
        for ev in by_node[name]:
            if drop is not None and drop(ev):
                continue
            gone = VOLATILE_KEYS.get(ev.get("type"), ())
            ev = {k: v for k, v in ev.items() if k not in gone}
            lines.append(json.dumps(ev, sort_keys=True))
    return ("\n".join(lines) + "\n").encode()


def sim_transfers(n: int, senders: int, seed: int = 0):
    """``n`` signed value transfers, round robin over ``senders`` accounts
    whose keys come from ``seed`` (consecutive nonces each), and the
    genesis ``alloc`` that funds them."""
    from eges_tpu_torch.core.types import Transaction
    from eges_tpu_torch.crypto.keccak import keccak256

    privs = [keccak256(b"eges-sim-sender" + seed.to_bytes(8, "big")
                       + i.to_bytes(4, "big")) for i in range(senders)]
    alloc = {host.pubkey_to_address(host.privkey_to_pubkey(p)): 10 ** 21
             for p in privs}
    txs = [Transaction(nonce=i // senders, gas_price=1, gas_limit=21000,
                       to=b"\x5e" * 20, value=i + 1).signed(
                           privs[i % senders]) for i in range(n)]
    return txs, alloc


def flood_sim(verifier, txs, alloc, *, nodes: int, window: int,
              seed: int = 0, height: int = 0, gossip: bool = False,
              start_s: float = 0.01, max_s: float = 900.0, **kw):
    """A ``SimCluster(nodes, txpool=True, alloc=alloc, verifier=verifier,
    **kw)`` that a flooder peer hands ``txs`` in windows of ``window``,
    one window a virtual millisecond from ``start_s`` on; run until every
    node holds every transfer in its chain and is at ``height`` at least.
    Returns the cluster, stopped.

    With ``gossip`` the flooder gossips each window over the sim's
    network, as ``tests/test_columnar_ingest.py`` does: every node admits
    it through its gossip handler and relays each transfer it admitted to
    every peer once, nodes x transfers x (nodes - 1) deliveries.  Without
    it each pool admits the windows directly through the columnar seam
    that the gossip handler calls (``ingress.admit_remotes_window``), and
    nothing is relayed."""
    import eges_tpu_torch.consensus.messages as M
    from eges_tpu_torch.ingress import admit_remotes_window, columns_of
    from eges_tpu_torch.sim.cluster import SimCluster
    from eges_tpu_torch.utils import ledger

    c = SimCluster(nodes, seed=seed, txpool=True, alloc=alloc,
                   verifier=verifier, **kw)
    if gossip:
        c.net.join("flooder", "10.0.0.99", 9999, lambda d: None,
                   lambda d: None)
    fired = [0]
    n_win = -(-len(txs) // window)

    def deliver(k: int) -> None:
        part = txs[k * window:(k + 1) * window]
        if gossip:
            c.net.deliver_gossip("flooder", M.pack_gossip(
                M.GOSSIP_TXNS, M.TxnsMsg(txns=tuple(part))))
        else:
            for sn in c.live_nodes():
                with ledger.bind(sn.node.ledger, "peer:flooder"):
                    admit_remotes_window(sn.node.txpool, columns_of(part))
        fired[0] += 1

    for k in range(n_win):
        c.clock.call_later(start_s + 0.001 * k,
                           (lambda k: lambda: deliver(k))(k))
    hashes = [t.hash for t in txs]
    seen = {"h": -1, "done": False}

    def done() -> bool:
        if fired[0] < n_win:
            return False
        h = c.min_height()
        if h != seen["h"]:
            seen["h"] = h
            seen["done"] = h >= height and all(
                sn.chain.store.tx_loc(x) is not None
                for sn in c.nodes for x in hashes)
        return seen["done"]

    c.start()
    c.run(max_s, stop_condition=done)
    for sn in c.live_nodes():
        sn.node.stop()
    return c


def sim_outcome(c, txs=(), drop=None) -> dict:
    """What two runs of one sim must share, as JSON values: heights, each
    node's block hash at every height, the height at which each node's
    chain holds each of ``txs`` (None where it does not), txpool stats,
    the network's delivery counts, and the canonical journal dump
    (``drop`` as in :func:`canonical_dump`)."""
    out = {"heights": c.heights(), "hashes": [], "included": [],
           "pool": [], "net": c.net_stats()}
    for sn in c.nodes:
        out["hashes"].append(
            [(sn.chain.store.get_hash_by_number(h) or b"").hex()
             for h in range(sn.chain.height() + 1)])
        out["included"].append([sn.chain.store.tx_loc(t.hash) for t in txs])
        out["pool"].append(dict(sn.node.txpool.stats)
                           if sn.node.txpool is not None else None)
    out["dump"] = canonical_dump(c.journals(), drop).decode()
    return out
