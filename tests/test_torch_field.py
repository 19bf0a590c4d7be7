"""eges_tpu_torch's plain field library (ops/field.py) against the JAX
package's in-kernel library (the ``_k_*`` helpers of
eges_tpu/ops/pallas_kernels.py called with ``xp=np``): the same inputs,
made from a seed with numpy, through both; results equal bit for bit
(tolerance 0: the arithmetic is integer).  Inputs include 0, P-1, N-1,
relaxed values in [P, 2^256) and all-0xFFFF limbs."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from eges_tpu.ops import pallas_kernels as pk
from eges_tpu_torch import testing as tt
from eges_tpu_torch.ops import field as F
from eges_tpu_torch.ops.bigint import N, P

# a few rows a tensor: one torch thread is as fast, and leaves the cores
# to the other test workers
torch.set_num_threads(1)

ROWS = 16


def _lst(a):
    """[B, n] array -> list of n numpy [B] vectors (the _k_* layout)."""
    a = np.asarray(a, np.uint32)
    return [a[:, k].copy() for k in range(a.shape[1])]


def _unl(lst):
    return np.stack([np.asarray(v) for v in lst], axis=-1)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want)
                                  .astype(np.int64))


def _vals(seed, n=ROWS, bound=1 << 256):
    return tt.limb_rows(tt.field_values(np.random.default_rng(seed), n,
                                        bound))


def _pair(seed, bound=1 << 256):
    a = _vals(seed, bound=bound)
    return a, a[::-1].copy()


def _points(seed, n=8):
    """Jacobian points with random Z plus the exceptional rows of the
    mixed add: equal points, opposite points, accumulator at infinity."""
    rng = np.random.default_rng(seed)
    x, y = tt.curve_points(rng, n)
    z = tt.limb_rows([1 + tt.rand_int(rng, P - 1) for _ in range(n)])
    from eges_tpu_torch.ops.bigint import limbs_to_int
    X = np.stack([tt.limb_rows([limbs_to_int(x[i]) * limbs_to_int(z[i]) ** 2
                                % P])[0] for i in range(n)])
    Y = np.stack([tt.limb_rows([limbs_to_int(y[i]) * limbs_to_int(z[i]) ** 3
                                % P])[0] for i in range(n)])
    px, py = tt.curve_points(rng, n)
    for row in (1, 2):   # same point (doubling) and opposite point
        X[row], Y[row], z[row] = x[row], y[row], tt.limb_rows([1])[0]
        px[row] = x[row]
        py[row] = (y[row] if row == 1
                   else tt.limb_rows([P - limbs_to_int(y[row])])[0])
    z[3] = 0             # accumulator at infinity
    return X, Y, z, px, py


def _case_carry_tail(seed):
    cols = np.random.default_rng(seed).integers(0, 1 << 21, (ROWS, 16))
    _eq(F.carry_tail(_t(cols)), _unl(pk._k_carry_tail(_lst(cols), np)))


def _case_mul(seed):
    a, b = _pair(seed)
    _eq(F.mul(_t(a), _t(b)), _unl(pk._k_mul(_lst(a), _lst(b), np)))


def _case_sqr(seed):
    a = _vals(seed)
    _eq(F.sqr(_t(a)), _unl(pk._k_sqr(_lst(a), np)))


def _case_add(seed):
    a, b = _pair(seed)
    _eq(F.add(_t(a), _t(b)), _unl(pk._k_add(_lst(a), _lst(b), np)))


def _case_sub(seed):
    a, b = _pair(seed)
    _eq(F.sub(_t(a), _t(b)), _unl(pk._k_sub(_lst(a), _lst(b), np)))


def _case_neg(seed):
    a = _vals(seed)
    _eq(F.neg(_t(a)), _unl(pk._k_neg(_lst(a), np)))


def _case_mul_small(seed):
    a = _vals(seed)
    for k in (2, 3, 4, 8, 15):
        _eq(F.mul_small(_t(a), k), _unl(pk._k_mul_small(_lst(a), k, np)))


def _case_is_zero_mod(seed):
    a = _vals(seed)
    _eq(F.is_zero_mod(_t(a)), pk._k_is_zero_mod(_lst(a), np))


def _case_select(seed):
    a, b = _pair(seed)
    flag = np.random.default_rng(seed).integers(0, 2, ROWS).astype(np.uint32)
    _eq(F.select(_t(flag), _t(a), _t(b)),
        _unl(pk._k_select(flag, _lst(a), _lst(b), np)))


def _case_jac_double(seed):
    X, Y, Z, _, _ = _points(seed)
    got = F.jac_double(_t(X), _t(Y), _t(Z))
    want = pk._k_jac_double(_lst(X), _lst(Y), _lst(Z), np)
    for g, w in zip(got, want):
        _eq(g, _unl(w))


def _case_jac_add_mixed(seed):
    X, Y, Z, px, py = _points(seed)
    got = F.jac_add_mixed(_t(X), _t(Y), _t(Z), _t(px), _t(py))
    want = pk._k_jac_add_mixed(_lst(X), _lst(Y), _lst(Z), _lst(px),
                               _lst(py), np)
    for g, w in zip(got, want):
        _eq(g, _unl(w))


def _case_carry(seed):
    cols = np.random.default_rng(seed).integers(0, 1 << 21, (ROWS, 20))
    for n_out in (17, 20, 24, 32):
        _eq(F.carry(_t(cols), n_out),
            _unl(pk._k_carry(_lst(cols), n_out, np)))


def _case_mul_cols(seed):
    a = _vals(seed)
    for c in (pk._N_DELTA_LIMBS, [int(v) for v in tt.limb_rows([P])[0]]):
        _eq(F.mul_cols(_t(a), c), _unl(pk._k_mul_cols(_lst(a), c, np)))


def _case_mul_cols_vv(seed):
    a, b = _pair(seed)
    _eq(F.mul_cols_vv(_t(a), _t(b)),
        _unl(pk._k_mul_cols_vv(_lst(a), _lst(b), np)))


def _case_sub_const_chain(seed):
    a = _vals(seed)
    for m in (pk._N_LIMBS_C, pk._P_LIMBS):
        d, br = F.sub_const_chain(_t(a), m)
        wd, wb = pk._k_sub_const_chain(_lst(a), m, np)
        _eq(d, _unl(wd))
        _eq(br, wb)


def _case_cond_sub(seed):
    a = _vals(seed)
    _eq(F.cond_sub(_t(a), pk._N_LIMBS_C),
        _unl(pk._k_cond_sub(_lst(a), pk._N_LIMBS_C, np)))


def _case_cond_sub_n(seed):
    a = _vals(seed)
    _eq(F.cond_sub_n(_t(a)), _unl(pk._k_cond_sub_n(_lst(a), np)))


def _case_cond_sub_p(seed):
    a = _vals(seed)
    _eq(F.cond_sub_p(_t(a)), _unl(pk._k_cond_sub_p(_lst(a), np)))


def _case_fn_red_cols(seed):
    rng = np.random.default_rng(seed)
    w17 = np.concatenate([_vals(seed), rng.integers(0, 1 << 16, (ROWS, 1))],
                         axis=1)
    cols32 = rng.integers(0, 1 << 21, (ROWS, 32))
    for cols in (w17, cols32):
        _eq(F.fn_red_cols(_t(cols)), _unl(pk._k_fn_red_cols(_lst(cols), np)))


def _case_fn_sub(seed):
    a, b = _pair(seed, bound=N)
    _eq(F.fn_sub(_t(a), _t(b)), _unl(pk._k_fn_sub(_lst(a), _lst(b), np)))


def _case_is_zero(seed):
    a = _vals(seed)
    _eq(F.is_zero(_t(a)), pk._k_is_zero(_lst(a), np))


def _case_fn_neg(seed):
    a = _vals(seed, bound=N)
    _eq(F.fn_neg(_t(a)), _unl(pk._k_fn_neg(_lst(a), np)))


def _case_fn_mul(seed):
    a, b = _pair(seed, bound=N)
    _eq(F.fn_mul(_t(a), _t(b)), _unl(pk._k_fn_mul(_lst(a), _lst(b), np)))


def _case_lt_const(seed):
    a = _vals(seed)
    for m in (pk._N_LIMBS_C, pk._P_LIMBS):
        _eq(F.lt_const(_t(a), m), pk._k_lt_const(_lst(a), m, np))


def _case_rot64(seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, ROWS, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, ROWS, dtype=np.uint64).astype(np.uint32)
    lo[0] = hi[1] = 0xFFFFFFFF
    for r in (0, 1, 14, 31, 32, 36, 63):
        gl, gh = F.rot64(_t(lo), _t(hi), r)
        wl, wh = pk._k_rot64(lo, hi, r, np)
        _eq(gl, wl)
        _eq(gh, wh)


def _case_keccak_words(seed):
    w = np.random.default_rng(seed).integers(
        0, 1 << 32, (ROWS, 34), dtype=np.uint64).astype(np.uint32)
    w[0] = 0xFFFFFFFF
    _eq(F.keccak_words(_t(w)), _unl(pk._k_keccak_words(_lst(w), np)))


def _case_unpack_be(seed):
    rows = np.random.default_rng(seed).integers(0, 256, (ROWS, 65))
    for off in (0, 32):
        _eq(F.unpack_be(_t(rows), off),
            _unl(pk._k_unpack_be(_lst(rows), off, np)))


def _case_recover_prelude(seed):
    rng = np.random.default_rng(seed)
    r = _vals(seed)
    s = _vals(seed + 1)
    r[8] = tt.limb_rows([P - N])[0]          # r + N == P with v = 2
    v = rng.integers(0, 6, ROWS).astype(np.uint32)
    v[8] = 2
    got = F.recover_prelude(_t(r), _t(s), _t(v))
    want = pk._k_recover_prelude(_lst(r), _lst(s), v, np)
    _eq(got[0], _unl(want[0]))
    _eq(got[1], _unl(want[1]))
    _eq(got[2], want[2])


def _case_y_fix(seed):
    root, y_sq = _pair(seed)
    v = np.random.default_rng(seed).integers(0, 6, ROWS).astype(np.uint32)
    gy, gok = F.y_fix(_t(root), _t(y_sq), _t(v))
    wy, wok = pk._k_y_fix(_lst(root), _lst(y_sq), v, np)
    _eq(gy, _unl(wy))
    _eq(gok, wok)


def _case_u1u2(seed):
    z = _vals(seed)
    s, r_inv = _pair(seed + 1, bound=N)
    got = F.u1u2(_t(z), _t(s), _t(r_inv))
    want = pk._k_u1u2(_lst(z), _lst(s), _lst(r_inv), np)
    for g, w in zip(got, want):
        _eq(g, _unl(w))


def _case_glv_track(seed):
    from eges_tpu_torch.ops import curve

    u = _vals(seed, bound=N)
    consts = curve.glv_consts()
    got = F.glv_track(_t(u), consts)
    want = pk._k_glv_track(_lst(u), consts, np)
    for i, (g, w) in enumerate(zip(got, want)):
        _eq(g, _unl(w) if i % 2 == 0 else w)


def _case_limbs_to_words_be(seed):
    a = _vals(seed)
    _eq(F.limbs_to_words_be(_t(a)), _unl(pk._k_limbs_to_words_be(_lst(a),
                                                                  np)))


def _case_recover_finish(seed):
    X, Y, Z, _, _ = _points(seed)
    zi = _vals(seed, n=X.shape[0])
    ok = np.random.default_rng(seed).integers(0, 2, X.shape[0]).astype(
        np.uint32)
    got = F.recover_finish(_t(X), _t(Y), _t(Z), _t(zi), _t(ok))
    want = pk._k_recover_finish(_lst(X), _lst(Y), _lst(Z), _lst(zi), ok, np)
    _eq(got[0], _unl(want[0]))
    _eq(got[1], _unl(want[1]))
    _eq(got[2], want[2])
    _eq(got[3], _unl(want[3]))


CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
         if name.startswith("_case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_field_helper_matches_reference(name):
    CASES[name](seed=sum(map(ord, name)))


def test_every_reference_helper_has_a_case():
    """Each ``_k_*`` helper the eleven kernels use has a twin here."""
    used = {"carry_tail", "mul", "sqr", "add", "sub", "neg", "mul_small",
            "is_zero_mod", "select", "jac_double", "jac_add_mixed", "carry",
            "mul_cols", "mul_cols_vv", "sub_const_chain", "cond_sub",
            "cond_sub_n", "cond_sub_p", "fn_red_cols", "fn_sub", "is_zero",
            "fn_neg", "fn_mul", "lt_const", "rot64", "keccak_words",
            "unpack_be", "recover_prelude", "y_fix", "u1u2", "glv_track",
            "limbs_to_words_be", "recover_finish"}
    assert used <= set(CASES)
    for name in used:
        assert hasattr(pk, "_k_" + name) and hasattr(F, name)


def test_bigint_helpers_match_reference():
    """The port's copy of the limb layout against eges_tpu.ops.bigint."""
    import jax.numpy as jnp

    from eges_tpu.ops import bigint as jb
    from eges_tpu_torch.ops import bigint as tb

    for name in ("LIMB_BITS", "NLIMBS", "MASK", "P", "N"):
        assert getattr(tb, name) == getattr(jb, name), name
    rng = np.random.default_rng(7)
    for x in tt.field_values(rng, ROWS):
        np.testing.assert_array_equal(tb.int_to_limbs(x), jb.int_to_limbs(x))
        assert tb.limbs_to_int(tb.int_to_limbs(x)) == jb.limbs_to_int(
            jb.int_to_limbs(x)) == x
    np.testing.assert_array_equal(tb.int_to_limbs(N - 1, 17),
                                  jb.int_to_limbs(N - 1, 17))
    for bad in (-1, 1 << 256):
        with pytest.raises(ValueError):
            tb.int_to_limbs(bad)
    raw = rng.integers(0, 256, (ROWS, 32), dtype=np.uint8)
    raw[0] = 0xFF
    np.testing.assert_array_equal(tb.bytes_be_to_limbs(raw),
                                  np.asarray(jb.bytes_be_to_limbs(
                                      jnp.asarray(raw))))
