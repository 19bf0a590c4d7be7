"""The six glue kernels of the un-fused path (``fp_sub``, ``fp_neg``,
``fp_mul_small``, ``fn_sub``, ``fn_neg``, ``mulhi8``) and the modules
built on them, on the CPU.

- Each kernel's plain version against the JAX package's numpy twin
  (``_k_sub``, ``_k_neg``, ``_k_mul_small``, ``_k_fn_sub``, ``_k_fn_neg``,
  ``_k_mul_cols`` then ``_k_carry(., 32)[24:32]``, all with ``xp=np``),
  bit for bit (tolerance 0: the arithmetic is integer), on seeded rows
  and on the edge rows of each.
- Under ``slow``: the same kernels against the reference's Pallas
  wrappers in interpret mode.
- The port's ``jac_double``, ``jac_add_mixed``, ``_glv_decompose`` and
  ``to_affine`` (``ops/ec.py`` on the ``FP``/``FN`` front door of
  ``ops/bigint.py``) at a stacked ``[2, 3, 16]`` shape against the twins
  and against the host model's integers, the mixed add's exceptional
  rows among them."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from eges_tpu.ops import pallas_kernels as pk
from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto import secp256k1 as host
from eges_tpu_torch.ops import bigint, curve, ec
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import N, P, limbs_to_int

# a few rows a tensor: one torch thread is as fast, and leaves the cores
# to the other test workers
torch.set_num_threads(1)

R = K.from_reference
U = K.to_reference
ROWS = 16
G1, G2 = curve._G_G1, curve._G_G2


def _lst(a):
    a = np.asarray(a, np.uint32)
    return [a[:, k].copy() for k in range(a.shape[1])]


def _unl(lst):
    return np.stack([np.asarray(v, np.uint32) for v in lst], axis=-1)


def _vals(seed, n=ROWS, bound=1 << 256):
    return tt.limb_rows(tt.field_values(np.random.default_rng(seed), n,
                                        bound))


def _mulhi8_twin(a, g):
    g_limbs = [int(v) for v in bigint.int_to_limbs(g)]
    return _unl(pk._k_carry(pk._k_mul_cols(_lst(a), g_limbs, np), 32,
                            np)[24:32])


# kernel -> (wrapper call, numpy twin, operand bound, number of operands)
CASES = {
    "fp_sub": (K.fp_sub_pallas,
               lambda a, b: _unl(pk._k_sub(_lst(a), _lst(b), np)), 1 << 256,
               2),
    "fp_neg": (K.fp_neg_pallas, lambda a: _unl(pk._k_neg(_lst(a), np)),
               1 << 256, 1),
    **{f"fp_mul_small_{k}": (
        lambda a, k=k: K.fp_mul_small_pallas(a, k),
        lambda a, k=k: _unl(pk._k_mul_small(_lst(a), k, np)), 1 << 256, 1)
       for k in (2, 3, 4, 8)},
    "fn_sub": (K.fn_sub_pallas,
               lambda a, b: _unl(pk._k_fn_sub(_lst(a), _lst(b), np)), N, 2),
    "fn_neg": (K.fn_neg_pallas, lambda a: _unl(pk._k_fn_neg(_lst(a), np)),
               N, 1),
    "mulhi8_g1": (lambda a: K.mulhi8_pallas(a, G1),
                  lambda a: _mulhi8_twin(a, G1), N, 1),
    "mulhi8_g2": (lambda a: K.mulhi8_pallas(a, G2),
                  lambda a: _mulhi8_twin(a, G2), N, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernel_matches_numpy_twin(case):
    kern, twin, bound, arity = CASES[case]
    ops = [_vals(41 + i, bound=bound) for i in range(arity)]
    ops[1:] = [o[::-1].copy() for o in ops[1:]]      # extremes meet others
    got = U(kern(*(R(o) for o in ops)))
    np.testing.assert_array_equal(got, twin(*ops))


# edge rows: F_P kernels take relaxed values, the mod-N ones canonical
_FP_EDGES = [0, 1, P - 1, P, (1 << 256) - 1]
_FN_EDGES = [0, 1, N - 1, N - 2]


def _meaning(case, a, b):
    """The integer each row must hold (mod P for the relaxed F_P
    results, exactly otherwise)."""
    if case == "fp_sub":
        return (a - b) % P
    if case == "fp_neg":
        return -a % P
    if case.startswith("fp_mul_small"):
        return int(case.rsplit("_", 1)[1]) * a % P
    if case == "fn_sub":
        return (a - b) % N
    if case == "fn_neg":
        return -a % N
    g = G1 if case.endswith("g1") else G2
    return (a * g >> 384) & ((1 << 128) - 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_rows(case):
    """Every pairing of the edge values (0, 1, P - 1, P and all-0xFFFF
    limbs for F_P; 0, 1, N - 2, N - 1 for mod N, equal operands among
    them): the twin's bits and the integer they stand for."""
    kern, twin, bound, arity = CASES[case]
    edges = _FP_EDGES if bound > N else _FN_EDGES
    if arity == 2:
        pairs = [(x, y) for x in edges for y in edges]
    else:
        pairs = [(x, 0) for x in edges]
    a = tt.limb_rows([x for x, _ in pairs])
    b = tt.limb_rows([y for _, y in pairs])
    ops = (a, b)[:arity]
    got = U(kern(*(R(o) for o in ops)))
    np.testing.assert_array_equal(got, twin(*ops))
    for row, (x, y) in zip(got, pairs):
        v = limbs_to_int(row)
        want = _meaning(case, x, y)
        if case.startswith("fp_"):
            assert v % P == want and v < 1 << 256, (case, x, y)
        else:
            assert v == want, (case, x, y)


def test_glue_kernels_are_listed():
    glue = ("fp_sub", "fp_neg", "fp_mul_small", "fn_sub", "fn_neg",
            "mulhi8")
    assert K.KERNELS[-6:] == glue
    for name in glue:
        assert K.SOURCE_OF[name] == "glue.cu" and K.LAUNCHES[name] == 0


def test_wrapper_checks():
    a = R(_vals(51, 5))
    assert K.mulhi8_pallas(a, G1).shape == (5, 8)
    for bad in (-1, 16):
        with pytest.raises(ValueError):
            K.fp_mul_small_pallas(a, bad)
    with pytest.raises(ValueError):
        K.mulhi8_pallas(a, 1 << 256)
    with pytest.raises(ValueError):
        K.fp_sub_pallas(a, a[:4].contiguous())
    with pytest.raises(ValueError):
        K.fn_neg_pallas(a[:, :8].contiguous())
    with pytest.raises(TypeError):
        K.fp_neg_pallas(a.to(torch.int64))


def test_front_door_flattens_any_shape():
    """``FP``/``FN`` methods on ``[2, 3, 16]`` and ``[16]`` operands give
    the rows of their kernel on the flattened ``[-1, 16]`` operands."""
    a = _vals(52, 6)
    b = _vals(53, 6)[::-1].copy()
    for lead in ((2, 3), ()):
        n = int(np.prod(lead, dtype=int))
        at, bt = (R(x[:n]).reshape(*lead, 16) for x in (a, b))
        for got, want in (
                (bigint.FP.sub(at, bt), K.fp_sub_pallas(R(a[:n]), R(b[:n]))),
                (bigint.FP.mul_small(at, 8),
                 K.fp_mul_small_pallas(R(a[:n]), 8)),
                (bigint.FN.neg(at), K.fn_neg_pallas(R(a[:n])))):
            assert got.shape == (*lead, 16)
            np.testing.assert_array_equal(U(got).reshape(-1, 16), U(want))
    with pytest.raises(ValueError):
        bigint.FP.sub(R(a), R(a[:3]))


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernel_matches_pallas_interpret(case):
    """Against the reference's own ``pallas_call`` in interpret mode."""
    import jax.numpy as jnp

    kern, _, bound, arity = CASES[case]
    ops = [_vals(61 + i, bound=bound) for i in range(arity)]
    name, _, arg = case.rpartition("_")
    if case.startswith("fp_mul_small"):
        want = pk.fp_mul_small_pallas(jnp.asarray(ops[0]), int(arg),
                                      interpret=True)
    elif case.startswith("mulhi8"):
        want = pk.mulhi8_pallas(jnp.asarray(ops[0]),
                                G1 if arg == "g1" else G2, interpret=True)
    else:
        want = getattr(pk, case + "_pallas")(
            *(jnp.asarray(o) for o in ops), interpret=True)
    np.testing.assert_array_equal(U(kern(*(R(o) for o in ops))),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# modules at a stacked shape
# ---------------------------------------------------------------------------

LEAD = (2, 3)


def _stack(a):
    """[6, 16] uint32 rows -> the port's [2, 3, 16] int32 tensor."""
    return R(a).reshape(*LEAD, 16)


def _rows(t):
    return U(t).reshape(-1, 16)


def _points(seed):
    """Six Jacobian accumulators and affine addends: random rows, then
    the mixed add's exceptional rows: equal points (row 1), opposite
    points (row 2), the accumulator at infinity (row 3)."""
    rng = np.random.default_rng(seed)
    n = 6
    x, y = tt.curve_points(rng, n)
    z = [1 + tt.rand_int(rng, P - 1) for _ in range(n)]
    X = tt.limb_rows([limbs_to_int(x[i]) * z[i] ** 2 % P for i in range(n)])
    Y = tt.limb_rows([limbs_to_int(y[i]) * z[i] ** 3 % P for i in range(n)])
    Z = tt.limb_rows(z)
    px, py = tt.curve_points(rng, n)
    for row in (1, 2):
        X[row], Y[row], Z[row] = x[row], y[row], tt.limb_rows([1])[0]
        px[row] = x[row]
        py[row] = (y[row] if row == 1
                   else tt.limb_rows([P - limbs_to_int(y[row])])[0])
    Z[3] = 0
    return X, Y, Z, px, py


def _affine(X, Y, Z):
    """Host-model affine point of a Jacobian row (None at infinity)."""
    X, Y, Z = (limbs_to_int(v) for v in (X, Y, Z))
    if Z % P == 0:
        return None
    zi = pow(Z, P - 2, P)
    return X * zi * zi % P, Y * zi * zi * zi % P


def test_jac_double_at_a_stacked_shape():
    X, Y, Z, _, _ = _points(71)
    got = ec.jac_double(tuple(_stack(v) for v in (X, Y, Z)))
    want = pk._k_jac_double(_lst(X), _lst(Y), _lst(Z), np)
    for g, w in zip(got, want):
        assert g.shape == (*LEAD, 16)
        np.testing.assert_array_equal(_rows(g), _unl(w))
    G = [_rows(g) for g in got]
    for i in range(6):
        pt = _affine(X[i], Y[i], Z[i])
        assert _affine(G[0][i], G[1][i], G[2][i]) == (
            None if pt is None else host.point_add(pt, pt))


def test_jac_add_mixed_at_a_stacked_shape():
    X, Y, Z, px, py = _points(72)
    got = ec.jac_add_mixed(tuple(_stack(v) for v in (X, Y, Z)),
                           _stack(px), _stack(py))
    want = pk._k_jac_add_mixed(_lst(X), _lst(Y), _lst(Z), _lst(px),
                               _lst(py), np)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_rows(g), _unl(w))
    G = [_rows(g) for g in got]
    for i in range(6):
        q = (limbs_to_int(px[i]), limbs_to_int(py[i]))
        assert _affine(G[0][i], G[1][i], G[2][i]) == host.point_add(
            _affine(X[i], Y[i], Z[i]), q), i
    # the exceptional rows: doubling, opposite points, P1 at infinity
    assert _affine(G[0][2], G[1][2], G[2][2]) is None
    assert _affine(G[0][3], G[1][3], G[2][3]) == (limbs_to_int(px[3]),
                                                  limbs_to_int(py[3]))


def test_to_affine_at_a_stacked_shape():
    X, Y, Z, _, _ = _points(73)
    Z[4] = tt.limb_rows([P])[0]          # the relaxed zero: infinity too
    x, y, ok = ec.to_affine(tuple(_stack(v) for v in (X, Y, Z)))
    assert ok.shape == LEAD
    xs, ys, oks = _rows(x), _rows(y), U(ok).reshape(-1)
    for i in range(6):
        pt = _affine(X[i], Y[i], Z[i])
        if pt is None:
            assert oks[i] == 0 and not xs[i].any() and not ys[i].any()
        else:
            assert oks[i] == 1
            assert (limbs_to_int(xs[i]), limbs_to_int(ys[i])) == pt


def test_glv_decompose_at_a_stacked_shape():
    """The stacked ``[2, 2, 3, 16]`` split (both scalars of
    ``strauss_gR``): the same magnitudes and signs as the twin, and
    k = +-k1 + lambda * (+-k2) (mod N) with both magnitudes below
    2^129."""
    u = _vals(74, 12, N)
    k1, n1, k2, n2 = ec._glv_decompose(R(u).reshape(2, *LEAD, 16))
    assert k1.shape == (2, *LEAD, 16) and n1.shape == (2, *LEAD)
    d1, tn1, d2, tn2 = pk._k_glv_track(_lst(u), curve.glv_consts(), np)
    np.testing.assert_array_equal(U(n1).reshape(-1), tn1)
    np.testing.assert_array_equal(U(n2).reshape(-1), tn2)
    # the twin gives MSD-first digits of the magnitudes
    digs = U(ec._digits33(k1)).reshape(-1, 33)[:, ::-1]
    np.testing.assert_array_equal(digs, _unl(d1))
    digs = U(ec._digits33(k2)).reshape(-1, 33)[:, ::-1]
    np.testing.assert_array_equal(digs, _unl(d2))
    m1, m2 = _rows(k1), _rows(k2)
    s1, s2 = U(n1).reshape(-1), U(n2).reshape(-1)
    for i in range(12):
        a = limbs_to_int(m1[i]) * (-1 if s1[i] else 1)
        b = limbs_to_int(m2[i]) * (-1 if s2[i] else 1)
        assert max(abs(a), abs(b)) < 1 << 129
        assert (a + curve.GLV_LAM * b - limbs_to_int(u[i])) % N == 0


def test_sqrt_at_a_stacked_shape():
    """``FP.sqrt`` runs the pow kernel for every shape; its root may be a
    relaxed encoding, so it is compared after ``canon``: the host's
    ``a^((P+1)/4) mod P``, with the flag set exactly for squares."""
    rng = np.random.default_rng(75)
    a = [tt.rand_int(rng, P) for _ in range(6)]
    a[:3] = [x * x % P for x in a[:3]]          # three squares
    a[3] = 0
    root, ok = bigint.FP.sqrt(_stack(tt.limb_rows(a)))
    assert root.shape == (*LEAD, 16) and ok.shape == LEAD
    canon = _rows(bigint.FP.canon(root))
    for i, x in enumerate(a):
        r = pow(x, (P + 1) // 4, P)
        assert limbs_to_int(canon[i]) == r
        assert U(ok).reshape(-1)[i] == (r * r % P == x)
