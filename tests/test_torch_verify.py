"""The port's classic ECDSA verify: ``BatchVerifier(device="cpu").verify``
and the ``verify_batch`` it runs, against the JAX package's fused verify
composed from its numpy twins in ``ecdsa_verify_point`` order
(eges_tpu/ops/ec.py:628-647 on the kernels' ``_k_*``/``*_np`` math) and
against the JAX package's host model ``ecdsa_verify``; ``ok`` must agree
row for row (tolerance 0).

Rows: one of each class of ``testing.VERIFY_CLASSES`` among signed rows,
17 in all, so the facade pads them off the bucket (to 32); the run uses
64-byte signatures.  The port's verify runs once: the facade's call of
``verify_batch`` is recorded and both are checked.

Row widths: the same rows cut or widened to 63, 64, 65, 66 and 70 bytes
go through the port's facade and the JAX package's
(``eges_tpu.crypto.verifier.BatchVerifier.verify``), and through both
packages' ``verify_batch``; so does a batch of no rows (fault C5), and
keys in a transposed layout answer as contiguous ones (fault C7)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from eges_tpu.crypto import secp256k1 as jhost
from eges_tpu.crypto import verifier as RV
from eges_tpu.ops import pallas_kernels as pk
from eges_tpu.ops.bigint import int_to_limbs
from eges_tpu.ops.ec import GLV_BETA
from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto import verifier as V
from eges_tpu_torch.ops import ec
from eges_tpu_torch.ops.bigint import N, P

# a few rows a tensor: one torch thread is as fast, and leaves the cores
# to the other test workers
torch.set_num_threads(1)


def _t(a):
    return [a[:, k].copy() for k in range(a.shape[1])]


def _untq(limbs):
    return np.stack([np.asarray(v, np.uint32) for v in limbs], axis=-1)


def _twin_verify(sigs, hashes, pubs):
    """The JAX package's fused classic verify, composed from its numpy
    twins: ``ok [B]`` uint32."""
    B = sigs.shape[0]
    srows = [sigs[:, k].astype(np.uint32) for k in range(64)]
    hrows = [hashes[:, k].astype(np.uint32) for k in range(32)]
    prows = [pubs[:, k].astype(np.uint32) for k in range(64)]
    r = pk._k_unpack_be(srows, 0, np)
    s = pk._k_unpack_be(srows, 32, np)
    z = pk._k_unpack_be(hrows, 0, np)
    qx = pk._k_unpack_be(prows, 0, np)
    qy = pk._k_unpack_be(prows, 32, np)
    half_n1 = [int(v) for v in int_to_limbs(N // 2 + 1)]
    r_ok = ((1 - pk._k_is_zero(r, np))
            * pk._k_sub_const_chain(r, pk._N_LIMBS_C, np)[1])
    s_ok = (1 - pk._k_is_zero(s, np)) * pk._k_sub_const_chain(s, half_n1,
                                                              np)[1]
    # on_curve: fp_mul x3, fp_add, fp_canon x2
    seven = [np.full(B, 7 if k == 0 else 0, np.uint32) for k in range(16)]
    lhs = pk._k_mul(qy, qy, np)
    rhs = pk._k_add(pk._k_mul(pk._k_mul(qx, qx, np), qx, np), seven, np)
    q_ok = np.all(_untq(pk._k_cond_sub_p(lhs, np))
                  == _untq(pk._k_cond_sub_p(rhs, np)), -1)
    # s^-1 (pow mod N), z mod N (fn_red17), u1, u2 (fn_mul)
    s_inv = _t(pk.pow_mod_np(_untq(s), N - 2, "n"))
    zero = np.zeros(B, np.uint32)
    u1 = pk._k_fn_mul(pk._k_fn_red_cols(z + [zero], np), s_inv, np)
    u2 = pk._k_fn_mul(r, s_inv, np)
    # strauss_gR's fused branch: GLV digits, the affine R tables, ladder
    dig, neg = pk.glv_digits_np(_untq(u1), _untq(u2))
    xa, ya = _untq(qx), _untq(qy)
    tx, ty, tz = pk.point_table_np(xa, ya)
    ones = np.zeros((B, 16), np.uint32)
    ones[:, 0] = 1
    zeros = np.zeros((1, B, 16), np.uint32)
    tx_full = np.concatenate([zeros, xa[None], tx]).reshape(-1, 16)
    ty_full = np.concatenate([ones[None], ya[None], ty]).reshape(-1, 16)
    tz_full = np.concatenate([zeros, ones[None], tz]).reshape(-1, 16)
    zi = _t(_untq(pk._k_cond_sub_p(_t(pk.pow_mod_np(tz_full, P - 2, "p")),
                                   np)))
    zi2 = pk._k_sqr(zi, np)
    ax = pk._k_mul(_t(tx_full), zi2, np)
    ay = pk._k_mul(_t(ty_full), pk._k_mul(zi, zi2, np), np)
    beta = [np.full(16 * B, int(v), np.uint32)
            for v in int_to_limbs(GLV_BETA)]
    axb = pk._k_mul(ax, beta, np)

    def table_rows(limbs):
        arr = _untq(limbs).reshape(16, B, 16)
        return np.ascontiguousarray(arr.transpose(0, 2, 1)).reshape(-1, B)

    X, _, Z = pk.strauss_tab_np(dig, neg, table_rows(ax), table_rows(axb),
                                table_rows(ay))
    # to_affine's x: Z^-1 (pow mod P, canon), x = canon(X * Z^-2)
    Xl, Zl = [np.asarray(v, np.uint32) for v in X], [np.asarray(v, np.uint32)
                                                      for v in Z]
    inf = np.asarray(pk._k_is_zero(Zl, np), bool) | np.all(
        _untq(Zl) == np.asarray(pk._P_LIMBS, np.uint32), -1)
    zi = pk._k_cond_sub_p(_t(pk.pow_mod_np(_untq(Zl), P - 2, "p")), np)
    px = _untq(pk._k_cond_sub_p(pk._k_mul(Xl, pk._k_sqr(zi, np), np), np))
    px = np.where(inf[:, None], 0, px).astype(np.uint32)
    px_mod = pk._k_fn_red_cols(_t(px) + [zero], np)
    eq = np.all(_untq(px_mod) == _untq(r), -1)
    return (r_ok * s_ok * q_ok * ~inf * eq).astype(np.uint32)


def _ref(t):
    return t.numpy().astype(np.uint32)


@pytest.fixture(scope="module")
def rows():
    return tt.verify_rows(np.random.default_rng(2027), 3)


@pytest.fixture(scope="module")
def port_run(rows):
    """One ``BatchVerifier(device="cpu").verify`` of the rows with 64-byte
    signatures, recording the ``verify_batch`` call it makes: (facade
    ``ok``, staged ``(sigs, hashes, pubs)`` as numpy, ``verify_batch``'s
    ``ok``)."""
    sigs, hashes, pubs, _ = rows
    seen = []
    real = V.verify_batch

    def record(*args):
        out = real(*args)
        seen.append(([a.numpy().copy() for a in args], out.numpy()))
        return out

    V.verify_batch = record
    try:
        ok = V.BatchVerifier(device="cpu").verify(
            np.ascontiguousarray(sigs[:, :64]), hashes, pubs)
    finally:
        V.verify_batch = real
    (staged, batch_ok), = seen
    return ok, staged, batch_ok


@pytest.fixture(scope="module")
def twin(rows):
    sigs, hashes, pubs, _ = rows
    return _twin_verify(np.ascontiguousarray(sigs[:, :64]), hashes, pubs)


@pytest.fixture(scope="module")
def host(rows):
    sigs, hashes, pubs, _ = rows
    return np.array([jhost.ecdsa_verify(bytes(h), bytes(s[:64]), bytes(p))
                     for s, h, p in zip(sigs, hashes, pubs)])


def test_facade_stages_off_the_bucket(rows, port_run):
    sigs, hashes, pubs, _ = rows
    ok, (ss, sh, sp), batch_ok = port_run
    n = len(sigs)
    assert ok.shape == (n,) and ok.dtype == bool
    assert ss.shape == (32, 65) and batch_ok.shape == (32,)
    np.testing.assert_array_equal(ss[:n, :64], sigs[:, :64])
    np.testing.assert_array_equal(sh[:n], hashes)
    np.testing.assert_array_equal(sp[:n], pubs)
    # the recovery byte of a 64-byte signature and every padded row are 0
    assert not ss[:, 64].any() and not ss[n:].any()
    assert not sh[n:].any() and not sp[n:].any()


def test_verify_batch_matches_fused_twins(port_run, twin):
    """The staged rows through ``verify_batch``; the padded rows (all
    zero: r = 0) are rejected."""
    _, _, batch_ok = port_run
    n = len(twin)
    np.testing.assert_array_equal(batch_ok[:n].astype(np.uint32), twin)
    assert not batch_ok[n:].any()


def test_batch_verifier_matches_fused_twins(port_run, twin):
    np.testing.assert_array_equal(port_run[0], twin.astype(bool))


def test_matches_reference_host_model(port_run, host):
    np.testing.assert_array_equal(port_run[0], host)


@pytest.mark.parametrize("kind", tt.VERIFY_CLASSES)
def test_each_row_class(rows, port_run, host, kind):
    """Every class gives the answer it is built for, on the port and in
    the reference's host model (no row where the two disagree)."""
    kinds = rows[3]
    i = kinds.index(kind)
    want = kind in tt.VERIFY_VALID
    assert host[i] == want
    assert port_run[0][i] == want
    assert tt.host_verify(*(a[i] for a in rows[:3])) == want


def test_verify_batch_reads_64_and_65_byte_signatures(rows, monkeypatch):
    sigs, hashes, pubs, _ = rows
    seen = []
    monkeypatch.setattr(ec, "ecdsa_verify_point",
                        lambda *a: seen.append(a) or torch.zeros(len(a[0])))
    for width in (64, 65):
        V.verify_batch(torch.from_numpy(np.ascontiguousarray(
            sigs[:, :width])), torch.from_numpy(hashes),
            torch.from_numpy(pubs))
    assert len(seen) == 2
    for a, b in zip(*seen):
        assert torch.equal(a, b)
    z, r, s, qx, qy = seen[0]
    np.testing.assert_array_equal(
        _ref(r), np.stack([int_to_limbs(int.from_bytes(bytes(x[:32]),
                                                           "big"))
                               for x in sigs]))
    np.testing.assert_array_equal(
        _ref(qy), np.stack([int_to_limbs(int.from_bytes(bytes(p[32:]),
                                                            "big"))
                                for p in pubs]))
    with pytest.raises(ValueError):
        V.verify_batch(torch.zeros(2, 63, dtype=torch.uint8),
                       torch.zeros(2, 32, dtype=torch.uint8),
                       torch.zeros(2, 64, dtype=torch.uint8))


def test_verify_facade_plumbing(monkeypatch):
    verifier = V.BatchVerifier(device="cpu")
    assert verifier.verify(np.zeros((0, 65), np.uint8),
                           np.zeros((0, 32), np.uint8),
                           np.zeros((0, 64), np.uint8)).shape == (0,)
    # rows of any width are staged 65 bytes wide, as the reference does:
    # two zero rows (r = 0) are answered, not refused
    monkeypatch.setattr(V, "verify_batch", lambda s, h, q: torch.zeros(
        len(s), dtype=torch.int32))
    assert not verifier.verify(np.zeros((2, 63), np.uint8),
                               np.zeros((2, 32), np.uint8),
                               np.zeros((2, 64), np.uint8)).any()
    monkeypatch.undo()
    seen = []

    def fail(n):
        seen.append(n)
        raise RuntimeError("device lost")

    verifier.failure_hook = fail
    with pytest.raises(RuntimeError):
        verifier.verify(np.zeros((3, 65), np.uint8),
                        np.zeros((3, 32), np.uint8),
                        np.zeros((3, 64), np.uint8))
    assert seen == [3]
    verifier.failure_hook = None
    # a pool buffer that held a 16-row batch must not leak into a 3-row
    # one: the padded rows of every staging buffer are zeroed
    staged = []
    monkeypatch.setattr(V, "verify_batch", lambda s, h, q: staged.append(
        (s.clone(), h.clone(), q.clone())) or torch.ones(len(s),
                                                        dtype=torch.int32))
    full = np.full((16, 65), 7, np.uint8)
    verifier.verify(full, full[:, :32], np.full((16, 64), 9, np.uint8))
    ok = verifier.verify(full[:3], full[:3, :32],
                         np.full((3, 64), 9, np.uint8))
    assert ok.shape == (3,) and ok.all()
    s, h, q = staged[-1]
    assert not s[3:].any() and not h[3:].any() and not q[3:].any()
    st = verifier._stage_acquire(16)
    assert "pubs" in st                       # the pooled verify buffers
    verifier._stage_release(16, st)


def test_verify_batch_takes_keys_in_any_layout(rows, twin, host):
    """C7: keys given as a transposed view (the layout ``ecrecover_batch``
    returns its ``pubs`` in) answer as the JAX package's fused twins and
    its host model do, on a row that verifies and one that does not; the
    port raised ValueError on them."""
    sigs, hashes, pubs, kinds = rows
    idx = [kinds.index(next(k for k in kinds if k in tt.VERIFY_VALID)),
           kinds.index(next(k for k in kinds if k not in tt.VERIFY_VALID))]
    view = torch.from_numpy(np.ascontiguousarray(pubs[idx].T)).T
    assert not view.is_contiguous()
    got = V.verify_batch(torch.from_numpy(sigs[idx]),
                         torch.from_numpy(hashes[idx]), view).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), twin[idx])
    np.testing.assert_array_equal(got.astype(bool), host[idx])
    assert host[idx].tolist() == [True, False]


@pytest.fixture(scope="module")
def ref_empty():
    """The JAX package's ``verify_batch`` of a batch of no rows."""
    import jax.numpy as jnp

    return RV.verify_batch(jnp.zeros((0, 65), jnp.uint8),
                           jnp.zeros((0, 32), jnp.uint8),
                           jnp.zeros((0, 64), jnp.uint8))


@pytest.mark.parametrize("width", [64, 65])
def test_verify_batch_of_no_rows_is_empty(ref_empty, width):
    """C5: a ``[0, 64]`` or ``[0, 65]`` batch gives the JAX package's
    shape (ok int32, the port's kept difference) and launches nothing; a
    ``[0, 63]`` batch still raises ValueError."""
    from eges_tpu_torch.ops import kernels as K

    K.reset_launches()
    got = V.verify_batch(torch.zeros(0, width, dtype=torch.uint8),
                         torch.zeros(0, 32, dtype=torch.uint8),
                         torch.zeros(0, 64, dtype=torch.uint8))
    assert tuple(got.shape) == tuple(ref_empty.shape) == (0,)
    assert got.dtype == torch.int32
    assert sum(K.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        V.verify_batch(torch.zeros(0, 63, dtype=torch.uint8),
                       torch.zeros(0, 32, dtype=torch.uint8),
                       torch.zeros(0, 64, dtype=torch.uint8))


# -- row widths: the port against the reference --------------------------

WIDTHS = (63, 64, 65, 66, 70)


def _at_width(sigs, width):
    """The rows cut to ``width`` bytes, or widened with trailing 0xAB."""
    if width <= 65:
        return np.ascontiguousarray(sigs[:, :width])
    return np.concatenate(
        [sigs, np.full((len(sigs), width - 65), 0xAB, np.uint8)], 1)


@pytest.fixture(scope="module")
def width_runs(rows, port_run):
    """Each width of the rows through the port's ``BatchVerifier(device=
    "cpu").verify`` and the reference's, both with their device batch
    recorded: ``{width: (port staged (sigs, hashes, pubs), port ok,
    reference staged (sigs, hashes, pubs), reference ok)}``.

    The reference's batch is answered by its host model
    (``eges_tpu.crypto.secp256k1.ecdsa_verify`` of r || s), which its
    fused verify agrees with on every class (the tests above), so the
    whole graph is not compiled here.  The port's facade answers
    ``verify_batch(staged)[:n]``: the staged rows are answered by one
    real ``verify_batch`` of the distinct rows that ``port_run`` did
    not already answer."""
    sigs, hashes, pubs, _ = rows
    n = len(sigs)

    ref = RV.BatchVerifier()
    ref_seen = []

    def ref_batch(ds, dh, dq):
        s, h, q = (np.asarray(a) for a in (ds, dh, dq))
        ref_seen.append((s.copy(), h.copy(), q.copy()))
        return jax.numpy.asarray([
            jhost.ecdsa_verify(bytes(hh), bytes(ss[:64]), bytes(qq))
            for ss, hh, qq in zip(s, h, q)], jax.numpy.uint32)

    ref._verify = ref_batch
    port_seen = []
    real = V.verify_batch
    V.verify_batch = lambda *a: port_seen.append(
        tuple(t.numpy().copy() for t in a)) or torch.zeros(
        len(a[0]), dtype=torch.int32)
    try:
        ref_ok = {w: ref.verify(_at_width(sigs, w), hashes, pubs)
                  for w in WIDTHS}
        for w in WIDTHS:
            V.BatchVerifier(device="cpu").verify(_at_width(sigs, w),
                                                 hashes, pubs)
    finally:
        V.verify_batch = real

    def key(s, h, q):
        return s.tobytes() + h.tobytes() + q.tobytes()

    _, (ss, sh, sp), batch_ok = port_run
    answer = {key(*r): bool(o) for *r, o in zip(ss, sh, sp, batch_ok)}
    todo = {key(*r): r for staged in port_seen for r in zip(*staged)
            if key(*r) not in answer}
    if todo:
        rs = list(todo.values())
        ok = real(*(torch.from_numpy(np.stack(col)) for col in zip(*rs)))
        answer.update({key(*r): bool(o) for r, o in zip(rs, ok.numpy())})
    port_ok = {w: np.array([answer[key(*r)] for r in zip(*staged)][:n])
               for w, staged in zip(WIDTHS, port_seen)}
    return {w: (port_seen[i], port_ok[w], ref_seen[i], ref_ok[w])
            for i, w in enumerate(WIDTHS)}


@pytest.mark.parametrize("width", WIDTHS)
def test_verify_rows_of_any_width_stage_as_the_reference(width_runs, width):
    """Wider rows are cut to 65 bytes, narrower ones zero-padded to 65,
    byte for byte as the reference stages them (verifier.py:628-629)."""
    port, _, ref, _ = width_runs[width]
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("width", WIDTHS)
def test_verify_rows_of_any_width_answer_as_the_reference(rows, width_runs,
                                                          width):
    """Row for row, on every class of ``testing.VERIFY_CLASSES``; from 64
    bytes up each class gives the answer it is built for (one valid row
    with one trailing byte, ``[1, 66]``, verifies)."""
    _, port_ok, _, ref_ok = width_runs[width]
    np.testing.assert_array_equal(port_ok, ref_ok)
    if width >= 64:
        want = np.array([k in tt.VERIFY_VALID for k in rows[3]])
        np.testing.assert_array_equal(port_ok, want)


def test_verify_batch_reads_bytes_0_to_64_of_any_row(rows, monkeypatch):
    """Both packages' ``verify_batch`` hand the same limbs to
    ``ecdsa_verify_point`` from rows of 64, 65, 66 and 70 bytes.  Rows
    of 63 bytes raise in both: ``ValueError`` in the port, where the
    reference fails to reshape them (``TypeError``), a difference kept
    on purpose (ROADMAP.md, C1)."""
    sigs, hashes, pubs, _ = rows
    port, ref = [], []
    monkeypatch.setattr(ec, "ecdsa_verify_point", lambda *a: port.append(
        [_ref(t) for t in a]) or torch.zeros(len(a[0]), dtype=torch.int32))
    monkeypatch.setattr(RV.ec, "ecdsa_verify_point", lambda *a: ref.append(
        [np.asarray(t) for t in a]) or jax.numpy.zeros(len(a[0])))
    for width in (64, 65, 66, 70):
        s = _at_width(sigs, width)
        V.verify_batch(torch.from_numpy(s), torch.from_numpy(hashes),
                       torch.from_numpy(pubs))
        RV.verify_batch(jax.numpy.asarray(s), jax.numpy.asarray(hashes),
                        jax.numpy.asarray(pubs))
    for got in port + ref:
        for a, b in zip(got, ref[0]):
            np.testing.assert_array_equal(a, b)
    s = _at_width(sigs, 63)
    with pytest.raises(ValueError):
        V.verify_batch(torch.from_numpy(s), torch.from_numpy(hashes),
                       torch.from_numpy(pubs))
    with pytest.raises(TypeError):
        RV.verify_batch(jax.numpy.asarray(s), jax.numpy.asarray(hashes),
                        jax.numpy.asarray(pubs))
