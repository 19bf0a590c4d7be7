"""The port's slice as a whole: ``ecrecover_batch`` and
``BatchVerifier(device="cpu").recover_addresses`` of eges_tpu_torch
against the JAX package's fused recovery pipeline run through its numpy
twins in ``ecrecover_point_fused`` order (the template of
tests/test_pallas_kernels.py:754-871), and against the JAX package's
host model.  ``addrs``, ``pubs`` and ``ok`` must agree byte for byte.

Rows cover both recovery parities, recovery ids 2 and 3 (R.x = r + N),
and every invalid class: r = 0, s >= N, v >= 4, x >= P for v >= 2, and
an r that is no x coordinate; the same rows wider than 65 bytes and as
int32 (fault C4) give the same bytes.  A batch of no rows gives the JAX
package's empty shapes (fault C5)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from eges_tpu.crypto import keccak as jkeccak
from eges_tpu.crypto import secp256k1 as jhost
from eges_tpu.crypto import verifier as RV
from eges_tpu.ops import pallas_kernels as pk
from eges_tpu.ops.bigint import int_to_limbs
from eges_tpu.ops.ec import GLV_BETA
from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto import verifier as V
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import N, P

# a few rows a tensor: one torch thread is as fast, and leaves the cores
# to the other test workers
torch.set_num_threads(1)

N_SIGNED = 8


@pytest.fixture(scope="module")
def rows():
    """(sigs [n, 65] u8, hashes [n, 32] u8, kinds): signed rows with both
    parities, two recovery-id 2/3 rows, one row of each invalid class."""
    return tt.recover_class_rows(np.random.default_rng(2026), N_SIGNED)


def _twin_pipeline(sigs, hashes):
    """The JAX package's fused pipeline, composed from its numpy twins."""
    B = sigs.shape[0]

    def t(a):
        return [a[:, k].copy() for k in range(16)]

    def untq(limbs):
        return np.stack([np.asarray(v) for v in limbs], axis=-1)

    srows = [sigs[:, k].astype(np.uint32) for k in range(65)]
    hrows = [hashes[:, k].astype(np.uint32) for k in range(32)]
    r_l = pk._k_unpack_be(srows, 0, np)
    s_l = pk._k_unpack_be(srows, 32, np)
    v = srows[64]
    z_l = pk._k_unpack_be(hrows, 0, np)
    x, y_sq, ok0 = pk._k_recover_prelude(r_l, s_l, v, np)
    root = pk.pow_mod_np(untq(y_sq), (P + 1) // 4, "p")
    y, y_ok = pk._k_y_fix(t(root), y_sq, v, np)
    r_inv = pk.pow_mod_np(untq(r_l), N - 2, "n")
    u1, u2 = pk._k_u1u2(z_l, s_l, t(r_inv), np)
    dig, neg = pk.glv_digits_np(untq(u1), untq(u2))
    xa, ya = untq(x), untq(y)
    tx, ty, tz = pk.point_table_np(xa, ya)
    ones = np.zeros((B, 16), np.uint32)
    ones[:, 0] = 1
    tx_full = np.concatenate([np.zeros((1, B, 16), np.uint32), xa[None], tx])
    ty_full = np.concatenate([ones[None], ya[None], ty])
    tz_full = np.concatenate([np.zeros((1, B, 16), np.uint32), ones[None],
                              tz])
    zi = pk.pow_mod_np(tz_full.reshape(-1, 16), P - 2, "p")
    zi_l = t(untq(pk._k_cond_sub_p(t(zi), np)))
    zi2 = pk._k_sqr(zi_l, np)
    ax = pk._k_mul(t(tx_full.reshape(-1, 16)), zi2, np)
    ay = pk._k_mul(t(ty_full.reshape(-1, 16)), pk._k_mul(zi_l, zi2, np), np)
    beta = [np.full(16 * B, int(l), np.uint32) for l in int_to_limbs(GLV_BETA)]
    axb = pk._k_mul(ax, beta, np)

    def table_rows(limb_list):
        arr = untq(limb_list).reshape(16, B, 16)
        return np.ascontiguousarray(arr.transpose(0, 2, 1)).reshape(-1, B)

    X, Y, Z = pk.strauss_tab_np(dig, neg, table_rows(ax), table_rows(axb),
                                table_rows(ay))
    zi_raw = pk.pow_mod_np(untq(Z).astype(np.uint32), P - 2, "p")
    _, _, ok, words = pk._k_recover_finish(X, Y, Z, t(zi_raw), ok0 * y_ok,
                                           np)
    digest = np.stack(pk._k_keccak_words(words, np), -1)
    dig_bytes = digest.astype("<u4").view(np.uint8).reshape(B, 32)
    pubs = np.stack(words[:16], -1).astype("<u4").view(np.uint8).reshape(
        B, 64)
    ok = np.asarray(ok, np.uint32)
    return dig_bytes[:, 12:] * ok[:, None].astype(np.uint8), pubs, ok


@pytest.fixture(scope="module")
def twin(rows):
    sigs, hashes, _ = rows
    return _twin_pipeline(sigs, hashes)


@pytest.fixture(scope="module")
def port_batch(rows):
    sigs, hashes, _ = rows
    addrs, pubs, ok = V.ecrecover_batch(torch.from_numpy(sigs),
                                        torch.from_numpy(hashes))
    return addrs.numpy(), pubs.numpy(), ok.numpy()


@pytest.fixture(scope="module")
def port_verifier(rows):
    sigs, hashes, _ = rows
    return V.BatchVerifier(device="cpu").ecrecover(sigs, hashes)


@pytest.mark.parametrize("i,what", [(0, "addrs"), (1, "pubs"), (2, "ok")])
def test_ecrecover_batch_matches_fused_twins(port_batch, twin, i, what):
    np.testing.assert_array_equal(port_batch[i].astype(twin[i].dtype),
                                  twin[i], err_msg=what)


@pytest.mark.parametrize("i,what", [(0, "addrs"), (1, "pubs"), (2, "ok")])
def test_batch_verifier_matches_fused_twins(port_verifier, twin, i, what):
    np.testing.assert_array_equal(port_verifier[i].astype(twin[i].dtype),
                                  twin[i], err_msg=what)


def test_recover_addresses_is_ecrecover_without_pubs(rows, port_verifier):
    sigs, hashes, _ = rows
    verifier = V.BatchVerifier(device="cpu")
    verifier.ecrecover = lambda s, h: port_verifier
    addrs, ok = verifier.recover_addresses(sigs, hashes)
    assert addrs is port_verifier[0] and ok is port_verifier[2]
    assert addrs.dtype == np.uint8 and ok.dtype == bool


def test_matches_reference_host_model(rows, port_verifier):
    sigs, hashes, kinds = rows
    addrs, pubs, ok = port_verifier
    for i, kind in enumerate(kinds):
        try:
            pub = jhost.ecdsa_recover(bytes(hashes[i]), bytes(sigs[i]))
        except ValueError:
            pub = None
        if pub is None:
            assert not ok[i] and not addrs[i].any() and not pubs[i].any(), i
        else:
            assert ok[i], (i, kind)
            assert bytes(pubs[i]) == pub
            assert bytes(addrs[i]) == jkeccak.keccak256(pub)[12:]


@pytest.mark.parametrize("kind", list(tt.INVALID_CLASSES))
def test_each_invalid_class_is_rejected(rows, port_verifier, kind):
    _, _, kinds = rows
    i = kinds.index(kind)
    assert not port_verifier[2][i]


def test_both_parities_and_high_recovery_ids_recover(rows, port_verifier):
    sigs, _, kinds = rows
    ok = port_verifier[2]
    ids = {int(sigs[i, 64]) for i, k in enumerate(kinds)
           if k in ("signed", "high_x") and ok[i]}
    assert ids == {0, 1, 2, 3}


def test_ecrecover_batch_takes_wide_int32_rows(rows, port_batch):
    """C4: the fixture's rows 66 bytes wide (a 0xAB byte after each) as
    int32, hashes as int32, give the ``[n, 65]`` uint8 answer byte for
    byte, and so the host model's (the reference reads r, s and v from
    bytes 0-64 of any integer dtype)."""
    sigs, hashes, _ = rows
    wide = np.concatenate([sigs, np.full((len(sigs), 1), 0xAB, np.uint8)],
                          1).astype(np.int32)
    got = V.ecrecover_batch(torch.from_numpy(wide),
                            torch.from_numpy(hashes.astype(np.int32)))
    for g, w, what in zip(got, port_batch, ("addrs", "pubs", "ok")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    for i in range(len(sigs)):
        want = tt.host_recover(sigs[i], hashes[i])
        assert bool(got[2][i]) == (want is not None)
        if want is not None:
            assert bytes(got[0][i].numpy()) == want[0]


def test_facade_takes_wide_rows_on_its_bucket(rows, port_verifier):
    """C4 through the facade: 16 rows 66 bytes wide (on their bucket: the
    direct path) give the 65-byte answers and the host model's; 15 such
    rows, which would be staged 65 bytes wide, raise ValueError, as the
    reference's staging copy does."""
    sigs, hashes, _ = rows
    idx = np.resize(np.arange(len(sigs)), 16)
    wide = np.concatenate([sigs[idx], np.full((16, 1), 0xAB, np.uint8)], 1)
    verifier = V.BatchVerifier(device="cpu")
    addrs, ok = verifier.recover_addresses(wide, hashes[idx])
    np.testing.assert_array_equal(addrs, port_verifier[0][idx])
    np.testing.assert_array_equal(ok, port_verifier[2][idx])
    for i, j in enumerate(idx):
        want = tt.host_recover(sigs[j], hashes[j])
        assert ok[i] == (want is not None)
    with pytest.raises(ValueError):
        verifier.recover_addresses(wide[:15], hashes[idx][:15])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bool])
def test_ecrecover_batch_refuses_non_integer_bytes(dtype):
    with pytest.raises(TypeError):
        V.ecrecover_batch(torch.zeros(2, 65, dtype=dtype),
                          torch.zeros(2, 32, dtype=torch.uint8))


@pytest.fixture(scope="module")
def ref_empty():
    """The JAX package's ``ecrecover_batch`` of a batch of no rows."""
    import jax.numpy as jnp

    return RV.ecrecover_batch(jnp.zeros((0, 65), jnp.uint8),
                              jnp.zeros((0, 32), jnp.uint8))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_ecrecover_batch_of_no_rows_is_empty(ref_empty, dtype):
    """C5: a ``[0, 65]`` batch gives the JAX package's shapes (uint8
    addresses and keys; ok int32, the port's kept difference) and
    launches nothing; a ``[0, 64]`` batch still raises ValueError."""
    K.reset_launches()
    got = V.ecrecover_batch(torch.zeros(0, 65, dtype=dtype),
                            torch.zeros(0, 32, dtype=dtype))
    assert [tuple(g.shape) for g in got] == [
        tuple(r.shape) for r in ref_empty] == [(0, 20), (0, 64), (0,)]
    assert [g.dtype for g in got] == [torch.uint8, torch.uint8, torch.int32]
    assert sum(K.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        V.ecrecover_batch(torch.zeros(0, 64, dtype=dtype),
                          torch.zeros(0, 32, dtype=dtype))


def test_verifier_facade_plumbing():
    verifier = V.BatchVerifier(device="cpu")
    assert verifier.device_kind == "cpu:cpu"
    assert [verifier._pad(n) for n in (0, 1, 16, 17, 129)] == \
        [16, 16, 16, 32, 256]
    a, p, ok = verifier.ecrecover(np.zeros((0, 65), np.uint8),
                                  np.zeros((0, 32), np.uint8))
    assert a.shape == (0, 20) and p.shape == (0, 64) and ok.shape == (0,)
    seen = []

    def fail(n):
        seen.append(n)
        raise RuntimeError("device lost")

    verifier.failure_hook = fail
    with pytest.raises(RuntimeError):
        verifier.recover_addresses(np.zeros((3, 65), np.uint8),
                                   np.zeros((3, 32), np.uint8))
    assert seen == [3]
    st = verifier._stage_acquire(16)
    verifier._stage_release(16, st)
    assert verifier._stage_acquire(16) is st


@pytest.mark.slow
def test_matches_reference_jax_graph(rows, port_verifier):
    """Against eges_tpu.crypto.verifier.ecrecover_batch itself: the plain
    JAX graph (about a minute to compile on a CPU)."""
    import jax.numpy as jnp

    from eges_tpu.crypto.verifier import ecrecover_batch

    sigs, hashes, _ = rows
    addrs, pubs, ok = jax.jit(ecrecover_batch)(jnp.asarray(sigs),
                                               jnp.asarray(hashes))
    np.testing.assert_array_equal(np.asarray(addrs), port_verifier[0])
    np.testing.assert_array_equal(np.asarray(pubs), port_verifier[1])
    np.testing.assert_array_equal(np.asarray(ok).astype(bool),
                                  port_verifier[2])
