"""The port's un-fused path on the CPU: ``ecrecover_batch`` on a stacked
``[2, 5, 65]`` window and on one ``[65]`` row, and ``verify_batch`` on a
stacked ``[3, 5, ...]`` window, against the host model and against the
port's own fused path on the same rows flattened to 2-D; ``addrs``,
``pubs`` and ``ok`` must agree byte for byte.  The kernel launches of
each run (counted at the plain versions, which the wrappers call where
the card would launch) are pinned to ``testing.UNFUSED_*_LAUNCHES``.

Rows: every recovery class (signed rows of both parities, recovery ids 2
and 3, and one of each of ``testing.INVALID_CLASSES``: 10 rows) and
every classic-verify class of ``testing.VERIFY_CLASSES`` (15 rows).  An
un-fused batch is some 8,400 plain kernel calls whatever its rows, so
each path runs once, in a module fixture, at the rows its classes need.
Under ``slow``: the same windows through the JAX package's own
``ecrecover_batch`` and ``verify_batch`` (about a minute to compile
each on a CPU)."""

import contextlib

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto import verifier as V
from eges_tpu_torch.ops import kernels as K

# a few rows a tensor: one torch thread is as fast, and leaves the cores
# to the other test workers
torch.set_num_threads(1)

REC_SHAPE = (2, 5)
VER_SHAPE = (3, 5)


@contextlib.contextmanager
def _counting():
    """Count the calls of every kernel's plain version: on the CPU each
    stands where the card would launch the kernel once."""
    counts = dict.fromkeys(K.KERNELS, 0)
    real = {name: getattr(K, name + "_plain") for name in K.KERNELS}

    def spy(name):
        def call(*args, **kw):
            counts[name] += 1
            return real[name](*args, **kw)
        return call

    for name in K.KERNELS:
        setattr(K, name + "_plain", spy(name))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(K, name + "_plain", fn)


def _np(outs):
    return tuple(o.numpy() for o in outs)


@pytest.fixture(scope="module")
def rec_rows():
    rows = tt.recover_class_rows(np.random.default_rng(2035))
    assert len(rows[0]) == REC_SHAPE[0] * REC_SHAPE[1]
    return rows


@pytest.fixture(scope="module")
def stacked_recover(rec_rows):
    sigs, hashes, _ = rec_rows
    with _counting() as counts:
        out = V.ecrecover_batch(
            torch.from_numpy(sigs.reshape(*REC_SHAPE, 65)),
            torch.from_numpy(hashes.reshape(*REC_SHAPE, 32)))
    return _np(out), {k: v for k, v in counts.items() if v}


@pytest.fixture(scope="module")
def single_recover(rec_rows):
    """One ``[65]`` row: the recovery-id 3 row (x = r + N, odd y)."""
    sigs, hashes, kinds = rec_rows
    i = next(i for i, k in enumerate(kinds)
             if k == "high_x" and sigs[i, 64] == 3)
    with _counting() as counts:
        out = V.ecrecover_batch(torch.from_numpy(sigs[i]),
                                torch.from_numpy(hashes[i]))
    return i, _np(out), {k: v for k, v in counts.items() if v}


@pytest.fixture(scope="module")
def fused_recover(rec_rows):
    sigs, hashes, _ = rec_rows
    return _np(V.ecrecover_batch(torch.from_numpy(sigs),
                                 torch.from_numpy(hashes)))


def test_stacked_recover_shapes(stacked_recover):
    (addrs, pubs, ok), _ = stacked_recover
    assert addrs.shape == (*REC_SHAPE, 20) and addrs.dtype == np.uint8
    assert pubs.shape == (*REC_SHAPE, 64) and pubs.dtype == np.uint8
    assert ok.shape == REC_SHAPE and ok.dtype == np.int32


@pytest.mark.parametrize("kind", ["signed", "high_x",
                                  *tt.INVALID_CLASSES])
def test_stacked_recover_matches_host_model(rec_rows, stacked_recover,
                                            kind):
    sigs, hashes, kinds = rec_rows
    addrs, pubs, ok = (a.reshape(len(sigs), -1) for a in stacked_recover[0])
    rows = [i for i, k in enumerate(kinds) if k == kind]
    assert rows
    for i in rows:
        want = tt.host_recover(sigs[i], hashes[i])
        assert (want is None) == (kind in tt.INVALID_CLASSES)
        if want is None:
            assert ok[i, 0] == 0 and not addrs[i].any() and not pubs[i].any()
        else:
            assert ok[i, 0] == 1, (kind, i)
            assert (bytes(addrs[i]), bytes(pubs[i])) == want


def test_stacked_recover_covers_every_recovery_id(rec_rows,
                                                  stacked_recover):
    sigs, _, _ = rec_rows
    ok = stacked_recover[0][2].reshape(-1)
    assert {int(sigs[i, 64]) for i in np.flatnonzero(ok)} == {0, 1, 2, 3}


@pytest.mark.parametrize("i,what", [(0, "addrs"), (1, "pubs"), (2, "ok")])
def test_stacked_recover_matches_fused_path(rec_rows, stacked_recover,
                                            fused_recover, i, what):
    n = len(rec_rows[0])
    got = stacked_recover[0][i]
    np.testing.assert_array_equal(got.reshape(n, *got.shape[2:]),
                                  fused_recover[i], err_msg=what)


def test_stacked_recover_launches(stacked_recover):
    assert stacked_recover[1] == tt.UNFUSED_RECOVER_LAUNCHES


def test_single_row_recover(rec_rows, single_recover, fused_recover):
    sigs, hashes, _ = rec_rows
    i, (addr, pub, ok), launches = single_recover
    assert addr.shape == (20,) and pub.shape == (64,) and ok.shape == ()
    assert ok == 1
    assert (bytes(addr), bytes(pub)) == tt.host_recover(sigs[i], hashes[i])
    for got, fused in zip((addr, pub, ok), fused_recover):
        np.testing.assert_array_equal(got, fused[i])
    assert launches == tt.UNFUSED_RECOVER_LAUNCHES


# ---------------------------------------------------------------------------
# classic verify
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ver_rows():
    sigs, hashes, pubs, kinds = tt.verify_rows(np.random.default_rng(2031),
                                               1)
    assert len(kinds) == VER_SHAPE[0] * VER_SHAPE[1]
    return sigs, hashes, pubs, kinds


@pytest.fixture(scope="module")
def stacked_verify(ver_rows):
    with _counting() as counts:
        ok = V.verify_batch(*(torch.from_numpy(a.reshape(*VER_SHAPE, -1))
                              for a in ver_rows[:3]))
    return ok.numpy(), {k: v for k, v in counts.items() if v}


def test_stacked_verify_matches_host_model(ver_rows, stacked_verify):
    sigs, hashes, pubs, kinds = ver_rows
    ok = stacked_verify[0]
    assert ok.shape == VER_SHAPE and ok.dtype == np.int32
    for i, (kind, got) in enumerate(zip(kinds, ok.reshape(-1))):
        want = tt.host_verify(sigs[i], hashes[i], pubs[i])
        assert want == (kind in tt.VERIFY_VALID)
        assert bool(got) == want, kind


def test_stacked_verify_matches_fused_path(ver_rows, stacked_verify):
    fused = V.verify_batch(*(torch.from_numpy(a) for a in ver_rows[:3]))
    np.testing.assert_array_equal(stacked_verify[0].reshape(-1),
                                  fused.numpy())


def test_stacked_verify_launches(stacked_verify):
    assert stacked_verify[1] == tt.UNFUSED_VERIFY_LAUNCHES


def test_entry_points_check_shapes():
    z = torch.zeros
    u8 = torch.uint8
    for sigs, hashes in ((z(2, 3, 64, dtype=u8), z(2, 3, 32, dtype=u8)),
                         (z(2, 3, 65, dtype=u8), z(2, 4, 32, dtype=u8)),
                         (z(65, dtype=u8), z(2, 32, dtype=u8)),
                         (z((), dtype=u8), z(32, dtype=u8))):
        with pytest.raises(ValueError):
            V.ecrecover_batch(sigs, hashes)
    with pytest.raises(ValueError):
        V.verify_batch(z(2, 3, 63, dtype=u8), z(2, 3, 32, dtype=u8),
                       z(2, 3, 64, dtype=u8))
    with pytest.raises(ValueError):
        V.verify_batch(z(2, 3, 64, dtype=u8), z(2, 3, 32, dtype=u8),
                       z(2, 64, dtype=u8))


@pytest.mark.slow
def test_stacked_recover_matches_reference_jax(rec_rows, stacked_recover):
    """Against ``eges_tpu.crypto.verifier.ecrecover_batch`` on the same
    stacked window (its un-fused XLA path; about a minute to compile)."""
    import jax.numpy as jnp

    from eges_tpu.crypto.verifier import ecrecover_batch

    sigs, hashes, _ = rec_rows
    want = jax.jit(ecrecover_batch)(jnp.asarray(sigs.reshape(*REC_SHAPE, 65)),
                                    jnp.asarray(hashes.reshape(*REC_SHAPE,
                                                               32)))
    for got, w in zip(stacked_recover[0], want):
        np.testing.assert_array_equal(got, np.asarray(w).astype(got.dtype))


@pytest.mark.slow
def test_stacked_verify_matches_reference_jax(ver_rows, stacked_verify):
    import jax.numpy as jnp

    from eges_tpu.crypto.verifier import verify_batch

    want = jax.jit(verify_batch)(*(jnp.asarray(a.reshape(*VER_SHAPE, -1))
                                   for a in ver_rows[:3]))
    np.testing.assert_array_equal(stacked_verify[0],
                                  np.asarray(want).astype(np.int32))
