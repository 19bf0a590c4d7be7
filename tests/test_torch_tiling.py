"""The reference's TPU-tiling configuration in eges_tpu_torch
(``EGES_TPU_LANE_BLOCK=1024 EGES_TPU_ROWS8=1 EGES_TPU_KECCAK_GRID=1``):
its parsing against the reference's, the rows8 layout against the JAX
package's re-lay helpers, the plain versions of the three tiling kernels
(behind ``pow_mod_pallas``, ``strauss_tab`` and ``keccak_rows_pallas``
under the configuration) against the JAX package's numpy twins and its
round kernel in interpret mode, bit for bit (tolerance 0: the arithmetic
is integer), and recovery, verify and keccak through the entry points
under the configuration against the host model and the default
configuration, with the launches of each path.

The rows8 Pallas kernels do not run here: compiling them in interpret
mode takes more than 15 minutes on one core (pallas_kernels.py:764), so
the port's rows8 functions are held against the layout-free twins
``pow_mod_np`` and ``strauss_tab_np``, whose arithmetic they share."""

import contextlib
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eges_tpu.crypto.keccak import keccak256
from eges_tpu.ops import pallas_kernels as pk
from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto.verifier import BatchVerifier
from eges_tpu_torch.ops import field, kernels as K
from eges_tpu_torch.ops.bigint import N, P
from eges_tpu_torch.ops.keccak import keccak256_fixed

# a few rows a tensor: one torch thread is as fast, and leaves the cores
# to the other test workers
torch.set_num_threads(1)

R = K.from_reference
U = K.to_reference


@pytest.fixture
def tiling():
    with tt.tiling_config():
        yield


@contextlib.contextmanager
def _counting():
    """Count the calls of every kernel's plain version: on the CPU each
    stands where the card would launch that kernel once."""
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


def _launched(counts):
    return {k: v for k, v in counts.items() if v}


# ---------------------------------------------------------------------------
# the configuration against the reference's
# ---------------------------------------------------------------------------

def _reference_lane_block(monkeypatch, value: str):
    """A fresh copy of the reference module imported with the variable
    set (it reads it once, at import): its LANE_BLOCK or its error."""
    monkeypatch.setenv("EGES_TPU_LANE_BLOCK", value)
    spec = importlib.util.spec_from_file_location("_pk_fresh", pk.__file__)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except ValueError as exc:
        return str(exc), None
    return mod.LANE_BLOCK, mod


@pytest.mark.parametrize("value", ["256", "1024", "384", "100", "0", "-128"])
def test_lane_block_parses_as_the_reference(monkeypatch, value):
    want, ref = _reference_lane_block(monkeypatch, value)
    if ref is None:
        with pytest.raises(ValueError) as exc:
            K.lane_block()
        assert str(exc.value) == want
        return
    assert K.lane_block() == want
    assert K.bpad(1) == want and K.bpad(want + 1) == 2 * want
    for rows8 in ("1", "0", ""):
        monkeypatch.setenv("EGES_TPU_ROWS8", rows8)
        try:
            expected = ref.rows8_enabled()
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                K.rows8_enabled()
            assert str(got.value) == str(exc)
        else:
            assert K.rows8_enabled() is expected


@pytest.mark.parametrize("value", ["1", "0", "", "yes"])
def test_keccak_grid_switch_as_the_reference(monkeypatch, value):
    monkeypatch.setenv("EGES_TPU_KECCAK_GRID", value)
    assert K.keccak_grid_enabled() is pk.keccak_grid_enabled()


def test_tiling_config_sets_and_restores(monkeypatch):
    monkeypatch.setenv("EGES_TPU_LANE_BLOCK", "512")
    monkeypatch.delenv("EGES_TPU_ROWS8", raising=False)
    with tt.tiling_config():
        assert K.lane_block() == 1024 and K.rows8_enabled()
        assert K.keccak_grid_enabled()
        with tt.tiling_config(enabled=False):
            assert K.lane_block() == 256 and not K.rows8_enabled()
    assert K.lane_block() == 512 and not K.rows8_enabled()


# ---------------------------------------------------------------------------
# the rows8 layout
# ---------------------------------------------------------------------------

def test_rows8_layout_matches_reference():
    B = 2048
    a = np.arange(B * 16, dtype=np.uint32).reshape(B, 16) * 2654435761
    t = K.to_rows8(R(a))
    want = np.asarray(pk._to_rows8(jnp.asarray(a)))
    np.testing.assert_array_equal(U(t), want)
    for rows in (B, 1500):
        np.testing.assert_array_equal(
            U(K.from_rows8(t, rows)),
            np.asarray(pk._from_rows8(jnp.asarray(want), rows)))
    padded, rows = K.pad_rows8(R(a[:1030]))
    assert rows == 1030 and padded.shape == (2048, 16)
    assert not U(padded)[1030:].any()


def test_strauss_relays_index_contract():
    """Column b = blk*1024 + s*128 + l of row r sits at [blk, r*8 + s, l];
    digit t of window w at [blk, w, t*8 + s, l]."""
    wide, W = 2048, 3
    rng = np.random.default_rng(30)
    rows = rng.integers(0, 1 << 32, (256, wide), dtype=np.uint64).astype(
        np.uint32)
    dig = rng.integers(0, 16, (W, 8, wide)).astype(np.uint32)
    laid, digl = U(K.lay_rows8(R(rows))), U(K.lay_digits_rows8(R(dig)))
    assert laid.shape == (2, 2048, 128) and digl.shape == (2, W, 64, 128)
    for blk, s, l, r in ((0, 0, 0, 0), (0, 3, 17, 5), (1, 7, 127, 255),
                         (1, 2, 64, 128)):
        b = blk * 1024 + s * 128 + l
        assert laid[blk, r * 8 + s, l] == rows[r, b]
        assert digl[blk, r % W, (r % 8) * 8 + s, l] == dig[r % W, r % 8, b]
    np.testing.assert_array_equal(U(K.unlay_rows8(R(laid))), rows)


# ---------------------------------------------------------------------------
# the three kernels' plain versions against the twins
# ---------------------------------------------------------------------------

def _edge_rows(rng, n, bound):
    """n rows: 0, 1, P - 1, P and all-0xFFFF (those below ``bound``),
    then random values below ``bound``."""
    edges = [0, 1, P - 1, P, (1 << 256) - 1]
    vals = [v for v in edges if v < bound]
    vals += [tt.rand_int(rng, bound) for _ in range(n - len(vals))]
    return tt.limb_rows(vals)


@pytest.mark.parametrize("e,mod", [((P + 1) // 4, "p"), (N - 2, "n")])
def test_pow_mod_rows8_matches_numpy_twin(tiling, e, mod):
    """At a ragged 1030 rows (two tiles), raw: the relaxed mod-P encoding
    is compared as it is."""
    a = _edge_rows(np.random.default_rng(31), 1030,
                   N if mod == "n" else 1 << 256)
    with _counting() as counts:
        got = K.pow_mod_pallas(R(a), e, mod)
    assert _launched(counts) == {"pow_mod_rows8": 1}
    np.testing.assert_array_equal(U(got), pk.pow_mod_np(a, e, mod))


def test_strauss_tab_rows8_matches_numpy_twin(tiling):
    """Batch 1000 of one tile; two windows of random digits (zero digits
    among them) and signs, tables with entry 0 zero.  Each window repeats
    the same arithmetic; the whole ladder runs in the path tests below."""
    rng = np.random.default_rng(32)
    batch, wide, W = 1000, K.bpad(1000), 2
    assert wide == 1024
    dig = np.zeros((W, 8, wide), np.uint32)
    dig[:, :4, :batch] = rng.integers(0, 16, (W, 4, batch))
    neg = np.zeros((8, wide), np.uint32)
    neg[:4, :batch] = rng.integers(0, 2, (4, batch))
    tabs = [rng.integers(0, 1 << 16, (256, wide)).astype(np.uint32)
            for _ in range(3)]
    for t in tabs:
        t[:16] = 0
        t[:, batch:] = 0
    with _counting() as counts:
        got = K.strauss_tab(R(dig), R(neg), *map(R, tabs), batch)
    assert _launched(counts) == {"strauss_tab_rows8": 1}
    want = pk.strauss_tab_np(dig, neg, *tabs)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(
            U(g), np.stack([np.asarray(v) for v in w], -1)[:batch])


def test_rows8_wrappers_check_their_inputs(tiling):
    a = R(_edge_rows(np.random.default_rng(33), 4, 1 << 256))
    with pytest.raises(ValueError):
        K.pow_mod_pallas(a, 3, "q")
    with pytest.raises(ValueError):
        K.pow_rows8_tiles(K.to_rows8(K.pad_rows8(a)[0]), 3, "p", 1025)
    dig = torch.zeros(2, 8, 256, dtype=torch.int32)
    neg = torch.zeros(8, 256, dtype=torch.int32)
    tab = torch.zeros(256, 256, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 1024"):
        K.strauss_tab(dig, neg, tab, tab, tab, 10)


def _blocks(msgs):
    """One padded keccak block per message: ``[34, len]`` words."""
    words = np.zeros((34, len(msgs)), np.uint32)
    for i, m in enumerate(msgs):
        buf = bytearray(136)
        buf[:len(m)] = m
        buf[len(m)] ^= 0x01
        buf[-1] ^= 0x80
        words[:, i] = np.frombuffer(bytes(buf), "<u4")
    return words


def test_keccak_state_matches_round_kernel_in_interpret_mode():
    """The plain 50-word state against the reference's round kernel run
    through pallas_call in interpret mode (grid = (1, 24) at wide = 256,
    as tests/test_pallas_kernels.py runs the grid variant), and the
    digest rows against the host keccak256."""
    rng = np.random.default_rng(34)
    msgs = [bytes(range(64)), b"\x00" * 64, b"\xff" * 64, rng.bytes(64),
            rng.bytes(110), b""]
    words = np.zeros((34, 256), np.uint32)
    words[:, :len(msgs)] = _blocks(msgs)
    words[:, len(msgs):] = rng.integers(0, 1 << 32, (34, 256 - len(msgs)),
                                        dtype=np.uint64)
    want = np.asarray(pl.pallas_call(
        pk._keccak_round_kernel,
        out_shape=jax.ShapeDtypeStruct((50, 256), jnp.uint32),
        grid=(1, 24),
        in_specs=[pl.BlockSpec((34, 256), lambda b, r: (0, b))],
        out_specs=pl.BlockSpec((50, 256), lambda b, r: (0, b)),
        interpret=True,
    )(jnp.asarray(words)))
    with _counting() as counts:
        got = U(K.keccak_rows_grid(R(words)))
    assert _launched(counts) == {"keccak_rows_grid": 1}
    np.testing.assert_array_equal(got, want)
    digests = got[list(field.KECCAK_DIGEST_ROWS)]
    for i, m in enumerate(msgs):
        assert digests[:, i].astype("<u4").tobytes() == keccak256(m)


# ---------------------------------------------------------------------------
# the paths under the configuration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recover_rows():
    return tt.recover_class_rows(np.random.default_rng(2036))


@pytest.fixture(scope="module")
def verify_rows():
    return tt.verify_rows(np.random.default_rng(2037), 1)


def test_recover_addresses_under_tiling(recover_rows):
    sigs, hashes, kinds = recover_rows
    verifier = BatchVerifier(device="cpu")
    want = verifier.recover_addresses(sigs, hashes)
    with tt.tiling_config(), _counting() as counts:
        got = verifier.recover_addresses(sigs, hashes)
    assert _launched(counts) == tt.TILING_RECOVER_LAUNCHES
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    addrs, ok = got
    for i, kind in enumerate(kinds):
        ans = tt.host_recover(sigs[i], hashes[i])
        if ans is None:
            assert not ok[i] and not addrs[i].any(), kind
        else:
            assert ok[i] and bytes(addrs[i]) == ans[0], kind


def test_verify_under_tiling(verify_rows):
    sigs, hashes, pubs, kinds = verify_rows
    verifier = BatchVerifier(device="cpu")
    want = verifier.verify(sigs, hashes, pubs)
    with tt.tiling_config(), _counting() as counts:
        got = verifier.verify(sigs, hashes, pubs)
    assert _launched(counts) == tt.TILING_VERIFY_LAUNCHES
    np.testing.assert_array_equal(got, want)
    assert [bool(v) for v in got] == [
        tt.host_verify(*row) for row in zip(sigs, hashes, pubs)]
    assert set(kinds) == set(tt.VERIFY_CLASSES)


def test_keccak256_fixed_under_tiling():
    msgs = np.random.default_rng(35).integers(0, 256, (130, 110),
                                              dtype=np.uint8)
    want = keccak256_fixed(torch.from_numpy(msgs))
    with tt.tiling_config(), _counting() as counts:
        got = keccak256_fixed(torch.from_numpy(msgs))
    assert _launched(counts) == {"keccak_rows_grid": 1}
    assert torch.equal(got, want)
    for i in range(len(msgs)):
        assert bytes(got[i].numpy()) == keccak256(bytes(msgs[i]))


def test_tiling_kernels_are_listed():
    src = open(pk.__file__).read().splitlines()
    defs = {"pow_mod_rows8": "def pow_mod_rows8(",
            "strauss_tab_rows8": "def strauss_tab_rows8(",
            "keccak_rows_grid": "def _keccak_round_kernel("}
    for name, head in defs.items():
        assert name in K.KERNELS and K.SOURCE_OF[name] == "tiling.cu"
        path, line = K.REPLACES[name].split(":")
        assert path.endswith("pallas_kernels.py")
        assert src[int(line) - 1].startswith(head)
