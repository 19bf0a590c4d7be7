"""The plain versions of the four kernels of the classic-verify and
keccak paths (``fn_mul``, ``fn_red17``, ``fp_add``, ``keccak_block``)
against the JAX package's numpy twins (``_k_fn_mul``, ``_k_fn_red_cols``,
``_k_add``, ``_k_keccak_words`` with ``xp=np``), and ``fp_add`` and
``fn_red17`` against their real ``pallas_call`` in interpret mode at one
LANE_BLOCK, bit for bit (tolerance 0: the arithmetic is integer).  Also
the wrappers' CPU routing and input checks."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eges_tpu.ops import pallas_kernels as pk
from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto.keccak import keccak256
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import N

# a few rows a tensor: one torch thread is as fast, and leaves the cores
# to the other test workers
torch.set_num_threads(1)

R = K.from_reference
U = K.to_reference


def _lst(a):
    a = np.asarray(a, np.uint32)
    return [a[:, k].copy() for k in range(a.shape[1])]


def _unl(lst):
    return np.stack([np.asarray(v, np.uint32) for v in lst], axis=-1)


def _vals(seed, n, bound=1 << 256):
    return tt.limb_rows(tt.field_values(np.random.default_rng(seed), n,
                                        bound))


def _cols17(seed, n):
    """17 small columns a row: random limbs with a nonzero top column,
    and the extremes: all 0xFFFF, a zero top, a value >= N, and the top
    column alone."""
    c = np.random.default_rng(seed).integers(0, 1 << 16, (n, 17)).astype(
        np.uint32)
    c[0] = 0xFFFF
    c[1, 16] = 0
    c[2, :16] = tt.limb_rows([N + 5])[0]
    c[2, 16] = 0
    c[3, :16] = 0
    c[3, 16] = 1
    return c


def test_fn_mul_plain():
    a, b = _vals(31, 16), _vals(32, 16, N)[::-1].copy()
    np.testing.assert_array_equal(U(K.fn_mul_plain(R(a), R(b))),
                                  _unl(pk._k_fn_mul(_lst(a), _lst(b), np)))


def test_fn_red17_plain():
    c = _cols17(33, 16)
    np.testing.assert_array_equal(U(K.fn_red17_plain(R(c))),
                                  _unl(pk._k_fn_red_cols(_lst(c), np)))


def test_fp_add_plain():
    a, b = _vals(34, 16), _vals(35, 16)[::-1].copy()
    np.testing.assert_array_equal(U(K.fp_add_plain(R(a), R(b))),
                                  _unl(pk._k_add(_lst(a), _lst(b), np)))


def test_keccak_block_plain():
    rng = np.random.default_rng(36)
    msgs = [b"", bytes(64), b"\xff" * 110, rng.bytes(135), rng.bytes(64)]
    words = np.zeros((len(msgs), 34), np.uint32)
    for i, m in enumerate(msgs):
        buf = bytearray(136)
        buf[:len(m)] = m
        buf[len(m)] ^= 0x01
        buf[-1] ^= 0x80
        words[i] = np.frombuffer(bytes(buf), "<u4")
    got = U(K.keccak_block_plain(R(words)))
    assert got.shape == (len(msgs), 8)
    np.testing.assert_array_equal(
        got, _unl(pk._k_keccak_words(_lst(words), np)))
    for i, m in enumerate(msgs):
        assert got[i].astype("<u4").tobytes() == keccak256(m)


@pytest.mark.parametrize("name", ["fp_add", "fn_red17"])
def test_plain_matches_pallas_call(name):
    """Against the real pallas_call in interpret mode at one LANE_BLOCK
    (fn_mul's and keccak_block's interpret runs take minutes on a CPU;
    their twins above are the same math)."""
    if name == "fp_add":
        a, b = _vals(37, 256), _vals(38, 256)[::-1].copy()
        want = pk.fp_add_pallas(jnp.asarray(a), jnp.asarray(b),
                                interpret=True)
        got = K.fp_add_plain(R(a), R(b))
    else:
        c = _cols17(39, 256)
        want = pk.fn_red17_pallas(jnp.asarray(c), interpret=True)
        got = K.fn_red17_plain(R(c))
    np.testing.assert_array_equal(U(got), np.asarray(want))


def test_wrappers_on_cpu_run_the_plain_version_without_counting():
    a, b = R(_vals(40, 8)), R(_vals(41, 8))
    c = R(_cols17(42, 8))
    w = R(np.arange(3 * 34, dtype=np.uint32).reshape(3, 34))
    K.reset_launches()
    for got, want in ((K.fn_mul_pallas(a, b), K.fn_mul_plain(a, b)),
                      (K.fp_add_pallas(a, b), K.fp_add_plain(a, b)),
                      (K.fn_red17_pallas(c), K.fn_red17_plain(c)),
                      (K.keccak_block_pallas(w), K.keccak_block_plain(w))):
        assert torch.equal(got, want)
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.parametrize("call", [
    lambda a: K.fn_mul_pallas(a, a[:, :8].contiguous()),
    lambda a: K.fp_add_pallas(a, a.to(torch.int64)),
    lambda a: K.fn_red17_pallas(a),
    lambda a: K.keccak_block_pallas(a[:, :8]),
    lambda a: K.keccak_block_pallas(a.reshape(-1)),
])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call(R(_vals(43, 4)))


def test_new_kernels_are_listed():
    for name in ("fn_mul", "fn_red17", "fp_add", "keccak_block"):
        assert name in K.KERNELS and K.SOURCE_OF[name] == "verify.cu"
        assert K.REPLACES[name].startswith("eges_tpu/ops/pallas_kernels.py:")
    assert len(K.KERNELS) == len(K.REPLACES) == 29


@pytest.mark.parametrize("name", ["fn_mul", "fn_red17", "fp_add",
                                  "keccak_block", "fp_sub", "fp_neg",
                                  "fp_mul_small", "fn_sub", "fn_neg",
                                  "mulhi8"])
def test_replaces_names_the_pallas_wrapper(name):
    path, line = K.REPLACES[name].split(":")
    src = open(pk.__file__).read().splitlines()
    assert path.endswith("pallas_kernels.py")
    assert src[int(line) - 1].startswith(f"def {name}_pallas(")
