"""The port's batched Keccak-256 (``eges_tpu_torch/ops/keccak.py``) on the
CPU against the JAX package's ``keccak256_fixed`` and the host model's
``keccak256``, byte for byte, at message lengths on both sides of the
136-byte block; ``pubkey_to_address`` against the JAX package's; and
the routing: a 1-D batch of one-block messages goes through the
``keccak_block`` kernel's wrapper, everything else through the
torch-ops permutation; bytes held in int32 or int64 tensors hash as
their uint8 rows (fault C6)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eges_tpu.crypto import keccak as jkeccak
from eges_tpu.ops import keccak_tpu
from eges_tpu_torch.crypto.keccak import keccak256
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops import keccak as pkeccak

# a few rows a tensor: one torch thread is as fast, and leaves the cores
# to the other test workers
torch.set_num_threads(1)


def _msgs(length, n=5, seed=0):
    m = np.random.default_rng(seed + length).integers(0, 256, (n, length),
                                                      dtype=np.uint8)
    if length:
        m[0] = 0xFF
    return m


@pytest.mark.parametrize("length", [0, 64, 110, 135, 136, 200])
def test_keccak256_fixed_matches_jax_and_host(length):
    msgs = _msgs(length)
    got = pkeccak.keccak256_fixed(torch.from_numpy(msgs)).numpy()
    want = np.asarray(keccak_tpu.keccak256_fixed(jnp.asarray(msgs)))
    np.testing.assert_array_equal(got, want)
    for i in range(len(msgs)):
        assert bytes(got[i]) == keccak256(bytes(msgs[i]))
        assert bytes(got[i]) == jkeccak.keccak256(bytes(msgs[i]))


def test_pubkey_to_address_matches_jax():
    keys = _msgs(64, n=6, seed=1)
    qx, qy = keys[:, :32], keys[:, 32:]
    got = pkeccak.pubkey_to_address(torch.from_numpy(qx),
                                    torch.from_numpy(qy)).numpy()
    want = np.asarray(keccak_tpu.pubkey_to_address(jnp.asarray(qx),
                                                   jnp.asarray(qy)))
    assert got.shape == (6, 20)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,length,via_block", [
    ((7,), 110, True), ((7,), 135, True), ((7,), 136, False),
    ((3, 2), 64, False), ((), 64, False)])
def test_routing_and_shapes(monkeypatch, shape, length, via_block):
    calls = []
    real = K.keccak_block_pallas
    monkeypatch.setattr(K, "keccak_block_pallas",
                        lambda w: calls.append(w.shape) or real(w))
    msgs = np.random.default_rng(2).integers(0, 256, (*shape, length),
                                             dtype=np.uint8)
    got = pkeccak.keccak256_fixed(torch.from_numpy(msgs))
    assert got.shape == (*shape, 32) and got.dtype == torch.uint8
    assert calls == ([(shape[0], 34)] if via_block else [])
    flat = msgs.reshape(-1, length)
    for i, digest in enumerate(got.reshape(-1, 32).numpy()):
        assert bytes(digest) == keccak256(bytes(flat[i]))


def test_rejects_non_bytes():
    """Bytes come as integers: a float, complex or bool tensor raises
    (an integer tensor of any width is cast, fault C6)."""
    for dtype in (torch.float32, torch.complex64, torch.bool):
        with pytest.raises(TypeError):
            pkeccak.keccak256_fixed(torch.zeros(2, 8, dtype=dtype))
    with pytest.raises(TypeError):
        pkeccak.pubkey_to_address(torch.zeros(2, 32), torch.zeros(2, 32))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [(5, 40), (5, 64), (5, 137), (2, 3, 40)])
def test_keccak256_fixed_takes_integer_bytes(shape, dtype):
    """Fault C6: byte values 0..255 in an int32 or int64 tensor hash as
    the uint8 rows do, and as the JAX package hashes the same integer
    rows, byte for byte (one block, two blocks, a stacked batch)."""
    msgs = np.random.default_rng(sum(shape)).integers(0, 256, shape)
    msgs.reshape(-1, shape[-1])[0] = 0xFF
    got = pkeccak.keccak256_fixed(torch.from_numpy(msgs).to(dtype))
    want = pkeccak.keccak256_fixed(torch.from_numpy(msgs.astype(np.uint8)))
    assert got.dtype == torch.uint8 and got.shape == (*shape[:-1], 32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = np.asarray(keccak_tpu.keccak256_fixed(
        jnp.asarray(msgs.astype(np.int32))))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_pubkey_to_address_takes_integer_bytes(dtype):
    """Fault C6 through address derivation: int key halves (one row of
    all ones) give the JAX package's addresses of the same rows."""
    keys = _msgs(64, n=2, seed=3).astype(np.int64)
    keys[1] = 1
    qx, qy = keys[:, :32], keys[:, 32:]
    got = pkeccak.pubkey_to_address(torch.from_numpy(qx).to(dtype),
                                    torch.from_numpy(qy).to(dtype))
    want = np.asarray(keccak_tpu.pubkey_to_address(
        jnp.asarray(qx.astype(np.int32)), jnp.asarray(qy.astype(np.int32))))
    assert got.dtype == torch.uint8 and got.shape == (2, 20)
    np.testing.assert_array_equal(got.numpy(), want)
