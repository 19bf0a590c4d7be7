"""The port's model registry (``eges_tpu_torch.models``) against the JAX
package's: the same names, each entry point reaching the port's
counterpart of the reference's function with its inputs on the asked
device, the card by default; and ``example_batch`` from an explicit
generator."""

import numpy as np
import pytest
import torch

from eges_tpu import models as jmodels
from eges_tpu_torch import models
from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto import keccak as host_keccak
from eges_tpu_torch.crypto import verifier as V

torch.set_num_threads(1)


def test_names_match_the_reference():
    assert models.MODELS == jmodels.MODELS
    with pytest.raises(KeyError):
        models.model("bls_aggregate", device="cpu")


@pytest.mark.parametrize("name,target", [
    ("ecrecover", "ecrecover_batch"), ("flagship", "ecrecover_batch"),
    ("classic_verify", "verify_batch")])
def test_entry_points_reach_the_port(monkeypatch, name, target):
    seen = []
    monkeypatch.setattr(V, target, lambda *a: seen.append(a) or "out")
    fwd = models.model(name, device="cpu")
    args = [np.zeros((2, 65), np.uint8), np.zeros((2, 32), np.uint8)]
    if target == "verify_batch":
        args.append(np.zeros((2, 64), np.uint8))
    assert fwd(*args) == "out"
    (got,), = [seen]
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               and t.dtype == torch.uint8 for t in got)
    assert [tuple(t.shape) for t in got] == [a.shape for a in args]


def test_keccak256_entry_point_output():
    data = np.random.default_rng(3).integers(0, 256, (4, 110),
                                             dtype=np.uint8)
    out = models.model("keccak256", device="cpu")(data)
    assert out.shape == (4, 32)
    for i in range(4):
        assert bytes(out[i].numpy()) == host_keccak.keccak256(bytes(data[i]))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert models.model("keccak256") is not None
        return
    for name in models.MODELS:
        with pytest.raises(RuntimeError, match="CUDA"):
            models.model(name)


def test_example_batch_is_seeded_and_right():
    a = models.example_batch(13, np.random.default_rng(9), invalid_every=7,
                             n_keys=3)
    b = models.example_batch(13, np.random.default_rng(9), invalid_every=7,
                             n_keys=3)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    sigs, hashes, valid, expect = a
    assert sigs.shape == (13, 65) and hashes.shape == (13, 32)
    assert list(np.flatnonzero(~valid)) == [5, 12]
    assert expect[5] is None and sigs[5, 40] != sigs[2, 40]
    assert sigs[12, 64] == 9 and expect[12] == b"\0" * 20
    for i in (0, 1, 2, 3):
        assert tt.host_recover(sigs[i], hashes[i])[0] == expect[i]
    assert expect[3] == expect[0]          # three keys, reused in turn
