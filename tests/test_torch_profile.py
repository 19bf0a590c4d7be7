"""The port's profiling harness (``eges_tpu_torch/harness``) and its four
kernels (#20a-#20d, ``ops/csrc/profile.cu``) on the CPU.

The plain versions of the kernels are held bit for bit (tolerance 0:
the arithmetic is integer, and ``x + 1.0`` is one IEEE add) against the
JAX package: the chains against 64 chained ``pallas_kernels._k_mul``
numpy twins on the same relaxed limbs (the chain kernels in interpret
mode would take minutes to trace), the one-multiply tile kernel against
``fp_mul_pallas`` and the reference harness's own ``_fp_mul8b_kernel``
in interpret mode, and the copy kernel against the reference's
``pallasnop`` kernel in interpret mode.  Then the harness's own logic:
the provenance header, the floor's verdict against the reference's
arithmetic on canned results, one floor child run in this process,
``measure_recover``'s correctness gate and the launch census's sorting
of canned profiler events."""

import ast
import json
import pathlib
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eges_tpu.ops import pallas_kernels as pk
from eges_tpu_torch.harness import (hlo_census, measure_recover,
                                    profile_floor, profile_mul8b, profutil)
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import P, int_to_limbs

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CHAIN = 64
R = K.from_reference
U = K.to_reference


def _limb_columns(seed: int, B: int) -> np.ndarray:
    """``[16, B]`` uint32 limb-major values: random 16-bit limbs (relaxed,
    up to 2^256 - 1) with the edge values 0, 1, P - 1, P and all-0xFFFF
    in the first columns."""
    a = np.random.default_rng(seed).integers(0, 2**16, (16, B),
                                              dtype=np.int64).astype(np.uint32)
    for c, v in enumerate((0, 1, P - 1, P, 2**256 - 1)):
        a[:, c] = int_to_limbs(v)
    return a


def _twin_chain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """64 chained ``_k_mul(xp=np)`` on limb-major columns."""
    x, y = list(a), list(b)
    for _ in range(CHAIN):
        x = pk._k_mul(x, y, xp=np)
    return np.stack(x)


def _relay(a: np.ndarray) -> np.ndarray:
    """``[16, B]`` -> ``[B/1024, 128, 128]``, the reference's re-lay
    (harness/profile_mul8b.py:44-47, from the limb-major side)."""
    nb = a.shape[1] // 1024
    return a.reshape(16, nb, 8, 128).transpose(1, 0, 2, 3).reshape(
        nb, 128, 128)


@pytest.mark.parametrize("lane", [128, 256])
def test_chain_1d_matches_the_k_mul_twin(lane):
    a, b = _limb_columns(1, 256), _limb_columns(2, 256)[:, ::-1].copy()
    got = K.fp_mul_chain_pallas(R(a), R(b), CHAIN, lane)
    np.testing.assert_array_equal(U(got), _twin_chain(a, b))


@pytest.mark.parametrize("B,lane", [(384, 256), (256, 1024), (256, 200),
                                    (256, 0)])
def test_chain_1d_refuses_a_batch_off_the_lane_block(B, lane):
    a = R(_limb_columns(3, B))
    with pytest.raises(ValueError):
        K.fp_mul_chain_pallas(a, a, CHAIN, lane)


def test_chain_rows8_matches_the_twin_and_the_1d_chain():
    a, b = _limb_columns(4, 1024), _limb_columns(5, 1024)[:, ::-1].copy()
    want = _relay(_twin_chain(a, b))
    got = K.fp_mul_chain_rows8(R(_relay(a)), R(_relay(b)))
    np.testing.assert_array_equal(U(got), want)
    one_d = K.fp_mul_chain_pallas(R(a), R(b), CHAIN, 256)
    np.testing.assert_array_equal(_relay(U(one_d)), U(got))
    with pytest.raises(ValueError):
        K.fp_mul_rows8(R(_relay(a)), R(_relay(b))[:, :64])


def test_mul_rows8_matches_fp_mul_pallas():
    """#20c through ``fp_mul8b`` on values below P (``random.Random(3)``,
    as the reference harness draws them) against #7 in interpret
    mode."""
    a, b = (t.numpy() for t in profile_mul8b.operands(1024, "cpu"))
    want = np.asarray(pk.fp_mul_pallas(jnp.asarray(a.view(np.uint32)),
                                       jnp.asarray(b.view(np.uint32)),
                                       interpret=True))
    got = profile_mul8b.fp_mul8b(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(U(got), want)
    with pytest.raises(ValueError):
        profile_mul8b.fp_mul8b(torch.from_numpy(a[:1000]),
                               torch.from_numpy(b[:1000]))


def test_mul_rows8_matches_the_harness_kernel():
    """#20c on the reference's tiles against its ``_fp_mul8b_kernel`` in
    interpret mode."""
    from harness.profile_mul8b import _fp_mul8b_kernel

    a, b = (t.numpy().view(np.uint32) for t in profile_mul8b.operands(
        1024, "cpu"))
    at, bt = _relay(a.T), _relay(b.T)
    spec = pl.BlockSpec((1, 128, 128), lambda i: (i, 0, 0))
    tiles = pl.pallas_call(
        _fp_mul8b_kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct(at.shape, jnp.uint32),
        grid=(at.shape[0],), in_specs=[spec] * 2, out_specs=spec)(
            jnp.asarray(at), jnp.asarray(bt))
    np.testing.assert_array_equal(U(K.fp_mul_rows8(R(at), R(bt))),
                                  np.asarray(tiles))


def _reference_pallasnop_kernel():
    """``_kern`` of the reference's ``pallasnop`` config, taken from the
    source of ``harness/profile_floor.py`` (it is local to ``_child``)."""
    tree = ast.parse((REPO / "harness" / "profile_floor.py").read_text())
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "_kern")
    ns: dict = {}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "profile_floor",
                 "exec"), ns)
    return ns["_kern"]


def test_add_one_matches_the_pallasnop_kernel():
    x = np.random.default_rng(6).standard_normal(profile_floor.SHAPE,
                                                 dtype=np.float32)
    x[0, :6] = (0.0, -1.0, 1e30, -1e-30, 2.0**24, -0.5)
    want = pl.pallas_call(
        _reference_pallasnop_kernel(), interpret=True,
        out_shape=jax.ShapeDtypeStruct(profile_floor.SHAPE, jnp.float32))(
            jnp.asarray(x))
    got = K.add_one_f32(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    with pytest.raises(TypeError):
        K.add_one_f32(torch.from_numpy(x).double())


def test_header_line_names_torch_and_no_jax():
    line = profutil.header_line(source="t", batch=4)
    assert line.startswith("# eges-profile-v1 ")
    hdr = json.loads(line[len("# eges-profile-v1 "):])
    assert hdr["torch"] == torch.__version__
    assert hdr["source"] == "t" and hdr["batch"] == 4
    assert "git_rev" in hdr and "python" in hdr and "cuda" in hdr
    assert "jax" not in hdr and "jaxlib" not in hdr


_FLOOR = {
    "rtt": {"config": "rtt", "upload_ms": 0.03, "download_ms": 0.02},
    "nop": {"config": "nop", "k": 0, "per_call_ms": 0.03},
    "pallasnop": {"config": "pallasnop", "k": 0, "per_call_ms": 0.05},
    "out3": {"config": "out3", "k": 0, "per_call_ms": 0.07},
    "chain16": {"config": "chain16", "k": 16, "per_call_ms": 0.61},
    "chain64": {"config": "chain64", "k": 64, "per_call_ms": 2.31},
    "chain256": {"config": "chain256", "k": 256, "per_call_ms": 9.17},
    "chain64d": {"config": "chain64d", "k": 64, "per_call_ms": 2.44},
}


@pytest.mark.parametrize("missing", [(), ("pallasnop", "out3", "chain64d"),
                                     ("chain256",)])
def test_floor_verdict_is_the_reference_arithmetic(missing, monkeypatch,
                                                   capsys):
    """The reference's ``main`` run on canned child output (its
    subprocess stubbed) prints the VERDICT that ``verdict`` computes,
    rounded as the reference rounds."""
    import harness.profile_floor as ref

    canned = {n: r for n, r in _FLOOR.items() if n not in missing}

    def fake_run(cmd, **kw):
        name = cmd[cmd.index("--child") + 1]
        out = f"device: canned\nFLOOR {json.dumps(canned[name])}\n" \
            if name in canned else ""
        return subprocess.CompletedProcess(cmd, 0 if out else 1, out, "")

    monkeypatch.setattr(ref.subprocess, "run", fake_run)
    ref.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("VERDICT ")]
    want = json.loads(lines[0][len("VERDICT "):])
    got = profile_floor.verdict(canned)
    assert {k: round(v, 2) for k, v in got.items()} == want


def test_floor_verdict_needs_nop_and_two_chains():
    assert profile_floor.verdict({"chain16": _FLOOR["chain16"]}) is None
    assert profile_floor.verdict(
        {n: r for n, r in _FLOOR.items() if n != "nop"}) is None


def test_floor_child_prints_a_floor_line(capsys):
    rec = profile_floor.child("pallasnop", "cpu", seed=1)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("FLOOR ")]
    assert len(lines) == 1 and json.loads(lines[0][6:]) == rec
    assert set(rec) == {"config", "k", "compile_s", "per_call_ms", "min_ms",
                        "max_ms", "launches"}
    assert rec["config"] == "pallasnop" and rec["k"] == 0
    assert 0 < rec["min_ms"] <= rec["per_call_ms"] <= rec["max_ms"]
    assert rec["launches"] == {}  # the plain version on the CPU


def test_measure_recover_gate_at_16_rows():
    from eges_tpu_torch.crypto.verifier import ecrecover_batch
    from eges_tpu_torch.models.flagship import example_batch

    sigs, hashes, valid, expect = example_batch(
        16, np.random.default_rng(7), invalid_every=17)
    assert not valid[5] and expect[5] is None
    out = ecrecover_batch(torch.from_numpy(sigs), torch.from_numpy(hashes))
    assert measure_recover.gate(out, valid, expect) == 15
    addrs, pubs, ok = out
    bad = addrs.clone()
    bad[3, 0] ^= 1
    with pytest.raises(AssertionError, match="row 3"):
        measure_recover.gate((bad, pubs, ok), valid, expect)
    flags = valid.copy()
    flags[4] = False
    with pytest.raises(AssertionError, match="row 4: invalid"):
        measure_recover.gate(out, flags, expect)


def test_launch_census_sorts_kernels_by_kind():
    events = [("k_fp_mul", 5.0), ("k_pow_p", 700.0), ("k_fp_mul", 6.0),
              ("void at::native::vectorized_elementwise_kernel<4>", 1.5),
              ("Memcpy DtoD (Device -> Device)", 2.0),
              ("Memset (Device)", 1.0)]
    out = hlo_census.census(events)
    assert out["hand_written"] == {"k_fp_mul": 2, "k_pow_p": 1}
    assert out["aten"] == {
        "void at::native::vectorized_elementwise_kernel<4>": 1}
    assert set(out["copy"]) == {"Memcpy DtoD (Device -> Device)",
                                "Memset (Device)"}
    assert out["kernel_us"] == 712.5 and out["copy_us"] == 3.0
    assert out["us"]["k_fp_mul"] == 11.0


def test_launch_census_keeps_each_hand_written_launch():
    """The device us of every hand-written launch, by name in the order
    they ran (the fp_mul and finish launches of a recovery, one by one);
    ATen kernels and copies are summed only."""
    events = [("k_fp_mul_t1", 5.0), ("k_recover_finish_t8", 9.0),
              ("k_fp_mul_t1", 6.0), ("Memset (Device)", 1.0),
              ("void at::native::reduce_kernel<512, 1>", 2.0),
              ("k_fp_mul_t1", 4.5)]
    out = hlo_census.census(events)
    assert out["launch_us"] == {"k_fp_mul_t1": [5.0, 6.0, 4.5],
                                "k_recover_finish_t8": [9.0]}
    assert out["launch_order"] == [("k_fp_mul_t1", 5.0),
                                   ("k_recover_finish_t8", 9.0),
                                   ("k_fp_mul_t1", 6.0),
                                   ("k_fp_mul_t1", 4.5)]
    assert out["us"]["k_fp_mul_t1"] == 15.5
