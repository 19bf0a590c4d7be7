"""The plain versions of eges_tpu_torch's eleven kernels against the JAX
package's numpy twins (and, for fp_mul, the real ``pallas_call`` in
interpret mode), at the reference wrappers' layouts, bit for bit
(tolerance 0: the arithmetic is integer).  Also the layout converters,
the CPU routing of the wrappers, their input checks, and the constant
tables the CUDA kernels receive."""

import re

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eges_tpu.ops import ec as jec
from eges_tpu.ops import pallas_kernels as pk
from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto import keccak as port_keccak
from eges_tpu_torch.ops import build, curve, field, kernels as K
from eges_tpu_torch.ops.bigint import N, P

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


# ---------------------------------------------------------------------------
# the eleven plain kernels against the JAX twins
# ---------------------------------------------------------------------------

def test_recover_prelude_plain():
    rng = np.random.default_rng(1)
    n = 16
    sigs = rng.integers(0, 256, (n, 65), dtype=np.uint8)
    sigs[:, 64] = rng.integers(0, 6, n)
    sigs[0, :32] = 0                                             # r = 0
    sigs[1, :32] = np.frombuffer(N.to_bytes(32, "big"), np.uint8)  # r = N
    sigs[2, 32:64] = np.frombuffer(N.to_bytes(32, "big"), np.uint8)
    sigs[3, :32] = np.frombuffer((P - N).to_bytes(32, "big"), np.uint8)
    sigs[3, 64] = 2                                              # x = P
    sigs[4, :64] = 0xFF
    hashes = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    got = K.recover_prelude_plain(torch.from_numpy(sigs),
                                  torch.from_numpy(hashes))
    srows = _lst(sigs.astype(np.uint32))
    r = pk._k_unpack_be(srows, 0, np)
    s = pk._k_unpack_be(srows, 32, np)
    z = pk._k_unpack_be(_lst(hashes.astype(np.uint32)), 0, np)
    v = srows[64]
    x, y_sq, ok = pk._k_recover_prelude(r, s, v, np)
    want = (_unl(x), _unl(y_sq), np.asarray(ok, np.uint32), _unl(r),
            _unl(s), _unl(z), v)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(U(g), w)


def _prelude_twin(sigs, hashes):
    """The reference's ``_k_recover_prelude`` (numpy) on ``[n, 65]`` rows:
    ``(x, y_sq, ok, r, s, z, v)`` in the wrappers' layout."""
    srows = _lst(sigs[:, :65].astype(np.uint32))
    r = pk._k_unpack_be(srows, 0, np)
    s = pk._k_unpack_be(srows, 32, np)
    z = pk._k_unpack_be(_lst(hashes.astype(np.uint32)), 0, np)
    x, y_sq, ok = pk._k_recover_prelude(r, s, srows[64], np)
    return (_unl(x), _unl(y_sq), np.asarray(ok, np.uint32), _unl(r),
            _unl(s), _unl(z), srows[64])


def _prelude_layouts(sigs):
    """``[n, 65]`` u8 rows as the card may find them: at pitches 65, 66
    and 70 (0xAB past byte 65), 1 byte into a buffer, and as int32 and
    int64 byte rows cast to uint8 by the caller."""
    out = {f"pitch{pitch}+{off}": tt.pitched_rows(torch.from_numpy(sigs),
                                                 pitch, off)
           for pitch, off in ((65, 0), (66, 0), (70, 0), (65, 1))}
    for dt in (torch.int32, torch.int64):
        out[str(dt)] = torch.from_numpy(sigs).to(dt).to(torch.uint8)
    return out


def test_recover_prelude_lanes_on_cpu_every_class():
    """40 rows of every class the prelude's checks tell apart
    (``testing.prelude_rows``: valid rows of both parities, recovery ids 2
    and 3, r = 0, s >= N, bad v, x >= P, r + N past 2^256, no x
    coordinate, r and s at N - 1 and N), at pitches 65, 66 and 70, 1 byte
    off and as int32 and int64 rows, through the plain version, the
    wrapper and every lane entry given CPU tensors: the reference's
    ``_k_recover_prelude`` exactly, and no launch counted."""
    sigs, hashes = tt.prelude_rows(np.random.default_rng(52), 40)
    want = _prelude_twin(sigs, hashes)
    h = torch.from_numpy(hashes)
    K.reset_launches()
    for name, rows in _prelude_layouts(sigs).items():
        assert rows.stride(1) == 1
        for got in (K.recover_prelude_plain(rows, h),
                    K.recover_prelude_pallas(rows, h),
                    *(K.recover_prelude_lanes(rows, h, t, 64)
                      for t in K.LANES)):
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(U(g), w, err_msg=name)
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.slow
def test_recover_prelude_pallas_call_takes_wide_rows():
    """The reference's ``recover_prelude_pallas`` in interpret mode on the
    same rows 66 bytes wide (its block spec takes the first 65) gives the
    port's prelude bit for bit (its compile takes some 14 s on one
    core)."""
    sigs, hashes = tt.prelude_rows(np.random.default_rng(53), 40)
    wide = np.concatenate([sigs, np.full((40, 1), 0xAB, np.uint8)], 1)
    want = pk.recover_prelude_pallas(jnp.asarray(wide), jnp.asarray(hashes),
                                     interpret=True)
    got = K.recover_prelude_pallas(torch.from_numpy(wide),
                                   torch.from_numpy(hashes))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(U(g), np.asarray(w))


def _u1u2_rows(seed, n):
    """z below 2^256, s and r^-1 below N, r^-1 = 0 on every fifth row (r
    = 0), and the extreme limbs on row 1."""
    z, s, r_inv = _vals(seed, n), _vals(seed + 1, n, N), _vals(seed + 2, n, N)
    r_inv[::5] = 0
    z[1] = 0xFFFF
    return z, s, r_inv


def test_u1u2_lanes_on_cpu_with_zero_inverses_and_a_view():
    """40 rows, r^-1 = 0 among them (u1 = u2 = 0), through the plain
    version, the wrapper and every lane entry given CPU tensors, z also
    as a view 4 bytes off a 16-byte boundary: the reference's ``_k_u1u2``
    exactly, and no launch counted."""
    z, s, r_inv = _u1u2_rows(54, 40)
    want = [_unl(w) for w in pk._k_u1u2(_lst(z), _lst(s), _lst(r_inv), np)]
    assert not want[0][::5].any() and not want[1][::5].any()
    buf = torch.zeros(16 * 40 + 1, dtype=torch.int32)
    view = buf[1:].view(40, 16)
    view.copy_(R(z))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    K.reset_launches()
    for zz in (R(z), view):
        for got in (K.u1u2_plain(zz, R(s), R(r_inv)),
                    K.u1u2_pallas(zz, R(s), R(r_inv)),
                    *(K.u1u2_lanes(zz, R(s), R(r_inv), t, 128)
                      for t in K.LANES)):
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(U(g), w)
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.slow
def test_u1u2_plain_matches_pallas_call():
    """Against the reference's ``u1u2_pallas`` in interpret mode on the
    same rows (r^-1 = 0 among them; its compile takes more than 100
    minutes on one CPU core)."""
    z, s, r_inv = _u1u2_rows(55, 40)
    want = pk.u1u2_pallas(jnp.asarray(z), jnp.asarray(s), jnp.asarray(r_inv),
                          interpret=True)
    for g, w in zip(K.u1u2_plain(R(z), R(s), R(r_inv)), want, strict=True):
        np.testing.assert_array_equal(U(g), np.asarray(w))


@pytest.mark.parametrize("lanes,threads", [(3, 128), (4, 96), (16, 128),
                                           (1, 512)])
def test_prelude_and_u1u2_entries_reject_other_instances(lanes, threads):
    sigs = torch.zeros(2, 65, dtype=torch.uint8)
    hashes = torch.zeros(2, 32, dtype=torch.uint8)
    a = R(_vals(56, 2, N))
    with pytest.raises(ValueError):
        K.recover_prelude_lanes(sigs, hashes, lanes, threads)
    with pytest.raises(ValueError):
        K.u1u2_lanes(a, a, a, lanes, threads)


def _zeros(*shape, dtype=torch.uint8):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("sigs,hashes,err", [
    (_zeros(2, 64), _zeros(2, 32), ValueError),
    (_zeros(2, 65, dtype=torch.int32), _zeros(2, 32), TypeError),
    (_zeros(2, 65), _zeros(2, 31), ValueError),
    (_zeros(2, 65), _zeros(3, 32), ValueError)])
def test_prelude_wrapper_rejects_what_it_cannot_read(sigs, hashes, err):
    """Rows narrower than 65 bytes, another dtype than uint8 (the entry
    points cast), and hashes of another shape."""
    with pytest.raises(err):
        K.recover_prelude_pallas(sigs, hashes)


POW_CASES = {"sqrt": ((P + 1) // 4, "p"), "r_inv": (N - 2, "n"),
             "table_z_inv": (P - 2, "p"), "final_z_inv": (P - 2, "p")}


@pytest.mark.parametrize("case", sorted(POW_CASES))
def test_pow_mod_plain(case):
    e, mod = POW_CASES[case]
    a = _vals(len(case), 6, N if mod == "n" else 1 << 256)
    if case == "table_z_inv":
        a[1] = 0                        # the table's entry 0 has Z = 0
    got = U(K.pow_mod_plain(R(a), e, mod))
    np.testing.assert_array_equal(got, pk.pow_mod_np(a, e, mod))


def test_y_fix_plain():
    root, y_sq = _vals(2, 16), _vals(3, 16)
    v = np.random.default_rng(4).integers(0, 6, 16).astype(np.uint32)
    y, ok = K.y_fix_plain(R(root), R(y_sq), R(v))
    wy, wok = pk._k_y_fix(_lst(root), _lst(y_sq), v, np)
    np.testing.assert_array_equal(U(y), _unl(wy))
    np.testing.assert_array_equal(U(ok), np.asarray(wok, np.uint32))


@pytest.mark.parametrize("n", [1, 17, 300])
def test_y_fix_plain_at_ragged_counts(n):
    """The plain y_fix (the kernels' CPU route and their yardstick on the
    card) at row counts that fill no block, roots that are P or a square's
    root among them, against the reference's ``_k_y_fix``."""
    root, y_sq = _vals(60 + n, n), _vals(61 + n, n)
    root[::5] = np.asarray(tt.limb_rows([P]))[0]
    y_sq[1::2] = _unl(pk._k_sqr(_lst(root), np))[1::2]
    v = np.random.default_rng(62 + n).integers(0, 6, n).astype(np.uint32)
    y, ok = K.y_fix_plain(R(root), R(y_sq), R(v))
    wy, wok = pk._k_y_fix(_lst(root), _lst(y_sq), v, np)
    np.testing.assert_array_equal(U(y), _unl(wy))
    np.testing.assert_array_equal(U(ok), np.asarray(wok, np.uint32))


def test_u1u2_plain():
    z, s, r_inv = _vals(5, 16), _vals(6, 16, N), _vals(7, 16, N)
    got = K.u1u2_plain(R(z), R(s), R(r_inv))
    want = pk._k_u1u2(_lst(z), _lst(s), _lst(r_inv), np)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(U(g), _unl(w))


def test_glv_digits_plain():
    u1, u2 = _vals(8, 12, N), _vals(9, 12, N)[::-1].copy()
    dig, neg = K.glv_digits_plain(R(u1), R(u2))
    assert dig.shape == (33, 8, 256) and neg.shape == (8, 256)
    wd, wn = pk.glv_digits_np(u1, u2)
    np.testing.assert_array_equal(U(dig)[:, :, :12], wd)
    np.testing.assert_array_equal(U(neg)[:, :12], wn)
    # padded lanes split a zero scalar: all-zero digits and signs
    assert not U(dig)[:, :, 12:].any() and not U(neg)[:, 12:].any()


def _glv_cases(n=40):
    """u1 with the edge scalars first, u2 with them last (edges meet
    random scalars), at a row count that is no lane-block multiple."""
    rng = np.random.default_rng(50)
    return (tt.limb_rows(tt.glv_scalars(rng, n)),
            tt.limb_rows(tt.glv_scalars(rng, n)[::-1]))


def test_glv_digits_on_cpu_edge_scalars():
    """The plain version, the wrapper and every lane instance given CPU
    tensors (the plain version, no launch) on the edge scalars 0, 1, N - 1,
    lambda and N - lambda and on seeded ones, whose k2 comes out negative
    on some rows and positive on others, against the reference's numpy
    twin exactly; the padded columns split a zero scalar.  (k1 = a1 * e1
    + a2 * e2, the quotients' remainders e1, e2 in (-2^-129, 1), falls
    below 0 on hardly any scalar: its sign rows stay 0 here.)"""
    u1, u2 = _glv_cases()
    wd, wn = pk.glv_digits_np(u1, u2)
    assert wn[[1, 3]].any(1).all() and not wn[[1, 3]].all(1).any()
    K.reset_launches()
    for got in (K.glv_digits_plain(R(u1), R(u2)),
                K.glv_digits_pallas(R(u1), R(u2)),
                *(K.glv_digits_lanes(R(u1), R(u2), lanes, 64)
                  for lanes in K.LANES)):
        dig, neg = (U(t) for t in got)
        assert dig.shape == (33, 8, 256) and neg.shape == (8, 256)
        np.testing.assert_array_equal(dig[:, :, :40], wd)
        np.testing.assert_array_equal(neg[:, :40], wn)
        assert not dig[:, :, 40:].any() and not neg[:, 40:].any()
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.slow
def test_glv_digits_plain_matches_pallas_call():
    """Against the real pallas_call in interpret mode on the same rows
    (its compile takes minutes on one core)."""
    u1, u2 = _glv_cases()
    want = pk.glv_digits_pallas(jnp.asarray(u1), jnp.asarray(u2),
                                interpret=True)
    for g, w in zip(K.glv_digits_plain(R(u1), R(u2)), want):
        np.testing.assert_array_equal(U(g), np.asarray(w))


def test_point_table_plain():
    px, py = tt.curve_points(np.random.default_rng(10), 4)
    got = K.point_table_plain(R(px), R(py))
    for g, w in zip(got, pk.point_table_np(px, py)):
        np.testing.assert_array_equal(U(g), w)


def test_fp_mul_plain():
    a, b = _vals(11, 16), _vals(12, 16)[::-1].copy()
    np.testing.assert_array_equal(U(K.fp_mul_plain(R(a), R(b))),
                                  _unl(pk._k_mul(_lst(a), _lst(b), np)))


def test_fp_mul_plain_matches_pallas_call():
    """Against the real pallas_call in interpret mode, at a size that is
    not a LANE_BLOCK multiple (the reference's padding path)."""
    a, b = _vals(13, 40), _vals(14, 40)[::-1].copy()
    want = np.asarray(pk.fp_mul_pallas(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True))
    np.testing.assert_array_equal(U(K.fp_mul_plain(R(a), R(b))), want)


def test_fp_canon_plain():
    a = _vals(15, 16)
    np.testing.assert_array_equal(U(K.fp_canon_plain(R(a))),
                                  _unl(pk._k_cond_sub_p(_lst(a), np)))


def test_fp_canon_on_cpu_values_at_and_past_p():
    """Values in [P, 2^256), at and around P and below it, through the
    plain version, the wrapper and every block size given CPU tensors,
    also on a view 4 bytes off a 16-byte boundary (the kernel's word path
    on the card), against the reference's ``_k_cond_sub_p`` and its
    ``pallas_call`` in interpret mode, exactly."""
    a = tt.limb_rows(tt.canon_values(np.random.default_rng(51), 40))
    want = _unl(pk._k_cond_sub_p(_lst(a), np))
    np.testing.assert_array_equal(
        np.asarray(pk.fp_canon_pallas(jnp.asarray(a), interpret=True)), want)
    buf = torch.zeros(16 * 40 + 1, dtype=torch.int32)
    view = buf[1:].view(40, 16)
    view.copy_(R(a))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    K.reset_launches()
    for got in (K.fp_canon_plain(R(a)), K.fp_canon_pallas(R(a)),
                K.fp_canon_pallas(view),
                *(K.fp_canon_lanes(view, 1, t) for t in K.LANE_THREADS)):
        np.testing.assert_array_equal(U(got), want)
    assert sum(K.LAUNCHES.values()) == 0


def test_strauss_tab_plain():
    """Digits and signs from the GLV twin (a zero scalar among them),
    tables with entry 0 zero.  The ladder runs its last 10 windows: each
    window repeats the same arithmetic, and the whole 33-window ladder
    runs in tests/test_torch_recover.py."""
    rng = np.random.default_rng(16)
    n = 4
    u1 = tt.limb_rows([0, 1] + [tt.rand_int(rng, N) for _ in range(n - 2)])
    u2 = tt.limb_rows([tt.rand_int(rng, N) for _ in range(n)])
    dig, neg = pk.glv_digits_np(u1, u2)
    dig = np.ascontiguousarray(dig[-10:])
    wide = K.bpad(n)
    dig = np.pad(dig, ((0, 0), (0, 0), (0, wide - n)))
    neg = np.pad(neg, ((0, 0), (0, wide - n)))
    tabs = [np.pad(rng.integers(0, 1 << 16, (256, n)).astype(np.uint32),
                   ((0, 0), (0, wide - n))) for _ in range(3)]
    for t in tabs:
        t[:16] = 0                      # entry 0: the normalised infinity
    got = K.strauss_tab_plain(R(dig), R(neg), *map(R, tabs), n)
    want = pk.strauss_tab_np(dig, neg, *tabs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(U(g), _unl(w)[:n])


def test_recover_finish_plain():
    rng = np.random.default_rng(17)
    n = 8
    X, Y, Z, zi = (_vals(18 + i, n) for i in range(4))
    Z[2] = 0                            # a point at infinity
    ok = rng.integers(0, 2, n).astype(np.uint32)
    qx, qy, gok, words = K.recover_finish_plain(R(X), R(Y), R(Z), R(zi),
                                                R(ok))
    want = pk._k_recover_finish(_lst(X), _lst(Y), _lst(Z), _lst(zi), ok, np)
    np.testing.assert_array_equal(U(qx), _unl(want[0]))
    np.testing.assert_array_equal(U(qy), _unl(want[1]))
    np.testing.assert_array_equal(U(gok), np.asarray(want[2], np.uint32))
    assert words.shape == (34, 256)
    np.testing.assert_array_equal(U(words)[:, :n], _unl(want[3]).T)
    # padded lanes carry the padding block of an all-zero message
    pad = np.zeros(34, np.uint32)
    pad[16], pad[33] = 1, 0x80000000
    np.testing.assert_array_equal(U(words)[:, n:], np.repeat(
        pad[:, None], 256 - n, axis=1))


def test_keccak_rows_plain():
    rng = np.random.default_rng(22)
    msgs = [bytes(range(64)), b"\x00" * 64, b"\xff" * 64, rng.bytes(64),
            rng.bytes(32), b""]
    words = np.zeros((34, len(msgs)), np.uint32)
    for i, m in enumerate(msgs):
        buf = bytearray(port_keccak.RATE_BYTES)
        buf[:len(m)] = m
        buf[len(m)] ^= 0x01
        buf[-1] ^= 0x80
        words[:, i] = np.frombuffer(bytes(buf), "<u4")
    got = U(K.keccak_rows_plain(R(words)))
    np.testing.assert_array_equal(
        got, _unl(pk._k_keccak_words(_lst(words.T), np)).T)
    from eges_tpu.crypto.keccak import keccak256
    for i, m in enumerate(msgs):
        assert got[:, i].astype("<u4").tobytes() == keccak256(m)


@pytest.mark.parametrize("n", [1, 17, 300])
def test_keccak_rows_plain_at_ragged_counts(n):
    """The plain keccak_rows at column counts that fill no block, against
    the reference's numpy ``_k_keccak_words`` (random blocks, one of all
    zero and one of all one bits)."""
    words = np.random.default_rng(63 + n).integers(
        0, 1 << 32, (34, n), dtype=np.uint64).astype(np.uint32)
    words[:, 0] = 0
    words[:, -1] = 0xFFFFFFFF
    np.testing.assert_array_equal(
        U(K.keccak_rows_plain(R(words))),
        _unl(pk._k_keccak_words(_lst(words.T), np)).T)


# ---------------------------------------------------------------------------
# shared state: limb layout and constant tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 16), (34, 256), (33, 8, 256)])
def test_reference_layout_round_trip(shape):
    a = np.random.default_rng(23).integers(0, 1 << 32, shape,
                                           dtype=np.uint64).astype(np.uint32)
    a.reshape(-1)[:3] = (0x80000000, 0xFFFFFFFF, 0x7FFFFFFF)
    t = K.from_reference(a)
    assert t.dtype == torch.int32 and tuple(t.shape) == shape
    np.testing.assert_array_equal(K.to_reference(t), a)
    # the plain versions read the same bits back as unsigned values
    assert int(K._u(t).reshape(-1)[0]) == 0x80000000


def test_g_tables_match_reference():
    for port_tab, ref_tab in ((curve._g_table16, jec._g_table16),
                              (curve._g_lam_table16, jec._g_lam_table16)):
        for g, w in zip(port_tab(), ref_tab()):
            np.testing.assert_array_equal(g, w)


def test_packed_constants_match_reference_and_header():
    c = K.pack_constants()
    # the Consts struct of csrc/field.cuh, field by field
    src = (build.CSRC / "field.cuh").read_text()
    struct = src[src.index("struct Consts {"):src.index("};")]
    sizes = [int(np.prod([int(d) for d in re.findall(r"\[(\d+)\]", line)]))
             for line in struct.splitlines() if line.strip().startswith("u32")]
    assert sum(sizes) == c.size == 992
    np.testing.assert_array_equal(c[:16], pk._P_LIMBS)
    np.testing.assert_array_equal(c[16:32], pk._SUBC_LIMBS)
    np.testing.assert_array_equal(c[32:48], pk._N_LIMBS_C)
    np.testing.assert_array_equal(c[48:57], pk._N_DELTA_LIMBS)
    np.testing.assert_array_equal(c[64:80], pk._FN_SUBC_LIMBS)
    glv = [jec._G_G1, jec._G_G2, jec._G_A1, jec._G_A2, jec._G_B1N, jec._G_B2]
    np.testing.assert_array_equal(c[80:176], tt.limb_rows(glv).reshape(-1))
    tgx, tgy = jec._g_table16()
    tlx, _ = jec._g_lam_table16()
    np.testing.assert_array_equal(c[176:944], np.concatenate(
        [tgx.reshape(-1), tgy.reshape(-1), tlx.reshape(-1)]))
    rc = c[944:].reshape(24, 2).astype(np.uint64)
    assert [int(lo) | int(hi) << 32 for lo, hi in rc] == pk._KECCAK_RC


def test_every_header_keccak_rotation_table_matches_the_host_model():
    """keccak_words and the lane pair's grp_keccak_words each carry the
    rho rotations: every copy in field.cuh is the host model's."""
    src = (build.CSRC / "field.cuh").read_text()
    tables = re.findall(r"const int ROT\[25\] = \{([^}]*)\}", src)
    assert len(tables) == 2
    for t in tables:
        assert tuple(int(v) for v in t.split(",")) == port_keccak.ROTATIONS


def test_header_keccak_rotations_match_host_model():
    src = (build.CSRC / "field.cuh").read_text()
    m = re.search(r"const int ROT\[25\] = \{([^}]*)\}", src)
    assert tuple(int(v) for v in m.group(1).split(",")) == \
        port_keccak.ROTATIONS
    assert field.KECCAK_ROT == tuple(tuple(r) for r in pk._KECCAK_ROT)


# ---------------------------------------------------------------------------
# wrappers: CPU routing, input checks, build plumbing
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_run_the_plain_version_without_counting():
    a, b = R(_vals(24, 8)), R(_vals(25, 8))
    K.reset_launches()
    np.testing.assert_array_equal(U(K.fp_mul_pallas(a, b)),
                                  U(K.fp_mul_plain(a, b)))
    np.testing.assert_array_equal(U(K.fp_canon_pallas(a)),
                                  U(K.fp_canon_plain(a)))
    words = torch.zeros(34, 256, dtype=torch.int32)
    assert K.keccak_rows_pallas(words).shape == (8, 256)
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "mixed"])
def test_wrappers_reject_bad_inputs(bad):
    a = R(_vals(26, 8))
    b = {"dtype": a.to(torch.int64), "shape": a[:, :8].contiguous(),
         "strides": torch.cat([a, a], 1)[:, ::2],
         "mixed": a.to("meta")}[bad]
    with pytest.raises((TypeError, ValueError)):
        K.fp_mul_pallas(a, b)


def test_pow_digits_and_build_plumbing():
    assert K.pow_digits(P - 2)[-1] == (P - 2) & 0xF
    assert len(K.pow_digits(1)) == 64
    with pytest.raises(ValueError):
        K.pow_digits(1 << 256)
    cmd = build.FLAGS
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
    log = ("ptxas info    : Compiling entry function 'k_strauss' for "
           "'sm_90a'\nptxas info    : Function properties for k_strauss\n"
           "    960 bytes stack frame, 8 bytes spill stores, 16 bytes spill "
           "loads\nptxas info    : Used 255 registers, used 0 barriers\n")
    assert build.parse_ptxas(log) == {"k_strauss": {
        "stack_bytes": 960, "spill_store_bytes": 8, "spill_load_bytes": 16,
        "registers": 255}}


_SASS = """
	code for sm_90a
		Function : k_loop
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000e220000000800 */
        /*0010*/                   IMAD R2, R3, R4, R5 ;      /* 0x0000000403027224 */
        /*0020*/                   LEA.HI R2, R2, R6, RZ, 0x10 ; /* 0x0 */
        /*0030*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ; /* 0x0 */
        /*0040*/               @P0 BRA 0x10 ;                 /* 0x0 */
        /*0050*/                   EXIT ;                     /* 0x0 */
        /*0060*/                   BRA 0x60;                  /* 0x0 */
        /*0070*/                   NOP;                       /* 0x0 */
		Function : k_line
        /*0000*/                   IADD3 R0, R1, R2, R3 ;     /* 0x0 */
        /*0010*/               @!P0 EXIT ;                    /* 0x0 */
        /*0020*/                   LOP3.LUT R0, R0, 0xffff, RZ, 0xc0, !PT ; /* 0x0 */
        /*0030*/                   EXIT ;                     /* 0x0 */
        /*0040*/                   BRA 0x40;                  /* 0x0 */
		Function : k_call
        /*0000*/                   CALL.REL.NOINC 0x40 ;      /* 0x0 */
        /*0010*/                   EXIT ;                     /* 0x0 */
"""


def test_sass_listing_parse():
    """``cuobjdump -sass`` text -> instructions without NOPs and the
    trailing branch to itself; loops from their backward branches;
    straight-line code has no branch and no call."""
    code = build.parse_sass(_SASS)
    assert [len(code[f]) for f in ("k_loop", "k_line", "k_call")] == [6, 4, 2]
    assert build.opcode(code["k_loop"][4][1]) == "BRA"
    assert build.loop_bodies(code["k_loop"]) == [[
        "IMAD R2, R3, R4, R5", "LEA.HI R2, R2, R6, RZ, 0x10",
        "ISETP.NE.AND P0, PT, R2, RZ, PT", "@P0 BRA 0x10"]]
    assert build.loop_bodies(code["k_line"]) == []
    assert [build.straight_line(code[f])
            for f in ("k_loop", "k_line", "k_call")] == [False, True, False]


_SASS_PATHS = """
		Function : k_fork
        /*0000*/                   IADD3 R0, R1, R2, R3 ;     /* 0x0 */
        /*0010*/               @P0 BRA 0x40 ;                 /* 0x0 */
        /*0020*/                   IMAD R0, R0, R0, RZ ;      /* 0x0 */
        /*0030*/                   BRA 0x50 ;                 /* 0x0 */
        /*0040*/                   LOP3.LUT R0, R0, 0xffff, RZ, 0xc0, !PT ; /* 0x0 */
        /*0050*/                   STG.E [R2.64], R0 ;        /* 0x0 */
        /*0060*/                   EXIT ;                     /* 0x0 */
        /*0070*/                   BRA 0x70;                  /* 0x0 */
"""


def test_least_path_through_the_code():
    """The fewest instructions issued from entry to an EXIT: either side
    of a predicated branch, an unconditional branch always, a predicated
    EXIT ends a path, a loop's body once; a call has no such count."""
    code = build.parse_sass(_SASS + _SASS_PATHS)
    assert build.least_path(code["k_fork"]) == 5   # via 0x40: 0, 10, 40, 50, 60
    assert build.least_path(code["k_line"]) == 2   # IADD3, @!P0 EXIT
    assert build.least_path(code["k_loop"]) == 6   # the loop once, EXIT
    with pytest.raises(ValueError):
        build.least_path(code["k_call"])
