"""The CUDA kernels of eges_tpu_torch against their plain PyTorch versions
on the card, bit for bit (the arithmetic is integer: tolerance 0), and
the recovery, classic-verify and keccak paths end to end against the
host model, the stacked (un-fused) windows also against the fused path
on the same rows, and the paths under the reference's TPU-tiling
configuration against the default one.

Marked ``gpu``; run on a machine with a card as
``python -m pytest tests/test_torch_cuda.py -m gpu``.  Without a card
each test skips with its reason.
"""

import json
import os

import numpy as np
import pytest
import torch

from eges_tpu_torch import testing as tt
from eges_tpu_torch.ops import build, kernels as K
from eges_tpu_torch.ops.bigint import N, P

pytestmark = pytest.mark.gpu

B = 300  # not a multiple of 256: exercises the ragged edge and Bpad


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def _limbs(rng, n, bound=1 << 256):
    return tt.limb_rows(tt.field_values(rng, n, bound))


def test_build_reports_every_kernel(dev):
    info = build.build()
    lanes = {f"k_{k}_t{t}" for k in ("pow_p", "pow_n", "strauss",
                                     "point_table", "glv_digits", "fp_mul",
                                     "recover_finish", "recover_prelude",
                                     "u1u2", "y_fix", "keccak_rows")
             for t in K.LANES}
    assert set(info["ptxas"]) >= lanes | {
        "k_fp_canon", "k_fn_mul",
        "k_fn_red17", "k_fp_add", "k_keccak_block", "k_fp_sub", "k_fp_neg",
        "k_fp_mul_small", "k_fn_sub", "k_fn_neg", "k_mulhi8", "k_pow_rows8_p",
        "k_pow_rows8_n", "k_strauss_rows8", "k_keccak_round",
        "k_fp_mul_chain", "k_fp_mul_chain_rows8", "k_fp_mul_rows8",
        "k_add_one_f32", "k_mul_scalar_f32"}


def test_fp_mul_and_canon(dev):
    rng = np.random.default_rng(11)
    a = K.from_reference(_limbs(rng, B), dev)
    b = K.from_reference(_limbs(rng, B)[::-1].copy(), dev)
    _same(K.fp_mul_pallas(a, b), K.fp_mul_plain(a, b))
    _same(K.fp_canon_pallas(a), K.fp_canon_plain(a))


@pytest.mark.parametrize("e,mod", [((P + 1) // 4, "p"), (P - 2, "p"),
                                   (N - 2, "n")])
def test_pow_mod(dev, e, mod):
    rng = np.random.default_rng(12)
    bound = N if mod == "n" else 1 << 256
    a = K.from_reference(_limbs(rng, 64, bound), dev)
    _same(K.pow_mod_pallas(a, e, mod), K.pow_mod_plain(a, e, mod))


def _lane_rows(lanes, threads, most):
    """The ragged row counts of one instance: 1, T - 1, 33, one past a
    block's rows, 8192 and ``most``."""
    return sorted({1, max(lanes - 1, 1), 33, threads // lanes + 1, 8192,
                   most})


def test_strauss_every_lane_instance(dev):
    """Every (lanes, threads) instance of the ladder against the plain
    version, bit for bit, on rows that take the doubling path, meet
    opposite points and skip zero digits beside random ones."""
    rng = np.random.default_rng(21)
    ins = [K.from_reference(t, dev)
           for t in tt.ladder_inputs(rng, 8192, K.bpad(8192))]
    want = K.strauss_tab_plain(*ins, 8192)
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, 8192):
                got = K.strauss_tab_lanes(*ins, rows, lanes, threads)
                _same(got, tuple(w[:rows] for w in want))


@pytest.mark.parametrize("e,mod", [((P + 1) // 4, "p"), (P - 2, "p"),
                                   (N - 2, "n")])
def test_pow_every_lane_instance(dev, e, mod):
    """Every (lanes, threads) instance of the pow against the plain
    version, bit for bit, up to the table's 131072 rows."""
    rng = np.random.default_rng(22)
    M = 131072
    a = rng.integers(0, 1 << 16, (M, 16)).astype(np.uint32)
    if mod == "n":
        a[:, 15] &= 0x7FFF
    bound = N if mod == "n" else 1 << 256
    a[:8] = _limbs(rng, 8, bound)
    a = K.from_reference(a, dev)
    want = K.pow_mod_plain(a, e, mod)
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, M):
                _same(K.pow_mod_lanes(a[:rows], e, mod, lanes, threads),
                      want[:rows])


def test_point_table_every_lane_instance(dev):
    """Every (lanes, threads) instance of the point table against the
    plain version, bit for bit, on rows of every class of
    ``testing.table_points`` side by side (curve points, zero rows, the
    pad row x = 0 and values off the curve: groups of one warp that take
    the add's doubling beside groups that take its sum)."""
    rng = np.random.default_rng(23)
    px, py = (K.from_reference(t, dev) for t in tt.table_points(rng, 8192))
    want = K.point_table_plain(px, py)
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, 8192):
                got = K.point_table_lanes(px[:rows], py[:rows], lanes,
                                          threads)
                _same(got, tuple(w[:, :rows] for w in want))


def test_fp_mul_every_lane_instance_on_any_view(dev):
    """Every (lanes, threads) instance of fp_mul against the plain version,
    bit for bit, at ragged row counts up to 131072, and on views 4, 8 and
    12 bytes off a 16-byte boundary as either operand (the word path):
    no copy, no fallback, one launch a call."""
    rng = np.random.default_rng(29)
    M = 131072
    a = K.from_reference(rng.integers(0, 1 << 16, (M, 16)).astype(
        np.uint32), dev)
    a[:8] = K.from_reference(_limbs(rng, 8), dev)
    a[8] = 0xFFFF
    b = a.flip(0).contiguous()
    want = K.fp_mul_plain(a, b)
    views = []
    for off in (1, 2, 3):
        buf = torch.empty(16 * 4097 + off, dtype=torch.int32, device=dev)
        views.append(buf[off:].view(4097, 16))
        views[-1].copy_(a[:4097])
    K.reset_launches()
    calls = 0
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, M):
                _same(K.fp_mul_lanes(a[:rows], b[:rows], lanes, threads),
                      want[:rows])
                calls += 1
            for v in views:
                _same(K.fp_mul_lanes(v, b[:4097], lanes, threads),
                      want[:4097])
                _same(K.fp_mul_lanes(b[:4097], v, lanes, threads),
                      K.fp_mul_plain(b[:4097], v))
                calls += 2
    assert K.LAUNCHES["fp_mul"] == calls


def test_glv_digits_every_lane_instance(dev):
    """Every (lanes, threads) instance of the GLV split against the plain
    version, bit for bit (all Bpad columns of the digits and signs, rows
    4-7 written as zeros by the kernel), on the edge scalars and seeded
    ones at ragged batches, each launch right after a block of -1 words
    went back to the allocator's cache (a word the kernel missed shows)."""
    rng = np.random.default_rng(31)
    B = 8192
    u1 = K.from_reference(tt.limb_rows(tt.glv_scalars(rng, B)), dev)
    u2 = u1.flip(0).contiguous()
    junk = None
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, B):
                # freed to the cache, so the outputs likely reuse it
                del junk
                junk = torch.full((1 << 22,), -1, dtype=torch.int32,
                                  device=dev)
                _same(K.glv_digits_lanes(u1[:rows], u2[:rows], lanes,
                                         threads),
                      K.glv_digits_plain(u1[:rows], u2[:rows]))


def test_fp_canon_every_block_on_any_view(dev):
    """Every block size of fp_canon against the plain version, bit for
    bit, on values in [P, 2^256) and below, at ragged row counts up to
    131072 and on views 4, 8 and 12 bytes off a 16-byte boundary (the
    word path): no copy, no fallback, one launch a call."""
    rng = np.random.default_rng(32)
    M = 131072
    a = K.from_reference(tt.limb_rows(tt.canon_values(rng, M)), dev)
    want = K.fp_canon_plain(a)
    views = []
    for off in (1, 2, 3):
        buf = torch.empty(16 * 4097 + off, dtype=torch.int32, device=dev)
        views.append(buf[off:].view(4097, 16))
        views[-1].copy_(a[:4097])
    K.reset_launches()
    calls = 0
    for threads in K.LANE_THREADS:
        for rows in _lane_rows(1, threads, M):
            _same(K.fp_canon_lanes(a[:rows], 1, threads), want[:rows])
            calls += 1
        for v in views:
            _same(K.fp_canon_lanes(v, 1, threads), want[:4097])
            calls += 1
    _same(K.fp_canon_pallas(views[0]), want[:4097])
    assert K.LAUNCHES["fp_canon"] == calls + 1


def test_finish_every_lane_instance(dev):
    """Every (lanes, threads) instance of the finish against the plain
    version, bit for bit (qx, qy, ok and all Bpad columns of the words),
    on rows with points at infinity and dropped oks, at ragged batches."""
    rng = np.random.default_rng(30)
    B = 8192
    X, Y, Z, zi = (K.from_reference(_limbs(rng, B), dev) for _ in range(4))
    Z[::97] = 0
    ok = K.from_reference(rng.integers(0, 2, B).astype(np.uint32), dev)
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, 300):
                ins = tuple(t[:rows] for t in (X, Y, Z, zi, ok))
                _same(K.recover_finish_lanes(*ins, lanes, threads),
                      K.recover_finish_plain(*ins))


def _prelude_layouts(sigs, hashes, dev):
    """The rows at pitches 65, 66, 70 and 256 (0xAB past byte 65) and 1,
    4 and 8 bytes into a buffer, the hashes also 3 bytes off."""
    out = []
    for pitch, off, hoff in ((65, 0, 0), (66, 0, 0), (70, 0, 3), (256, 0, 0),
                             (65, 1, 0), (65, 4, 0), (65, 8, 3)):
        hb = torch.empty(32 * len(sigs) + hoff, dtype=torch.uint8,
                         device=dev)
        hv = hb[hoff:].view(len(sigs), 32)
        hv.copy_(hashes)
        out.append((tt.pitched_rows(sigs, pitch, off), hv))
    return out


def test_prelude_every_lane_instance_on_any_layout(dev):
    """Every (lanes, threads) instance of the prelude against the plain
    version, bit for bit, on every class of its checks
    (``testing.prelude_rows``) at ragged batches, and at pitches 66, 70
    and 256 and on bases 1, 4 and 8 bytes off: no copy, no fallback, one
    launch a call."""
    rng = np.random.default_rng(33)
    B = 8192
    sigs, hashes = (torch.from_numpy(a).to(dev)
                    for a in tt.prelude_rows(rng, B))
    want = K.recover_prelude_plain(sigs, hashes)
    layouts = _prelude_layouts(sigs[:4097], hashes[:4097], dev)
    K.reset_launches()
    calls = 0
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, B):
                _same(K.recover_prelude_lanes(sigs[:rows], hashes[:rows],
                                              lanes, threads),
                      tuple(w[:rows] for w in want))
                calls += 1
            for v, h in layouts:
                _same(K.recover_prelude_lanes(v, h, lanes, threads),
                      tuple(w[:4097] for w in want))
                calls += 1
    assert K.LAUNCHES["recover_prelude"] == calls


def test_u1u2_every_lane_instance_on_any_view(dev):
    """Every (lanes, threads) instance of u1u2 against the plain version,
    bit for bit, with r^-1 = 0 rows (u1 = u2 = 0), at ragged batches, and
    with z, s or r^-1 as a ragged view 4, 8 or 12 bytes off a 16-byte
    boundary (the word path)."""
    rng = np.random.default_rng(34)
    B = 8192
    z = K.from_reference(_limbs(rng, B), dev)
    s, ri = (K.from_reference(_limbs(rng, B, N), dev) for _ in range(2))
    ri[::7] = 0
    want = K.u1u2_plain(z, s, ri)
    views = []
    for off, t in zip((1, 2, 3), (z, s, ri)):
        buf = torch.empty(16 * 4097 + off, dtype=torch.int32, device=dev)
        views.append(buf[off:].view(4097, 16))
        views[-1].copy_(t[:4097])
    sets = [(views[0], s[:4097], ri[:4097]), (z[:4097], views[1], ri[:4097]),
            (z[:4097], s[:4097], views[2])]
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, B):
                _same(K.u1u2_lanes(z[:rows], s[:rows], ri[:rows], lanes,
                                   threads),
                      tuple(w[:rows] for w in want))
            for ins in sets:
                _same(K.u1u2_lanes(*ins, lanes, threads),
                      tuple(w[:4097] for w in want))


def test_y_fix_every_lane_instance_on_any_view(dev):
    """Every (lanes, threads) instance of y_fix against the plain version,
    bit for bit, on roots that are P and y^2 that are the root's square
    beside random ones, at ragged batches, and with root or y^2 as a
    ragged view 4, 8 or 12 bytes off a 16-byte boundary (the word
    path)."""
    rng = np.random.default_rng(36)
    B = 8192
    root = K.from_reference(_limbs(rng, B), dev)
    root[::9] = K.from_reference(tt.limb_rows([P]), dev)
    y_sq = K.from_reference(_limbs(rng, B), dev)
    y_sq[::2] = K.fp_mul_plain(root, root)[::2]
    v = K.from_reference(rng.integers(0, 6, B).astype(np.uint32), dev)
    want = K.y_fix_plain(root, y_sq, v)
    assert 0 < int(want[1].sum()) < B
    views = []
    for off, t in zip((1, 2, 3), (root, y_sq, root)):
        buf = torch.empty(16 * 4097 + off, dtype=torch.int32, device=dev)
        views.append(buf[off:].view(4097, 16))
        views[-1].copy_(t[:4097])
    sets = [(views[0], y_sq[:4097]), (root[:4097], views[1]),
            (views[2], views[1])]
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for rows in _lane_rows(lanes, threads, B):
                _same(K.y_fix_lanes(root[:rows], y_sq[:rows], v[:rows],
                                    lanes, threads),
                      tuple(w[:rows] for w in want))
            for ins in sets:
                _same(K.y_fix_lanes(*ins, v[:4097], lanes, threads),
                      tuple(w[:4097] for w in want))


def test_keccak_rows_every_lane_instance(dev):
    """Every (lanes, threads) instance of keccak_rows against the plain
    version, bit for bit, at column counts that are no multiple of any
    block, up to 8192, on random blocks and blocks of all zero and all
    one bits."""
    rng = np.random.default_rng(37)
    wide = 8192
    words = K.from_reference(rng.integers(
        0, 1 << 32, (34, wide), dtype=np.uint64).astype(np.uint32), dev)
    words[:, 0], words[:, 1] = 0, -1
    for lanes in K.LANES:
        for threads in K.LANE_THREADS:
            for cols in _lane_rows(lanes, threads, wide) + [300]:
                w = words[:, :cols].contiguous()
                _same(K.keccak_rows_lanes(w, lanes, threads),
                      K.keccak_rows_plain(w))


def test_empty_batches_on_card(dev):
    """C5 on the card: ``[0, 65]`` recovery and ``[0, 64]``/``[0, 65]``
    verify batches give empty outputs on the card and launch nothing."""
    from eges_tpu_torch.crypto.verifier import ecrecover_batch, verify_batch

    K.reset_launches()
    z = {w: torch.zeros(0, w, dtype=torch.uint8, device=dev)
         for w in (32, 64, 65)}
    got = ecrecover_batch(z[65], z[32])
    assert [tuple(g.shape) for g in got] == [(0, 20), (0, 64), (0,)]
    assert all(g.device.type == "cuda" for g in got)
    for w in (64, 65):
        ok = verify_batch(z[w], z[32], z[64])
        assert ok.shape == (0,) and ok.dtype == torch.int32
        assert ok.device.type == "cuda"
    assert sum(K.LAUNCHES.values()) == 0


def test_ecrecover_batch_wide_and_int_rows_on_card(dev):
    """C4 on the card: the rows 66 and 70 bytes wide and as int32 and
    int64 give the ``[N, 65]`` uint8 bytes, through the fused path."""
    from eges_tpu_torch.crypto.verifier import ecrecover_batch

    rng = np.random.default_rng(35)
    sigs, hashes, _ = tt.recover_class_rows(rng, 8)
    s, h = (torch.from_numpy(a).to(dev) for a in (sigs, hashes))
    want = ecrecover_batch(s, h)
    assert want[2].sum() > 0
    cases = [(torch.cat([s, torch.full((len(sigs), w - 65), 0xAB,
                                       dtype=torch.uint8, device=dev)], 1), h)
             for w in (66, 70)]
    cases += [(s.to(dt), h.to(dt)) for dt in (torch.int32, torch.int64)]
    for args in cases:
        _same(ecrecover_batch(*args), want)


def test_lanes_rule_launches_clean_instances(dev):
    """The instances lanes_for picks build with no stack frame and no
    spill."""
    ptxas = build.build()["ptxas"]
    for kernel, rule in K.LANES_RULE.items():
        name = {"strauss_tab": "k_strauss_t", "pow_mod_p": "k_pow_p_t",
                "pow_mod_n": "k_pow_n_t", "point_table": "k_point_table_t",
                "glv_digits": "k_glv_digits_t", "fp_mul": "k_fp_mul_t",
                "fp_canon": "k_fp_canon",
                "recover_finish": "k_recover_finish_t",
                "recover_prelude": "k_recover_prelude_t",
                "u1u2": "k_u1u2_t", "y_fix": "k_y_fix_t",
                "keccak_rows": "k_keccak_rows_t"}[kernel]
        for _, lanes, _ in rule:
            rec = ptxas[name + ("" if kernel == "fp_canon" else str(lanes))]
            assert rec["stack_bytes"] == rec["spill_store_bytes"] == 0, rec


def test_prelude_y_fix_u1u2(dev):
    rng = np.random.default_rng(13)
    sigs = torch.from_numpy(rng.integers(0, 256, (B, 65), dtype=np.uint8))
    sigs[:, 64] = torch.from_numpy(rng.integers(0, 6, B).astype(np.uint8))
    hashes = torch.from_numpy(rng.integers(0, 256, (B, 32), dtype=np.uint8))
    sigs, hashes = sigs.to(dev), hashes.to(dev)
    for lanes in K.LANES:
        _same(K.recover_prelude_lanes(sigs, hashes, lanes, 128),
              K.recover_prelude_plain(sigs, hashes))
    _same(K.recover_prelude_pallas(sigs, hashes),
          K.recover_prelude_plain(sigs, hashes))
    a = K.from_reference(_limbs(rng, B), dev)
    b = K.from_reference(_limbs(rng, B), dev)
    v = K.from_reference(rng.integers(0, 4, B).astype(np.uint32), dev)
    _same(K.y_fix_pallas(a, b, v), K.y_fix_plain(a, b, v))
    n1 = K.from_reference(_limbs(rng, B, N), dev)
    n2 = K.from_reference(_limbs(rng, B, N), dev)
    for lanes in K.LANES:
        _same(K.u1u2_lanes(a, n1, n2, lanes, 128),
              K.u1u2_plain(a, n1, n2))
    _same(K.u1u2_pallas(a, n1, n2), K.u1u2_plain(a, n1, n2))
    _same(K.glv_digits_pallas(n1, n2), K.glv_digits_plain(n1, n2))


def test_point_table_strauss_finish_keccak(dev):
    rng = np.random.default_rng(14)
    px, py = (K.from_reference(t, dev) for t in tt.curve_points(rng, 40))
    _same(K.point_table_pallas(px, py), K.point_table_plain(px, py))
    wide = K.bpad(40)
    dig = K.from_reference(rng.integers(0, 16, (33, 8, wide)).astype(
        np.uint32), dev)
    neg = K.from_reference(rng.integers(0, 2, (8, wide)).astype(np.uint32),
                           dev)
    tabs = [K.from_reference(rng.integers(0, 1 << 16, (256, wide)).astype(
        np.uint32), dev) for _ in range(3)]
    _same(K.strauss_tab(dig, neg, *tabs, 40),
          K.strauss_tab_plain(dig, neg, *tabs, 40))
    X, Y, Z, zi = (K.from_reference(_limbs(rng, B), dev) for _ in range(4))
    ok = K.from_reference(rng.integers(0, 2, B).astype(np.uint32), dev)
    _same(K.recover_finish_pallas(X, Y, Z, zi, ok),
          K.recover_finish_plain(X, Y, Z, zi, ok))
    words = K.from_reference(rng.integers(0, 1 << 32, (34, 512),
                                          dtype=np.uint64).astype(np.uint32),
                             dev)
    _same(K.keccak_rows_pallas(words), K.keccak_rows_plain(words))


def test_recover_addresses_on_card(dev):
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    rng = np.random.default_rng(15)
    sigs, hashes, addrs = tt.signed_rows(rng, 8)
    hs, hh = tt.high_x_rows(rng, 2)
    bad_s, bad_h = tt.invalid_rows(rng, sigs[0], hashes[0])
    sigs = np.concatenate([sigs, hs, bad_s])
    hashes = np.concatenate([hashes, hh, bad_h])
    K.reset_launches()
    got, ok = BatchVerifier().recover_addresses(sigs, hashes)
    assert sum(K.LAUNCHES.values()) == 18
    for i in range(len(sigs)):
        want = tt.host_recover(sigs[i], hashes[i])
        if want is None:
            assert not ok[i]
        else:
            assert ok[i] and bytes(got[i]) == want[0]
    assert all(bytes(got[i]) == addrs[i] for i in range(8))


def test_fn_mul_fn_red17_fp_add(dev):
    rng = np.random.default_rng(16)
    a = K.from_reference(_limbs(rng, B), dev)
    b = K.from_reference(_limbs(rng, B)[::-1].copy(), dev)
    _same(K.fn_mul_pallas(a, b), K.fn_mul_plain(a, b))
    _same(K.fp_add_pallas(a, b), K.fp_add_plain(a, b))
    cols = rng.integers(0, 1 << 16, (B, 17)).astype(np.uint32)
    cols[0] = 0xFFFF
    cols[1, 16] = 0
    c = K.from_reference(cols, dev)
    _same(K.fn_red17_pallas(c), K.fn_red17_plain(c))


def test_keccak_block_ragged(dev):
    rng = np.random.default_rng(17)
    for rows in (1, 127, 129, B):
        w = K.from_reference(rng.integers(0, 1 << 32, (rows, 34),
                                          dtype=np.uint64).astype(np.uint32),
                             dev)
        _same(K.keccak_block_pallas(w), K.keccak_block_plain(w))


def test_keccak256_fixed_on_card(dev):
    from eges_tpu_torch.crypto.keccak import keccak256
    from eges_tpu_torch.ops.keccak import keccak256_fixed

    rng = np.random.default_rng(18)
    for length in (0, 64, 110, 135, 136, 200):
        msgs = rng.integers(0, 256, (130, length), dtype=np.uint8)
        K.reset_launches()
        got = keccak256_fixed(torch.from_numpy(msgs).to(dev)).cpu().numpy()
        assert K.LAUNCHES["keccak_block"] == (1 if length < 136 else 0)
        for i in range(len(msgs)):
            assert bytes(got[i]) == keccak256(bytes(msgs[i]))


def test_verify_on_card(dev):
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    sigs, hashes, pubs, kinds = tt.verify_rows(np.random.default_rng(19), 4)
    K.reset_launches()
    ok = BatchVerifier().verify(sigs, hashes, pubs)
    assert sum(K.LAUNCHES.values()) == 26
    for i, kind in enumerate(kinds):
        assert bool(ok[i]) == tt.host_verify(sigs[i], hashes[i], pubs[i]), kind
    np.testing.assert_array_equal(
        BatchVerifier().verify(sigs[:, :64].copy(), hashes, pubs), ok)


def test_glue_kernels(dev):
    from eges_tpu_torch.ops.curve import _G_G1, _G_G2

    rng = np.random.default_rng(20)
    a = K.from_reference(_limbs(rng, B), dev)
    b = K.from_reference(_limbs(rng, B)[::-1].copy(), dev)
    n1 = K.from_reference(_limbs(rng, B, N), dev)
    n2 = K.from_reference(_limbs(rng, B, N)[::-1].copy(), dev)
    _same(K.fp_sub_pallas(a, b), K.fp_sub_plain(a, b))
    _same(K.fp_neg_pallas(a), K.fp_neg_plain(a))
    for k in (0, 2, 3, 4, 8, 15):
        _same(K.fp_mul_small_pallas(a, k), K.fp_mul_small_plain(a, k))
    _same(K.fn_sub_pallas(n1, n2), K.fn_sub_plain(n1, n2))
    _same(K.fn_sub_pallas(n1, n1), K.fn_sub_plain(n1, n1))
    _same(K.fn_neg_pallas(n1), K.fn_neg_plain(n1))
    for g in (_G_G1, _G_G2):
        _same(K.mulhi8_pallas(n1, g), K.mulhi8_plain(n1, g))


def test_stacked_paths_on_card(dev):
    """A stacked recovery and a stacked verify window: launches as
    pinned, results equal to the fused path on the same rows flattened
    and to the host model."""
    from eges_tpu_torch.crypto.verifier import ecrecover_batch, verify_batch

    sigs, hashes, _ = tt.recover_class_rows(np.random.default_rng(21))
    s, h = (torch.from_numpy(x).to(dev) for x in (sigs, hashes))
    K.reset_launches()
    got = ecrecover_batch(s.reshape(2, 5, 65), h.reshape(2, 5, 32))
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == \
        tt.UNFUSED_RECOVER_LAUNCHES
    for g, f in zip(got, ecrecover_batch(s, h)):
        assert torch.equal(g.reshape(10, *g.shape[2:]), f)
    addrs, pubs, ok = (t.reshape(10, -1).cpu().numpy() for t in got)
    for i in range(10):
        want = tt.host_recover(sigs[i], hashes[i])
        if want is None:
            assert not ok[i, 0] and not addrs[i].any() and not pubs[i].any()
        else:
            assert ok[i, 0] and (bytes(addrs[i]), bytes(pubs[i])) == want

    rows = tt.verify_rows(np.random.default_rng(22), 1)
    flat = [torch.from_numpy(x).to(dev) for x in rows[:3]]
    K.reset_launches()
    ok = verify_batch(*(t.reshape(3, 5, -1) for t in flat))
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == \
        tt.UNFUSED_VERIFY_LAUNCHES
    assert torch.equal(ok.reshape(15), verify_batch(*flat))
    assert [bool(v) for v in ok.reshape(15).cpu()] == [
        tt.host_verify(*r) for r in zip(*rows[:3])]


def test_tiling_kernels(dev):
    """The three tiling kernels against their plain versions on the same
    tiles, at ragged row counts (the tiles' padding rows zero), and the
    rows8 wrappers against the default-layout kernels."""
    rng = np.random.default_rng(23)
    for e, mod, rows in (((P + 1) // 4, "p", 1030), (N - 2, "n", 1),
                         (P - 2, "p", 2048)):
        a = K.from_reference(_limbs(rng, rows, N if mod == "n" else 1 << 256),
                             dev)
        at = K.to_rows8(K.pad_rows8(a)[0])
        _same(K.pow_rows8_tiles(at, e, mod, rows),
              K.pow_mod_rows8_plain(at, e, mod, rows))
        _same(K.pow_mod_rows8(a, e, mod), K.pow_mod_pallas(a, e, mod))
    wide, batch = 1024, 1000
    dig = torch.from_numpy(rng.integers(0, 16, (33, 8, wide)).astype(
        np.int32)).to(dev)
    neg = torch.from_numpy(rng.integers(0, 2, (8, wide)).astype(
        np.int32)).to(dev)
    tabs = [K.from_reference(rng.integers(0, 1 << 16, (256, wide)).astype(
        np.uint32), dev) for _ in range(3)]
    laid = (K.lay_digits_rows8(dig), K.lay_rows8(neg),
            *(K.lay_rows8(t) for t in tabs))
    _same(K.strauss_rows8_tiles(*laid, batch),
          K.strauss_tab_rows8_plain(*laid, batch))
    _same(K.strauss_tab_rows8(dig, neg, *tabs, batch),
          K.strauss_tab(dig, neg, *tabs, batch))
    for cols in (1, 301, 1024):
        words = K.from_reference(rng.integers(0, 1 << 32, (34, cols),
                                              dtype=np.uint64).astype(
            np.uint32), dev)
        _same(K.keccak_rows_grid(words), K.keccak_rows_grid_plain(words))
    with pytest.raises(ValueError):
        K.strauss_tab_rows8(dig[..., :512].contiguous(),
                            neg[:, :512].contiguous(),
                            *(t[:, :512].contiguous() for t in tabs), 10)


def test_tiling_paths_on_card(dev):
    """Recovery, verify and keccak under the tiling configuration: the
    launches pinned for it, results equal to the default configuration
    and the host model."""
    from eges_tpu_torch.crypto.keccak import keccak256
    from eges_tpu_torch.crypto.verifier import BatchVerifier
    from eges_tpu_torch.ops.keccak import keccak256_fixed

    sigs, hashes, _ = tt.recover_class_rows(np.random.default_rng(24))
    vrows = tt.verify_rows(np.random.default_rng(25), 4)
    msgs = torch.from_numpy(np.random.default_rng(26).integers(
        0, 256, (300, 110), dtype=np.uint8)).to(dev)
    verifier = BatchVerifier()
    want = (verifier.recover_addresses(sigs, hashes),
            verifier.verify(*vrows[:3]), keccak256_fixed(msgs))
    with tt.tiling_config():
        K.reset_launches()
        rec = verifier.recover_addresses(sigs, hashes)
        assert {k: v for k, v in K.LAUNCHES.items() if v} == \
            tt.TILING_RECOVER_LAUNCHES
        K.reset_launches()
        ok = verifier.verify(*vrows[:3])
        assert {k: v for k, v in K.LAUNCHES.items() if v} == \
            tt.TILING_VERIFY_LAUNCHES
        K.reset_launches()
        digests = keccak256_fixed(msgs)
        torch.cuda.synchronize()
        assert {k: v for k, v in K.LAUNCHES.items() if v} == {
            "keccak_rows_grid": 1}
    for g, w in zip(rec, want[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ok, want[1])
    assert torch.equal(digests, want[2])
    for i in range(len(sigs)):
        ans = tt.host_recover(sigs[i], hashes[i])
        assert bool(rec[1][i]) == (ans is not None)
    assert [bool(v) for v in ok] == [tt.host_verify(*r)
                                     for r in zip(*vrows[:3])]
    got = digests.cpu().numpy()
    for i, m in enumerate(msgs.cpu().numpy()):
        assert bytes(got[i]) == keccak256(bytes(m))


def test_profile_kernels(dev):
    """The harness's four kernels against their plain versions on the
    same tensors: the 1-D chain at lane blocks of 128, 256 and 1024 (a
    ragged 4096 + 128 columns at 128), the rows8 chain and one rows8
    product on two tiles, the copy kernel on one (8, 128) tile; and the
    launches counted once each."""
    rng = np.random.default_rng(27)

    def limbs(shape):
        return torch.from_numpy(rng.integers(0, 1 << 16, shape).astype(
            np.int32)).to(dev)

    K.reset_launches()
    for wide, lane in ((4096 + 128, 128), (1024, 256), (2048, 1024)):
        a, b = limbs((16, wide)), limbs((16, wide))
        _same(K.fp_mul_chain_pallas(a, b, 64, lane),
              K.fp_mul_chain_plain(a, b, 64))
    at, bt = limbs((2, 128, 128)), limbs((2, 128, 128))
    _same(K.fp_mul_chain_rows8(at, bt), K.fp_mul_chain_rows8_plain(at, bt))
    _same(K.fp_mul_rows8(at, bt), K.fp_mul_rows8_plain(at, bt))
    _same(K.from_rows8(K.fp_mul_rows8(at, bt), 2048),
          K.fp_mul_pallas(K.from_rows8(at, 2048), K.from_rows8(bt, 2048)))
    x = torch.from_numpy(rng.standard_normal((8, 128), dtype=np.float32)).to(
        dev)
    _same(K.add_one_f32(x), K.add_one_f32_plain(x))
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "fp_mul_chain": 3, "fp_mul_chain_rows8": 1, "fp_mul_rows8": 2,
        "add_one_f32": 1, "fp_mul": 1}


def test_mul_scalar_f32(dev):
    """#21 against its plain version, bit for bit, at the floor's (8, 128)
    tile and at a ragged 2^20 + 3 elements, with a clock-sized scalar
    (rounded to float32 once on the host, as both versions do) and with
    extreme elements (zeros of both signs, overflow to infinity)."""
    rng = np.random.default_rng(21)
    K.reset_launches()
    for shape in ((8, 128), ((1 << 20) + 3,)):
        x = rng.standard_normal(shape, dtype=np.float32).reshape(-1)
        x[:5] = (0.0, -0.0, 3e38, -1e-30, 2.0**24)
        x = torch.from_numpy(x.reshape(shape)).to(dev)
        for s in (1760000000.123456, -0.1, 3.0):
            got, want = K.mul_scalar_f32(x, s), K.mul_scalar_f32_plain(x, s)
            assert got.dtype == want.dtype == torch.float32
            _same(got.view(torch.int32), want.view(torch.int32))
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "mul_scalar_f32": 6}


def test_mul_scalar_f32_any_view(dev):
    """#21 bit for bit on views that start 4, 8 and 12 bytes past a
    16-byte boundary, on 1, 3, 5 and 4k + 3 elements, on the (8, 128)
    tile and on 2^24 elements with the special values; the output shares
    the input's offset mod 16 bytes, and nothing falls back."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal(1 << 24, dtype=np.float32)
    x[:5] = (0.0, -0.0, 3e38, -1e-30, 2.0**24)
    flat = torch.from_numpy(x).to(dev)
    s = 1760000000.123456
    views = [flat[1:], flat[2:-1], flat[3:-2], flat[1:2], flat[:3],
             flat[1:6], flat[5:5 + 4 * 1000 + 3], flat[:1024].view(8, 128),
             flat]
    K.reset_launches()
    for v in views:
        got = K.mul_scalar_f32(v, s)
        assert got.data_ptr() % 16 == v.data_ptr() % 16
        _same(got.view(torch.int32),
              K.mul_scalar_f32_plain(v, s).view(torch.int32))
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "mul_scalar_f32": len(views)}


@pytest.mark.parametrize("call", [
    lambda a, t, x: K.fp_mul_chain_pallas(a[:, :4000].contiguous(),
                                          a[:, :4000].contiguous()),
    lambda a, t, x: K.fp_mul_chain_pallas(a, a, 64, 2048),
    lambda a, t, x: K.fp_mul_chain_pallas(a, a[:15].contiguous()),
    lambda a, t, x: K.fp_mul_chain_pallas(a, a.T),
    lambda a, t, x: K.fp_mul_chain_rows8(t, t[:, :64].contiguous()),
    lambda a, t, x: K.fp_mul_rows8(t, t[:1]),
    lambda a, t, x: K.fp_mul_rows8(t, t.cpu()),
    lambda a, t, x: K.add_one_f32(x.double()),
    lambda a, t, x: K.add_one_f32(x.T),
    lambda a, t, x: K.mul_scalar_f32(x.double(), 2.0),
    lambda a, t, x: K.mul_scalar_f32(x.T, 2.0),
    lambda a, t, x: K.mul_scalar_f32(x.int(), 2.0),
    lambda a, t, x: K.point_table_lanes(a[:, :16], a[:, :16], 4, 96),
])
def test_profile_wrappers_raise_on_card(dev, call):
    """Misshapen input on the card raises; no wrapper falls back to its
    plain version."""
    a = torch.zeros(16, 4096, dtype=torch.int32, device=dev)
    t = torch.zeros(2, 128, 128, dtype=torch.int32, device=dev)
    x = torch.zeros(8, 128, dtype=torch.float32, device=dev)
    K.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        call(a, t, x)
    assert not any(K.LAUNCHES.values())


def test_profile_window_sessions_back_to_back(dev):
    """Two profiler sessions in a row (the second after the first's
    events were read) each record every launch of their window, and a
    cold event time covers the kernel."""
    from eges_tpu_torch.harness import profutil

    rng = np.random.default_rng(28)
    a = K.from_reference(_limbs(rng, 4096), dev)
    for _ in range(2):
        events, wall = profutil.profile_window(
            lambda: K.fp_mul_pallas(a, a), reps=3, device=dev)
        lanes = K.lanes_for("fp_mul", 4096)[0]
        assert [n for n, _ in events
                if n.startswith("k_")] == [f"k_fp_mul_t{lanes}"] * 3
        assert wall > 0
    cold = profutil.cuda_event_ms(lambda: K.fp_mul_pallas(a, a), cold=True,
                                  device=dev)
    assert cold > max(us for _, us in events) / 1e3 / 2


def _signed_block(n, seed):
    """``n`` rows: signed rows tiled, an invalid row of each class."""
    rng = np.random.default_rng(seed)
    sigs, hashes, _ = tt.signed_rows(rng, 32)
    bad = tt.invalid_rows(rng, sigs[0], hashes[0])
    s = np.resize(np.concatenate([sigs, bad[0]]), (n, 65))
    h = np.resize(np.concatenate([hashes, bad[1]]), (n, 32))
    return np.ascontiguousarray(s), np.ascontiguousarray(h)


def test_split_phase_two_windows_in_flight(dev):
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    bv = BatchVerifier()
    wins = [_signed_block(n, 30 + n) for n in (1000, 1024, 700)]
    want = [bv.recover_addresses(*w) for w in wins]
    K.reset_launches()
    st = [bv.commit_recover(bv.stage_recover(*wins[0]))]
    got = []
    for k in range(1, len(wins)):
        st.append(bv.commit_recover(bv.stage_recover(*wins[k])))
        got.append(bv.collect_recover(st[k - 1]))
    got.append(bv.collect_recover(st[-1]))
    assert sum(K.LAUNCHES.values()) == 18 * len(wins)
    assert st[0].pair is not st[1].pair and st[0].pair is st[2].pair
    assert st[0].pair.host_sigs.is_pinned()
    for (a, ok), (wa, wok) in zip(got, want):
        np.testing.assert_array_equal(a, wa)
        np.testing.assert_array_equal(ok, wok)


def test_split_phase_refill_while_computing(dev):
    """Window 1's pair is refilled by window 3 while window 2 computes,
    and window 2's by window 4 while window 3 computes: every window
    still gives its own rows.  A third window in flight is refused."""
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    bv = BatchVerifier()
    wins = [_signed_block(8192, 40 + k) for k in range(4)]
    for w, k in zip(wins, range(4)):
        w[1][:, 0] = k  # a hash byte per window: the rows differ
    want = [bv.recover_addresses(*w) for w in wins]
    s1 = bv.commit_recover(bv.stage_recover(*wins[0]))
    s2 = bv.commit_recover(bv.stage_recover(*wins[1]))
    with pytest.raises(RuntimeError, match="third window in flight"):
        bv.stage_recover(*wins[2])
    got = [bv.collect_recover(s1)]
    s3 = bv.commit_recover(bv.stage_recover(*wins[2]))  # s1's pair
    got.append(bv.collect_recover(s2))
    s4 = bv.commit_recover(bv.stage_recover(*wins[3]))  # s2's pair
    got += [bv.collect_recover(s) for s in (s3, s4)]
    assert s3.pair is s1.pair and s4.pair is s2.pair
    for (a, ok), (wa, wok) in zip(got, want):
        np.testing.assert_array_equal(a, wa)
        np.testing.assert_array_equal(ok, wok)


def test_split_phase_new_pair_while_the_card_computes(dev):
    """A window of a bucket not seen before, staged while an 8192-row
    window computes: its new pair's device inputs come from the caching
    allocator for the current stream, so its upload waits for what that
    stream has queued (a copy racing ahead of the queue gave rows of
    zeros, every address invalid)."""
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    bv = BatchVerifier()
    big, small = _signed_block(8192, 60), _signed_block(1000, 61)
    want = [bv.recover_addresses(*w) for w in (big, small)]
    for k in range(3):
        fresh = BatchVerifier()
        s1 = fresh.commit_recover(fresh.stage_recover(*big))
        s2 = fresh.commit_recover(fresh.stage_recover(*small))
        for st, (wa, wok) in zip((s1, s2), want):
            a, ok = fresh.collect_recover(st)
            np.testing.assert_array_equal(a, wa)
            np.testing.assert_array_equal(ok, wok)


def _trace_kernels(path):
    """The hand-written kernels (``k_*``) a Chrome trace holds."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel"
               and str(e.get("name", "")).startswith("k_"))


def test_scheduler_on_card_and_devstats(dev, tmp_path):
    """Three windows through the scheduler's lane on the card answer as
    the facade; a trace armed for 2 windows holds both of their 18
    launches; a singleton goes to the card, not to the host model."""
    from eges_tpu_torch.crypto.scheduler import scheduler_for
    from eges_tpu_torch.crypto.verifier import BatchVerifier
    from eges_tpu_torch.utils import devstats

    bv = BatchVerifier()
    s, h = _signed_block(600, 50)
    addrs, ok = bv.recover_addresses(s, h)
    want = [bytes(addrs[i]) if ok[i] else None for i in range(len(s))]
    # 37 distinct rows (the others repeat them): three windows of 16
    sched = scheduler_for(bv, max_batch=16, window_ms=10_000.0)
    captures = devstats.DEFAULT.trace.status()["captures"]
    armed = devstats.DEFAULT.trace.arm(2, outdir=str(tmp_path))
    assert armed["state"] in ("armed", "tracing")
    try:
        got = sched.recover_window(h, s)
        assert got == want
        st = sched.stats()
        assert st["pipeline_windows"] == st["batches"] >= 3
        assert st["breaker_diverted"] == st["device_errors"] == 0
        K.reset_launches()
        fresh = _signed_block(1, 51)
        assert sched.recover_window(fresh[1], fresh[0]) == [
            bytes(a) if o else None
            for a, o in zip(*bv.recover_addresses(*fresh))][:1]
        assert sum(K.LAUNCHES.values()) == 2 * 18  # the window, the check
        assert sched.stats()["host_diverted"] == 0
    finally:
        sched.close()
    trace = devstats.DEFAULT.trace.status()
    assert trace["captures"] == captures + 1, trace
    kernels = _trace_kernels(os.path.join(trace["path"], "trace.json"))
    assert kernels >= 2 * 18, kernels
    assert devstats.sample_memory()[0]["bytes_in_use"] > 0


def test_scheduler_on_card_fails_on_a_device_error(dev):
    """A device error under the scheduler fails the window's rows: the
    host model answers none of them and the breaker stays closed."""
    from eges_tpu_torch.crypto.scheduler import VerifierScheduler
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    bv = BatchVerifier()

    def lost(rows):
        raise RuntimeError(f"device lost ({rows} rows)")

    bv.failure_hook = lost
    sched = VerifierScheduler(bv, max_batch=64, window_ms=10_000.0)
    s, h = _signed_block(40, 52)
    try:
        K.reset_launches()
        with pytest.raises(RuntimeError, match="device lost"):
            sched.recover_window(h, s)
        with pytest.raises(RuntimeError, match="device lost"):
            sched.recover_signers([(bytes(h[0]), bytes(s[0]))])
        st = sched.stats()
        assert st["device_errors"] == 2 and st["breaker_trips"] == 0
        assert st["host_diverted"] == st["breaker_diverted"] == 0
        assert sum(K.LAUNCHES.values()) == 0
    finally:
        sched.close()


# the 18 launches of one fused recovery, by kernel
FUSED_RECOVER = {"recover_prelude": 1, "pow_mod": 4, "y_fix": 1, "u1u2": 1,
                 "glv_digits": 1, "point_table": 1, "fp_mul": 5,
                 "fp_canon": 1, "strauss_tab": 1, "recover_finish": 1,
                 "keccak_rows": 1}


def _flood(verifier, signed: bool, gossip: bool):
    """A 4-node txpool sim, 60 signed transfers from 6 senders in windows
    of 20 (``testing.flood_sim``), signed or unsigned votes, the windows
    admitted by every pool or gossiped by the flooder."""
    txs, alloc = tt.sim_transfers(60, 6, seed=5)
    c = tt.flood_sim(verifier, txs, alloc, nodes=4, window=20, seed=5,
                     height=4, txn_per_block=25, signed=signed,
                     gossip=gossip)
    stats = c.verifier.stats()
    c.verifier.close()
    return tt.sim_outcome(c, txs, tt.verifier_only), stats


@pytest.mark.parametrize("signed,gossip", [(False, False), (True, False),
                                           (False, True)],
                         ids=["unsigned", "signed", "gossip"])
def test_sim_on_card_equals_native_twin(dev, signed, gossip):
    """Phase sim at 4 nodes: ``SimCluster(verifier=BatchVerifier())`` on
    the card gives its native-verifier twin's chain, included transfers,
    txpool stats and journal (verifier-only events dropped); no row is
    served by the host, and each device window is 18 launches."""
    from eges_tpu_torch.crypto.verifier import BatchVerifier
    from eges_tpu_torch.crypto.verify_host import NativeBatchVerifier

    native, _ = _flood(NativeBatchVerifier(), signed, gossip)
    K.reset_launches()
    card, st = _flood(BatchVerifier(), signed, gossip)
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    assert card == native
    assert None not in sum(card["included"], [])
    assert st["host_diverted"] == st["device_errors"] == 0
    windows = st["pipeline_windows"]
    assert windows >= 1
    assert launches == {k: n * windows for k, n in FUSED_RECOVER.items()}


def test_pow_sweep_on_card_equals_host_loop(dev):
    """Phase pow: the card's sweeps (one keccak_block launch each) seal
    the host loop's headers."""
    import dataclasses

    from eges_tpu_torch.core.chain import BlockChain, make_genesis
    from eges_tpu_torch.core.engine import PowEngine
    from eges_tpu_torch.core.types import new_block

    genesis = new_block(dataclasses.replace(make_genesis().header,
                                            difficulty=1 << 12))
    heads = []
    for eng in (PowEngine(sweep_batch=1024), PowEngine(sweep_batch=1024,
                                                       use_device=False)):
        chain = BlockChain(genesis=genesis, engine=eng)
        K.reset_launches()
        heads.append([eng.mine_next(chain).header for _ in range(3)])
        if eng.use_device:
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
    assert heads[0] == heads[1]
    assert set(launches) == {"keccak_block"} and launches["keccak_block"] >= 3


def test_node_service_on_card_mines_a_transfer(dev, tmp_path, monkeypatch):
    """The node service in its default mode on the card: node 0 of a
    3-node localhost chain (the other two native) warms through the
    artifact store (the library saved into an empty store, then loaded
    by the service's verifier into an empty build directory), admits a
    signed transfer through its scheduler and every node mines it; node
    0's windows run the 18 fused launches each and no row is served by
    the host; ``verifier.device_name`` names the card (C8)."""
    import asyncio
    import json as _json
    import socket
    import time

    from eges_tpu_torch.consensus.config import NodeConfig
    from eges_tpu_torch.core.types import Transaction
    from eges_tpu_torch.crypto import secp256k1 as secp
    from eges_tpu_torch.crypto.verifier import BatchVerifier
    from eges_tpu_torch.harness import cluster as hc
    from eges_tpu_torch.node.service import NodeService, ServiceConfig
    from eges_tpu_torch.utils.metrics import DEFAULT as metrics

    from eges_tpu_torch.crypto.verifier import default_verifier

    monkeypatch.setenv("EGES_AOT_DIR", str(tmp_path / "aot"))
    default_verifier.cache_clear()  # the service's verifier starts fresh
    first = BatchVerifier().aot_prewarm(buckets=(16,))
    assert first["library"] in ("compile", "build_dir")
    assert first["aot_loads"] == 0
    # the service starts as in a new checkout: no library in the build
    # directory, so its warm loads the stored one
    from eges_tpu_torch.ops import build
    os.unlink(build.library_path())
    socks = [socket.socket() for _ in range(6)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    gports, cports = ports[:3], ports[3:]
    boot = [{"account": secp.pubkey_to_address(secp.privkey_to_pubkey(
        hc.node_key(i))).hex(), "ip": "127.0.0.1", "port": str(p)}
        for i, p in enumerate(cports)]
    gen = tmp_path / "genesis.json"
    gen.write_text(_json.dumps({"config": {"thw": {
        "bootstrap": boot, "signed_votes": True}}, "timestamp": "0x0"}))
    sender = hc.node_key(9)
    frm = secp.pubkey_to_address(secp.privkey_to_pubkey(sender))
    t = Transaction(nonce=0, gas_price=0, gas_limit=21000, to=b"\x09" * 20,
                    value=0).signed(sender)

    async def run():
        svcs = [NodeService(ServiceConfig(
            datadir=str(tmp_path / f"n{i}"), genesis_path=str(gen),
            key_hex=hc.node_key(i).hex(), gossip_port=gports[i],
            peers=tuple(("127.0.0.1", p) for p in gports),
            node=NodeConfig(consensus_port=cports[i], total_nodes=3,
                            txn_per_block=10, block_timeout_s=5.0),
            verbosity=1, verifier_mode="" if i == 0 else "native"))
            for i in range(3)]
        for s in svcs:
            await s.start()
        try:
            svcs[0]._prewarm_thread.join()
            K.reset_launches()
            svcs[0].txpool.add_locals([t])
            t0 = time.monotonic()
            while time.monotonic() - t0 < 60:
                await asyncio.sleep(0.1)
                if all(s.chain.lookup_txn(t.hash) for s in svcs):
                    break
            found = [s.chain.lookup_txn(t.hash) for s in svcs]
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            st = svcs[0].chain.verifier.stats()
            nonces = [s.chain.state_at(s.chain.head().hash).nonce(frm)
                      for s in svcs]
            stats = svcs[0]._raw_verifier.aot_stats()
            return found, launches, st, nonces, stats
        finally:
            for s in svcs:
                s.close()

    found, launches, st, nonces, aot = asyncio.run(run())
    assert all(found) and {f[2].status for f in found} == {1}
    assert nonces == [1, 1, 1]
    assert aot["aot_loads"] == 1 and aot["aot_compiles"] == 0
    assert st["host_diverted"] == st["device_errors"] == 0
    batches = launches.get("keccak_rows", 0)
    assert batches >= 1
    assert launches == {k: n * batches for k, n in FUSED_RECOVER.items()}
    assert metrics.snapshot()["verifier.device_name"] == \
        torch.cuda.get_device_name(0)
