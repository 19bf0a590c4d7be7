"""The T-lane design of the pow, point-table, ladder, fp_mul, finish,
y_fix and keccak_rows kernels on the CPU: the rule that picks the lanes
a row (``lanes_for``), the CPU routing of the launch entries that take
any instance (fp_mul and y_fix also on a view off a 16-byte boundary),
the point table's first entry as the doubling that the kernels run, the
lane split of a product, modelled in numpy as ``csrc/field.cuh``
computes it (``grp_pick``, ``grp_shift``, ``grp_cols``,
``grp_fold_cols``, ``fold32``, ``grp_sum``), held against the
reference's product, and the pair of lanes that shares a Keccak column
(``grp_keccak_words``) in a group of T lanes, held against the
reference's permutation.
The CUDA instances themselves run in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase ``lanes``."""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from eges_tpu.ops import pallas_kernels as pk
from eges_tpu_torch import testing as tt
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import N, P

torch.set_num_threads(1)

ROWS = (1, 2, 3, 7, 8, 33, 255, 256, 257, 1023, 1024, 8191, 8192, 65536,
        65537, 131072, 1 << 20)


@pytest.mark.parametrize("kernel", sorted(K.LANES_RULE))
def test_lanes_for_gives_an_instance_at_every_row_count(kernel):
    for rows in ROWS:
        lanes, threads = K.lanes_for(kernel, rows)
        assert lanes in K.LANES and threads in K.LANE_THREADS
        assert threads % 32 == 0 and 32 % lanes == 0


@pytest.mark.parametrize("kernel", sorted(K.LANES_RULE))
def test_lanes_for_cpu_tensors_is_one_lane(kernel):
    for rows in ROWS:
        assert K.lanes_for(kernel, rows, torch.device("cpu"))[0] == 1
        assert K.lanes_for(kernel, rows, "cpu")[0] == 1


@pytest.mark.parametrize("kernel", sorted(K.LANES_RULE))
def test_lanes_for_rejects_what_it_cannot_launch(kernel):
    with pytest.raises(ValueError):
        K.lanes_for(kernel, 0)
    with pytest.raises(KeyError):
        K.lanes_for("keccak_block", 8)


def test_fp_canon_rule_is_one_lane_a_row():
    """fp_canon's rule sweeps only the block size: one lane a row at every
    row count, and its lane entry refuses any other lane count."""
    for rows in ROWS:
        assert K.lanes_for("fp_canon", rows)[0] == 1
    a = K.from_reference(_rows(46, 2))
    for lanes in (2, 4, 8):
        with pytest.raises(ValueError):
            K.fp_canon_lanes(a, lanes, 128)


def _rows(seed, n, bound=1 << 256):
    return tt.limb_rows(tt.field_values(np.random.default_rng(seed), n,
                                        bound))


def test_pow_of_no_rows_is_no_rows():
    """An empty batch launches nothing and gives an empty result."""
    a = torch.zeros(0, 16, dtype=torch.int32)
    for mod in ("p", "n"):
        assert tuple(K.pow_mod_pallas(a, P - 2, mod).shape) == (0, 16)


def test_pow_lane_entry_on_cpu_is_the_plain_version():
    """Any instance given CPU tensors runs the plain version (the modulus
    does not change the routing; the mod-N plain pow is the slow one)."""
    e, mod = (P + 1) // 4, "p"
    a = _rows(31, 4)
    want = pk.pow_mod_np(a, e, mod)
    K.reset_launches()
    for lanes in (1, 4):
        got = K.pow_mod_lanes(K.from_reference(a), e, mod, lanes, 128)
        np.testing.assert_array_equal(K.to_reference(got), want)
    np.testing.assert_array_equal(
        K.to_reference(K.pow_mod_pallas(K.from_reference(a), e, mod)), want)
    assert sum(K.LAUNCHES.values()) == 0


def test_ladder_lane_entry_on_cpu_is_the_plain_version():
    """Two windows of the ladder over inputs that take its doubling and
    opposite-point paths, against the reference's twin."""
    n = 8
    wide = K.bpad(n)
    ins = tt.ladder_inputs(np.random.default_rng(32), n, wide, windows=2)
    want = pk.strauss_tab_np(*ins)
    K.reset_launches()
    got = K.strauss_tab_lanes(*(K.from_reference(t) for t in ins), n, 8, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            K.to_reference(g), np.stack(w, axis=-1)[:n])
    assert sum(K.LAUNCHES.values()) == 0


def test_point_table_lane_entry_on_cpu_is_the_plain_version():
    """Any instance given CPU tensors runs the plain version, and that
    equals the reference's twin on every row class of
    ``testing.table_points``: curve points, zero rows, the pad row x = 0
    and values off the curve."""
    px, py = tt.table_points(np.random.default_rng(36), 8)
    want = pk.point_table_np(px, py)
    tx, ty = K.from_reference(px), K.from_reference(py)
    K.reset_launches()
    for got in (K.point_table_lanes(tx, ty, 1, 128),
                K.point_table_lanes(tx, ty, 8, 64),
                K.point_table_pallas(tx, ty)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(K.to_reference(g), w)
    assert sum(K.LAUNCHES.values()) == 0


def test_point_table_first_entry_is_the_doubling():
    """R + R: with Z = 1 the mixed add's H and r are zero mod P on every
    relaxed R (curve points, zero rows, x = 0, off the curve, the
    extreme limbs), so it takes its doubling branch, and the doubling
    alone (what the lane kernels run for entry 2R) gives the table's
    first entry bit for bit."""
    from eges_tpu_torch.ops import field

    px, py = tt.table_points(np.random.default_rng(37), 16)
    PX, PY = (K.from_reference(t).to(torch.int64) & K.M32 for t in (px, py))
    one = torch.zeros_like(PX)
    one[:, 0] = 1
    zz = field.sqr(one)
    H = field.sub(field.mul(PX, zz), PX)
    r = field.sub(field.mul(field.mul(PY, one), zz), PY)
    assert field.is_zero_mod(H).all() and field.is_zero_mod(r).all()
    table = K.point_table_plain(K.from_reference(px), K.from_reference(py))
    for got, want in zip(field.jac_double(PX, PY, one), table):
        assert torch.equal(got.to(torch.int32), want[0])


def test_fp_mul_lane_entry_on_cpu_is_the_plain_version():
    """Any fp_mul instance given CPU tensors runs the plain version, which
    equals the reference's ``_k_mul``, and counts no launch."""
    a, b = _rows(40, 9), _rows(41, 9)
    a[0] = 0xFFFF
    want = np.stack(pk._k_mul([a[:, k] for k in range(16)],
                              [b[:, k] for k in range(16)], np), axis=-1)
    ta, tb = K.from_reference(a), K.from_reference(b)
    K.reset_launches()
    for lanes, threads in ((1, 128), (2, 64), (8, 256)):
        np.testing.assert_array_equal(
            K.to_reference(K.fp_mul_lanes(ta, tb, lanes, threads)), want)
    np.testing.assert_array_equal(K.to_reference(K.fp_mul_pallas(ta, tb)),
                                  want)
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.parametrize("off", [1, 2, 3])
def test_fp_mul_takes_a_view_off_alignment(off):
    """A contiguous ``[M, 16]`` view 4, 8 or 12 bytes into its buffer (the
    kernel's word path on the card) gives the reference's ``_k_mul``, as
    either operand."""
    a, b = _rows(42, 7), _rows(43, 7)
    buf = torch.zeros(16 * 7 + off, dtype=torch.int32)
    view = buf[off:].view(7, 16)
    view.copy_(K.from_reference(a))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * off % 16
    want = np.stack(pk._k_mul([a[:, k] for k in range(16)],
                              [b[:, k] for k in range(16)], np), axis=-1)
    np.testing.assert_array_equal(
        K.to_reference(K.fp_mul_pallas(view, K.from_reference(b))), want)
    np.testing.assert_array_equal(
        K.to_reference(K.fp_mul_pallas(K.from_reference(b), view)), want)


def test_finish_lane_entry_on_cpu_is_the_plain_version():
    """Any finish instance given CPU tensors runs the plain version, which
    equals the reference's ``_k_recover_finish`` (a point at infinity
    and a dropped ok among the rows; the padded columns carry the
    padding block of a zero message), and counts no launch."""
    n = 6
    X, Y, Z, zi = (_rows(44 + i, n) for i in range(4))
    Z[1] = 0
    ok = np.array([1, 1, 0, 1, 1, 1], np.uint32)
    ins = [K.from_reference(t) for t in (X, Y, Z, zi, ok)]
    want = pk._k_recover_finish(*([t[:, k] for k in range(16)]
                                  for t in (X, Y, Z, zi)), ok, np)
    K.reset_launches()
    for lanes, threads in ((1, 64), (4, 128), (8, 256)):
        qx, qy, got_ok, words = K.recover_finish_lanes(*ins, lanes, threads)
        np.testing.assert_array_equal(K.to_reference(qx),
                                      np.stack(want[0], axis=-1))
        np.testing.assert_array_equal(K.to_reference(qy),
                                      np.stack(want[1], axis=-1))
        np.testing.assert_array_equal(K.to_reference(got_ok), want[2])
        np.testing.assert_array_equal(K.to_reference(words)[:, :n],
                                      np.stack(want[3]))
        pad = np.zeros((34, 1), np.uint32)
        pad[16], pad[33] = 1, 0x80000000
        np.testing.assert_array_equal(
            K.to_reference(words)[:, n:],
            np.broadcast_to(pad, (34, K.bpad(n) - n)))
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.parametrize("lanes,threads", [(3, 128), (4, 96), (16, 128),
                                           (1, 512)])
def test_glv_and_canon_entries_reject_other_instances(lanes, threads):
    a = K.from_reference(_rows(47, 2, N))
    with pytest.raises(ValueError):
        K.glv_digits_lanes(a, a, lanes, threads)
    with pytest.raises(ValueError):
        K.fp_canon_lanes(a, lanes, threads)


@pytest.mark.parametrize("lanes,threads", [(3, 128), (4, 96), (16, 128),
                                           (1, 512)])
def test_fp_mul_and_finish_entries_reject_other_instances(lanes, threads):
    a = K.from_reference(_rows(45, 2))
    ok = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.fp_mul_lanes(a, a, lanes, threads)
    with pytest.raises(ValueError):
        K.recover_finish_lanes(a, a, a, a, ok, lanes, threads)


@pytest.mark.parametrize("lanes,threads", [(3, 128), (4, 96), (16, 128),
                                           (1, 512)])
def test_lane_entries_reject_other_instances(lanes, threads):
    a = K.from_reference(_rows(33, 2))
    with pytest.raises(ValueError):
        K.pow_mod_lanes(a, P - 2, "p", lanes, threads)
    with pytest.raises(ValueError):
        K.point_table_lanes(a, a, lanes, threads)


@pytest.mark.parametrize("off", [0, 1, 3])
def test_y_fix_lane_entry_on_cpu_is_the_plain_version(off):
    """Any y_fix instance given CPU tensors, a view 4 or 12 bytes into its
    buffer among them (the kernel's word path on the card), runs the
    plain version, which equals the reference's ``_k_y_fix`` (roots that
    are P, and y^2 the root's square on some rows), and counts no
    launch."""
    n = 9
    root, y_sq = _rows(50, n), _rows(51, n)
    root[1] = np.asarray(tt.limb_rows([P]))[0]
    v = np.random.default_rng(52).integers(0, 6, n).astype(np.uint32)
    sq = pk._k_sqr([root[:, k] for k in range(16)], np)
    y_sq[::2] = np.stack(sq, axis=-1)[::2]
    buf = torch.zeros(16 * n + off, dtype=torch.int32)
    view = buf[off:].view(n, 16)
    view.copy_(K.from_reference(root))
    wy, wok = pk._k_y_fix([root[:, k] for k in range(16)],
                          [y_sq[:, k] for k in range(16)], v, np)
    K.reset_launches()
    for lanes, threads in ((1, 64), (4, 64), (8, 256)):
        y, ok = K.y_fix_lanes(view, K.from_reference(y_sq),
                              K.from_reference(v), lanes, threads)
        np.testing.assert_array_equal(K.to_reference(y),
                                      np.stack(wy, axis=-1))
        np.testing.assert_array_equal(K.to_reference(ok),
                                      np.asarray(wok, np.uint32))
    assert np.asarray(wok).sum() >= n // 2
    assert sum(K.LAUNCHES.values()) == 0


def test_keccak_rows_lane_entry_on_cpu_is_the_plain_version():
    """Any keccak_rows instance given CPU tensors runs the plain version,
    which equals the reference's ``_k_keccak_words``, and counts no
    launch."""
    words = np.random.default_rng(53).integers(
        0, 1 << 32, (34, 37), dtype=np.uint64).astype(np.uint32)
    want = np.stack(pk._k_keccak_words([words[k] for k in range(34)], np))
    K.reset_launches()
    for lanes, threads in ((1, 128), (2, 64), (8, 256)):
        np.testing.assert_array_equal(K.to_reference(K.keccak_rows_lanes(
            K.from_reference(words), lanes, threads)), want)
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.parametrize("lanes,threads", [(3, 128), (4, 96), (16, 128),
                                           (1, 512)])
def test_y_fix_and_keccak_entries_reject_other_instances(lanes, threads):
    a = K.from_reference(_rows(54, 2))
    v = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.y_fix_lanes(a, a, v, lanes, threads)
    with pytest.raises(ValueError):
        K.keccak_rows_lanes(torch.zeros(34, 2, dtype=torch.int32), lanes,
                            threads)


# ---------------------------------------------------------------------------
# the lane split of field.cuh, in numpy (uint32 wraps as on the card)
# ---------------------------------------------------------------------------

def _pick(a, T, rank):
    """grp_pick: as[m] = a[T*m + rank] by a tree of selects."""
    out = []
    for m in range(len(a) // T):
        v = [a[T * m + q] for q in range(T)]
        s = 1
        while s < T:
            for q in range(0, T, 2 * s):
                v[q] = v[q + s] if rank & s else v[q]
            s <<= 1
        out.append(v[0])
    return out


def _shift(b, j, T, rank):
    """grp_shift: b[j - rank], zero outside b, by a tree of selects."""
    zero = np.zeros_like(b[0])
    v = [b[j - q] if 0 <= j - q < 16 else zero for q in range(T)]
    s = 1
    while s < T:
        for q in range(0, T, 2 * s):
            v[q] = v[q + s] if rank & s else v[q]
        s <<= 1
    return v[0]


def _cols(a, b, T, rank):
    """grp_cols: the lane's products of a's limbs T*m + rank (len(a) of
    them in all) into columns T*m + j, len(a) + 16 columns."""
    cols = [np.zeros_like(a[0]) for _ in range(len(a) + 16)]
    picked = _pick(a, T, rank)
    for j in range(16 + T - 1):
        bj = _shift(b, j, T, rank)
        for m, am in enumerate(picked):
            p = am * bj
            cols[T * m + j] = cols[T * m + j] + (p & np.uint32(0xFFFF))
            cols[T * m + j + 1] = cols[T * m + j + 1] + (p >> np.uint32(16))
    return cols


def _fold_cols(a, b, T, rank):
    """grp_fold_cols at T > 1: the products of columns 15..31 first, into
    columns that fold32 folds (columns 0..14 zero), then the products of
    the lower columns added to its result."""
    hi = [np.zeros_like(a[0]) for _ in range(32)]
    picked = _pick(a, T, rank)
    for j in range(16 + T - 1):
        bj = _shift(b, j, T, rank)
        for m, am in enumerate(picked):
            if T * m + j >= 15:
                p = am * bj
                hi[T * m + j] = hi[T * m + j] + (p & np.uint32(0xFFFF))
                hi[T * m + j + 1] = hi[T * m + j + 1] + (p >> np.uint32(16))
    r = _fold32(hi)
    for j in range(16 + T - 1):
        bj = _shift(b, j, T, rank)
        for m, am in enumerate(picked):
            if T * m + j < 15:
                p = am * bj
                r[T * m + j] = r[T * m + j] + (p & np.uint32(0xFFFF))
                r[T * m + j + 1] = r[T * m + j + 1] + (p >> np.uint32(16))
    return r


def _fold32(c):
    lo = list(c[:16]) + [np.zeros_like(c[0])] * 2
    for j in range(16):
        lo[j] = lo[j] + c[16 + j] * np.uint32(977)
        lo[j + 2] = lo[j + 2] + c[16 + j]
    r = lo[:16]
    for j in range(2):
        r[j] = r[j] + lo[16 + j] * np.uint32(977)
        r[j + 2] = r[j + 2] + lo[16 + j]
    return r


@pytest.mark.parametrize("T", [2, 4, 8])
def test_lane_split_sums_to_the_reference_product(T):
    """Each lane's folded columns (grp_fold_cols' two passes), summed over
    the group (grp_sum's exchanges add them), carried by the reference's
    tail, give the reference's relaxed product bit for bit, as do the
    fold32 of each lane's whole columns; the unfolded columns summed give
    the reference's columns (grp_fn_mul's path)."""
    a = [np.asarray(v) for v in np.asarray(_rows(34, 12), np.uint32).T]
    b = [np.asarray(v) for v in np.asarray(_rows(35, 12), np.uint32).T]
    for limb in a + b:              # row 0: every limb 0xFFFF
        limb[0] = 0xFFFF
    parts = [_cols(a, b, T, rank) for rank in range(T)]
    whole = [sum(p[k] for p in parts) for k in range(32)]
    want_cols = pk._k_mul_cols_vv(a, b, np)
    for k in range(31):
        np.testing.assert_array_equal(whole[k], want_cols[k])
    want = np.stack(pk._k_mul(a, b, np))
    folded = [sum(_fold32(p)[k] for p in parts) for k in range(16)]
    np.testing.assert_array_equal(np.stack(pk._k_carry_tail(folded, np)),
                                  want)
    lanes = [_fold_cols(a, b, T, rank) for rank in range(T)]
    for k in range(16):
        np.testing.assert_array_equal(sum(f[k] for f in lanes), folded[k])
    two_pass = [sum(f[k] for f in lanes) for k in range(16)]
    np.testing.assert_array_equal(np.stack(pk._k_carry_tail(two_pass, np)),
                                  want)


@pytest.mark.parametrize("T", [2, 4, 8])
def test_glv_half_split_sums_to_the_reference_columns(T):
    """#5 on T lanes: each half of the group splits one scalar over H =
    T / 2 lanes (grp_glv_track<H>).  Its lanes' columns of u * g (16
    limbs) and of c * a (c's 8 limbs), summed, are the reference's
    columns; limbs 24..31 of the first, carried (carry_top8), are the
    reference's c; the 24 columns of the second reduce
    (fn_red_cols<24>) to the bits the reference's 32 columns, the top 8
    zero, give."""
    from eges_tpu_torch.ops import curve

    H = T // 2
    u = [np.asarray(v) for v in tt.limb_rows(
        tt.glv_scalars(np.random.default_rng(48), 12)).T]
    g1, _, a1, _, b1n, _ = (
        [np.full_like(u[0], limb) for limb in c] for c in curve.glv_consts())
    parts = [_cols(u, g1, H, rank) for rank in range(H)]
    whole = [sum(p[k] for p in parts) for k in range(32)]
    want = pk._k_mul_cols_vv(u, g1, np)
    for k in range(32):
        np.testing.assert_array_equal(whole[k], want[k])
    c1 = pk._k_carry(whole, 32, np)[24:32]
    for ai in (a1, b1n):
        parts = [_cols(c1, ai, H, rank) for rank in range(H)]
        cols24 = [sum(p[k] for p in parts) for k in range(24)]
        zero = np.zeros_like(u[0])
        want = pk._k_mul_cols_vv(c1 + [zero] * 8, ai, np)
        for k in range(24):
            np.testing.assert_array_equal(cols24[k], want[k])
        for k in range(24, 32):
            assert not want[k].any()
        np.testing.assert_array_equal(
            np.stack(pk._k_fn_red_cols(cols24, np)),
            np.stack(pk._k_fn_red_cols(want, np)))


def _glv_words(T, rank):
    """The (row t, window w) digit words and the sign rows of one row of
    #5's output that lane `rank` of a T-lane group stores
    (recover.cu glv_rows, glv_store), with the half whose split it holds
    (None for zeros)."""
    H = T // 2 if T > 1 else 1
    halves = [rank // H] if T > 1 else [0, 1]
    s = rank % H
    words = []
    for h in halves:
        if H == 1:
            words += [((2 * h + i, w), h) for w in range(33) for i in (0, 1)]
            words += [(("neg", 2 * h + i), h) for i in (0, 1)]
        else:
            R = H // 2
            i, r = s & 1, s >> 1
            words += [((2 * h + i, R * m + r), h)
                      for m in range(-(-33 // R)) if R * m + r < 33]
            if r == 0:
                words.append((("neg", 2 * h + i), h))
    for m in range(-(-136 // T)):
        z = T * m + rank
        if z < 132:
            words.append(((4 + z % 4, z // 4), None))
        elif z < 136:
            words.append((("neg", z - 128), None))
    return words


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_glv_stores_cover_each_word_once(T):
    """The group's lanes store each of a row's 264 digit words and 8 signs
    exactly once, each digit and sign of rows 0-3 from a lane of the half
    that holds its scalar's split (rows 0, 1: u1; 2, 3: u2) and rows 4-7
    as zeros; each lane takes about its share."""
    seen = {}
    for rank in range(T):
        for word, h in _glv_words(T, rank):
            assert word not in seen
            seen[word] = h
    assert len(seen) == 33 * 8 + 8
    for (first, second), h in seen.items():
        row = second if first == "neg" else first
        assert h == (row // 2 if row < 4 else None)
    counts = [len(_glv_words(T, rank)) for rank in range(T)]
    assert max(counts) <= 2 * (272 // T) + 2


# ---------------------------------------------------------------------------
# the prelude's byte spans (recover.cu bytes_in, prelude_rows), in numpy
# ---------------------------------------------------------------------------

def _bytes_in(addr, length, threads):
    """The bytes of ``[addr, addr + length)`` each thread of a block loads
    in bytes_in: uint4 i of the aligned middle by thread i % threads, the
    head (before the first 16-byte boundary) a byte a thread from thread
    0, the tail from thread 16.  Returns {thread: [byte offsets]}."""
    lead = (16 - addr % 16) % 16
    head = min(lead, length)
    mid = (length - head) // 16
    tail = length - head - 16 * mid
    loads = {t: [] for t in range(threads)}
    # the loop's rounds i0 = t, t + 4 * threads, ... each take i0 + k *
    # threads, k < 4: thread t takes every i = t (mod threads)
    for i in range(mid):
        loads[i % threads].extend(range(head + 16 * i, head + 16 * i + 16))
    for t in range(threads):
        if t < head:
            loads[t].append(t)
        elif 16 <= t < 16 + tail:
            loads[t].append(head + 16 * mid + t - 16)
    return loads


def _hash_at(rows, pitch):
    """recover.cu prelude_hash_at."""
    return ((rows - 1) * pitch + 65 + 15 + 15) & ~15


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_prelude_spans_load_each_byte_once(T):
    """Each block of every instance loads each byte of its rows'
    signature span ([r0 * pitch, r0 * pitch + (n - 1) * pitch + 65)) and
    hash span exactly once, and no byte outside them, at pitches 65, 66,
    70 and 256, base offsets 0-15, every block size, for a full block and
    a ragged last one; the aligned loads land on 16-byte boundaries of
    shared memory and the spans fit under the output tiles' or the
    launcher's size (recover.cu prelude_smem)."""
    for threads in K.LANE_THREADS:
        rows = threads // T
        for pitch in (65, 66, 70, K.PRELUDE_MAX_PITCH):
            for base in range(16):
                for r0, n in ((rows, rows), (3 * rows, max(rows // 3, 1))):
                    sig = base + r0 * pitch
                    hsh = base + 32 * r0
                    spans = ((sig, (n - 1) * pitch + 65, sig % 16),
                             (hsh, 32 * n, _hash_at(rows, pitch) + hsh % 16))
                    for addr, length, at in spans:
                        got = sorted(b for bs in _bytes_in(
                            addr, length, threads).values() for b in bs)
                        assert got == list(range(length))
                        # the tile's byte b at `at + b`: the same offset
                        # from a 16-byte boundary as the address
                        assert (at - addr) % 16 == 0
                    smem = max(_hash_at(rows, pitch) + 32 * rows + 16,
                               5 * rows * 64)
                    assert spans[1][2] + spans[1][1] <= smem
                    assert spans[0][2] + spans[0][1] <= _hash_at(rows, pitch)
                    assert smem <= 5 * 64 * K.LANE_THREADS[-1]


def test_prelude_rows_every_byte_once_in_rows():
    """The rows a block unpacks from its spans (row lr at lr * pitch, its
    hash at 32 * lr) are the block's rows of the batch, byte for byte: a
    numpy copy of the spans at several pitches and offsets gives the
    rows back."""
    rng = np.random.default_rng(57)
    for pitch, base, rows, B in ((65, 3, 32, 70), (70, 13, 64, 64),
                                 (256, 0, 8, 9)):
        mem = rng.integers(0, 256, base + B * pitch, dtype=np.uint8)
        batch = mem[base:].reshape(B, pitch)
        for r0 in range(0, B, rows):
            n = min(rows, B - r0)
            addr = base + r0 * pitch
            tile = np.zeros(addr % 16 + (n - 1) * pitch + 65, np.uint8)
            for bs in _bytes_in(addr, (n - 1) * pitch + 65, 256).values():
                for b in bs:
                    tile[addr % 16 + b] = mem[addr + b]
            for lr in range(n):
                at = addr % 16 + lr * pitch
                np.testing.assert_array_equal(tile[at:at + 65],
                                              batch[r0 + lr, :65])


# ---------------------------------------------------------------------------
# the pair of lanes of a Keccak column (field.cuh grp_keccak_words), in numpy
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _funnel_l(lo, hi, shift):
    """__funnelshift_l: the top 32 bits of (hi:lo) << (shift & 31)."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v << np.uint64(shift & 31)) >> np.uint64(32)).astype(np.uint32)


def _pair_rot(mine, other, r):
    """grp_keccak_words' rotation: a lane's half of a 64-bit lane rotated
    left by r, from its own half and its partner's, the same in both."""
    return (_funnel_l(other, mine, r) if r < 32
            else _funnel_l(mine, other, r - 32))


def _pair_keccak(words, rot, rc):
    """grp_keccak_words on a pair of lanes, each a list of its halves of
    the 25 lanes (numpy rows over the columns); a shuffle reads the other
    lane's value.  ``[34, n]`` block words -> ``[8, n]`` digest words."""
    zero = np.zeros_like(words[0])
    a = [[words[2 * l + h] if l < 17 else zero for l in range(25)]
         for h in (0, 1)]
    for rnd in range(24):
        c = [[a[h][x] ^ a[h][x + 5] ^ a[h][x + 10] ^ a[h][x + 15]
              ^ a[h][x + 20] for x in range(5)] for h in (0, 1)]
        r1 = [[_pair_rot(c[h][x], c[1 - h][x], 1) for x in range(5)]
              for h in (0, 1)]
        a = [[a[h][x + 5 * y] ^ c[h][(x + 4) % 5] ^ r1[h][(x + 1) % 5]
              for y in range(5) for x in range(5)] for h in (0, 1)]
        b = [[None] * 25 for _ in (0, 1)]
        for h in (0, 1):
            for x in range(5):
                for y in range(5):
                    l = x + 5 * y
                    b[h][y + 5 * ((2 * x + 3 * y) % 5)] = (
                        _pair_rot(a[h][l], a[1 - h][l], rot[l]) if rot[l]
                        else a[h][l])
        a = [[b[h][x + 5 * y] ^ (~b[h][(x + 1) % 5 + 5 * y]
                                 & b[h][(x + 2) % 5 + 5 * y])
              for y in range(5) for x in range(5)] for h in (0, 1)]
        for h in (0, 1):
            a[h][0] = a[h][0] ^ np.uint32((rc[rnd] >> (32 * h)) & M32)
    return np.stack([a[k & 1][k // 2] for k in range(8)])


def test_keccak_pair_gives_the_reference_permutation():
    """Two lanes, each holding one 32-bit half of every 64-bit lane and
    reading the other's by a shuffle, with the rotations, parities and
    round constants as ``grp_keccak_words`` writes them (its ROT table
    read from ``field.cuh``), give the reference's digests bit for bit,
    on random blocks and on blocks of all zero and all one bits."""
    import re

    from eges_tpu_torch.ops import build, field

    src = (build.CSRC / "field.cuh").read_text()
    body = src[src.index("EG_FD void grp_keccak_words("):]
    rot = [int(v) for v in re.search(r"const int ROT\[25\] = \{([^}]*)\}",
                                     body).group(1).split(",")]
    words = np.random.default_rng(55).integers(
        0, 1 << 32, (34, 12), dtype=np.uint64).astype(np.uint32)
    words[:, 0], words[:, 1] = 0, M32
    want = np.stack(pk._k_keccak_words([words[k] for k in range(34)], np))
    np.testing.assert_array_equal(
        _pair_keccak(words, rot, field.KECCAK_RC), want)


@pytest.mark.parametrize("T", [2, 4, 8])
def test_keccak_group_stores_every_digest_word_once(T):
    """``keccak_cols`` at T >= 2: lane ``rank`` of the group loads the
    block words of its half (rank & 1), the lanes past the pair repeating
    it, and stores the digest words k = rank (mod T) from its own half.
    Every one of the 8 words is stored exactly once, by a lane holding
    that word's half, and the stored column is the reference's digest."""
    import re

    from eges_tpu_torch.ops import build, field

    src = (build.CSRC / "field.cuh").read_text()
    body = src[src.index("EG_FD void grp_keccak_words("):]
    rot = [int(v) for v in re.search(r"const int ROT\[25\] = \{([^}]*)\}",
                                     body).group(1).split(",")]
    words = np.random.default_rng(56 + T).integers(
        0, 1 << 32, (34, 12), dtype=np.uint64).astype(np.uint32)
    words[:, 2] = M32
    pair = _pair_keccak(words, rot, field.KECCAK_RC)
    out, stores = np.zeros_like(pair), [0] * 8
    for rank in range(T):
        h = rank & 1
        for k in range(8):
            if k % T == rank:
                assert k & 1 == h
                out[k] = pair[2 * (k // 2) + h]
                stores[k] += 1
    assert stores == [1] * 8
    want = np.stack(pk._k_keccak_words([words[k] for k in range(34)], np))
    np.testing.assert_array_equal(out, want)
