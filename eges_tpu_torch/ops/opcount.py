"""u32 operations per row of each kernel: the operation half of the
bound that ``chip_smoke.py`` sets beside each kernel's time.

Counted from ``csrc/field.cuh`` and the kernel sources as the H100
issues them: one for each instruction of one 32-bit lane, where a 64-bit
keccak lane takes two (its halves), and copies, loads and stores are not
counted.  Where the source's operators fuse into one Hopper instruction
they count once:

* a product and the add of it (IMAD);
* a right shift and the add of its result (LEA.HI);
* a sum of n values, signs and constants included: ceil((n - 1) / 2)
  three-input adds (IADD3);
* and/or/xor/not of three values (LOP3), a compare and the and of its
  result (ISETP with a predicate), a rearrangement of whole bytes of two
  words (PRMT);
* a value added to zero, a result nothing reads, and a value computed
  a second time (a square's a_i * a_j and a_j * a_i) cost nothing.

The rules aim at the fewest instructions the card could issue, so that
an operation bound counts no more than the card does.
``chip_smoke.py`` (phase ``sass``) checks it on every run against the
``sm_90a`` code: each loop of the product chain against ``fp_mul``
(997 counted), each loop of the pow against ``fp_sqr`` (757), each
kernel without a branch or a call against its instruction count, and
the shortest path through each prelude, y_fix, u1u2, GLV, fp_mul,
fp_canon, finish and keccak_rows instance against a lane's share of the
row's count (the count over T; keccak_rows' path with its round loop
taken as many trips as the 24 rounds need, and its loop against a
lane's share of the rounds of a trip).

``HELPERS`` gives each device function of ``field.cuh`` its own
operations (its loops, counted by hand) and the counted functions it
calls, with how many call sites.  ``tests/test_torch_opcount.py``
parses ``field.cuh``, ``verify.cu``, ``glue.cu``, ``tiling.cu`` and
``profile.cu`` and holds every function's and kernel's calls equal to
its entry, so a changed formula fails a test instead of moving the
bound unseen.  Templates are counted by formula (``TEMPLATES``), keyed
in ``HELPERS`` by their arguments, for example ``"mul_cols<16,16>"``.

Work that depends on the data is counted as this run's data needs it:
``jac_add_mixed`` runs ``jac_double`` in place of its sum only on rows
where both points are equal (``DATA_DEPENDENT``, ``ADD_SUM_CALLS``), so
its count is the sum's and ``per_row`` swaps in the doublings the caller
says the data takes.  Work whose result is thrown away or is known
without it is not counted: ``per_row`` takes the ladder's doublings,
adds and negations that the caller's digits need (a zero digit's add
is computed and discarded), and ``pow_row`` leaves out the pow's
products by 1 (a zero digit of the exponent) and squarings of 1.
"""

from __future__ import annotations

import functools


def adds(n: int) -> int:
    """Three-input adds that sum ``n`` values: ceil((n - 1) / 2)."""
    return max(0, n) // 2


def mul_cols(na: int, nb: int) -> int:
    """Schoolbook columns: a product and a mask (its low half) per limb
    pair; each column sums its pairs' low halves and the high halves of
    the column below, each high half's shift fused into an add."""
    total = 2 * na * nb
    for k in range(na + nb):
        lo = sum(1 for i in range(na) if 0 <= k - i < nb)
        hi = sum(1 for i in range(na) if 0 <= k - 1 - i < nb)
        total += hi + adds(lo)
    return total


def carry(nc: int, nout: int) -> int:
    """Carry chain over ``nc`` columns into ``nout`` limbs: a mask per
    limb, each carry's shift fused into the next column's add, one
    extract a limb past the columns."""
    return (nc - 1) + min(nc, nout) + max(0, nout - nc)


def fn_red_cols(w: int) -> int:
    """``w`` columns -> canonical mod N (the template's recursion)."""
    if w > 16:
        nh = w - 15
        w2 = max(16, nh + 9)
        return (carry(w - 16, nh) + mul_cols(nh, 9) + min(16, nh + 9)
                + fn_red_cols(w2))
    return (carry(16, 17) + 2 * (mul_cols(1, 9) + 10 + carry(16, 17))
            + 2 * ops("cond_sub_n"))


def mul_chain_rows8(chain: int) -> int:
    """profile.cu's template: ``chain`` products of one row."""
    return chain * ops("fp_mul")


def _bits(T: int) -> list[int]:
    """The shifts of a group of T lanes: 1, 2, ... below T."""
    return [1 << i for i in range(T.bit_length() - 1)]


def grp_pick(T: int, n: int = 16) -> int:
    """A tree of T - 1 selects for each of the lane's n/T limbs."""
    return (n // T) * (T - 1)


def _shift_selects(T: int, j: int) -> int:
    """grp_shift's selects for limb j: a tree on the bits of rank over
    the limbs b[j - q], one select where either side may be nonzero."""
    total = 0
    live = [0 <= j - q < 16 for q in range(T)]
    for s in _bits(T):
        for q in range(0, T, 2 * s):
            total += live[q] or live[q + s]
            live[q] = live[q] or live[q + s]
    return total


def grp_shift(T: int) -> int:
    """The selects of all 16 + T - 1 limbs of the shifted operand of one
    product (grp_cols takes them one at a time)."""
    return sum(_shift_selects(T, j) for j in range(16 + T - 1))


def grp_cols(T: int, na: int = 16) -> int:
    """One lane's share of the product columns of a (``na`` limbs) x b
    (16 limbs): its na/T limbs of a against 16 + T - 1 limbs of the
    shifted b (those past b are zero but multiplied all the same), each
    product's halves added into columns T*m + j and T*m + j + 1; T = 1 is
    mul_cols<na, 16>."""
    if T == 1:
        return mul_cols(na, 16)
    S, W = na // T, 16 + T - 1
    total = 2 * S * W
    for k in range(na + 16):
        lo = sum(1 for m in range(S) if 0 <= k - T * m < W)
        hi = sum(1 for m in range(S) if 0 <= k - 1 - T * m < W)
        total += hi + adds(lo)
    return total + grp_pick(T, na) + grp_shift(T)


def grp_fold_cols(T: int) -> int:
    """grp_cols' products and fold32 (at T = 1 exactly those); at T > 1
    the limbs of b that have products in both passes are selected twice."""
    if T == 1:
        return mul_cols(16, 16) + ops("fold32")
    S, W = 16 // T, 16 + T - 1
    both = [j for j in range(W)
            if any(T * m + j >= 15 for m in range(S))
            and any(T * m + j < 15 for m in range(S))]
    return (grp_cols(T) + ops("fold32")
            + sum(_shift_selects(T, j) for j in both))


def grp_sum(T: int, nc: int) -> int:
    """A shuffle and an add a column for each of log2(T) exchanges."""
    return 2 * nc * len(_bits(T))


TEMPLATES = {"mul_cols": mul_cols, "carry": carry, "fn_red_cols": fn_red_cols,
             "mul_chain_rows8": mul_chain_rows8, "grp_pick": grp_pick,
             "grp_shift": grp_shift, "grp_cols": grp_cols,
             "grp_fold_cols": grp_fold_cols, "grp_sum": grp_sum}

# carry_tail: two 16-step carry chains (16 masks, 15 shift-adds), each
# with its fold of the top carry (a shift, a product-add, a shift-add),
# then the closing 5-step chain
CARRY_TAIL = 2 * (16 + 15 + 3) + 5 + 4
# keccak_words, a round on u32 halves: theta's 5 parities (2 LOP3s a
# half), 5 rotations of 2 funnel shifts and 25 lanes' xor with two
# parities (a LOP3 a half), rho's 24 rotations of 2 funnel shifts, chi (a
# LOP3 a half a lane) and iota (one xor a half)
KECCAK = 24 * (2 * (5 * 2 + 25 + 25 + 1) + 5 * 2 + 24 * 2)
# grp_keccak_words, a round in one lane of a pair, on its u32 halves:
# theta's 5 parities (2 LOP3s each), 5 rotations of a parity (a shuffle
# for the partner's half and a funnel shift), the 25 lanes' xor with two
# parities (a LOP3 each), rho's 24 rotations (a shuffle and a funnel
# shift each), chi (a LOP3 a lane) and iota (one xor)
KECCAK_PAIR = 24 * (5 * 2 + 5 * 2 + 25 + 24 * 2 + 25 + 1)
# the rounds of a trip of grp_keccak_words' round loop (its ``#pragma
# unroll``; keccak_words takes one a trip)
KECCAK_UNROLL = 4
# k_keccak_round, per column (its 25 lanes together), on u32 halves: 24
# rounds of theta (5 lanes fold 5 parities: 2 LOP3s a half; 25 lanes each
# a 2-funnel-shift rotation and a LOP3 a half), rho (25 rotations: a
# 2-select swap and 2 funnel shifts), chi (a LOP3 a half) and iota (2)
KECCAK_ROUND = 24 * (5 * 2 * 2 + 25 * 4 + 25 * 4 + 25 * 2 + 2)

# a square's 120 products a_i * a_j (i != j) that come twice, computed
# once with their masks
SQR_SAVED = 2 * (16 * 15 // 2)

# device function of field.cuh: (own operations, {counted callee: call
# sites}); a templated callee is keyed by its arguments
HELPERS: dict[str, tuple[int, dict[str, int]]] = {
    "carry_tail": (CARRY_TAIL, {}),
    # the folds of columns 16..31 and 16, 17: a product-add a column,
    # an add for columns 2..15, none for 2 and 3 of the second fold
    "fold32": (16 + 14 + 2, {}),
    "fp_mul": (0, {"mul_cols<16,16>": 1, "fold32": 1, "carry_tail": 1}),
    "fp_sqr": (-SQR_SAVED, {"fp_mul": 1}),
    "fp_add": (16, {"carry_tail": 1}),
    "fp_sub": (16 * adds(4), {"carry_tail": 1}),
    "fp_neg": (0, {"fp_sub": 1}),
    "fp_mul_small": (16, {"carry_tail": 1}),
    "is_zero_mod": (16 * 2 + 1, {}),
    "select16": (16, {}),
    "jac_double": (0, {"grp_jac_double<1>": 1}),
    "jac_add_mixed": (0, {"grp_jac_add_mixed<1>": 1}),
    # the borrow chain: an IADD3 a limb, its borrow's shift fused into
    # the next (LEA.HI), the last borrow a shift and a sub; the 16 masks
    # of the difference are counted where it is read (cond_sub), not in
    # lt_const, which drops it
    "sub_const_chain": (1 + 15 * 2 + 2, {}),
    "lt_const": (0, {"sub_const_chain": 1}),
    "cond_sub": (16, {"sub_const_chain": 1, "select16": 1}),
    "cond_sub_p": (0, {"cond_sub": 1}),
    "cond_sub_n": (0, {"cond_sub": 1}),
    "fn_mul": (0, {"mul_cols<16,16>": 1, "fn_red_cols<32>": 1}),
    "fn_sub": (16 * adds(4), {"fn_red_cols<16>": 1}),
    "is_zero": (16, {}),
    "fn_neg": (0, {"is_zero": 1, "fn_sub": 1, "select16": 1}),
    "keccak_words": (KECCAK, {}),
    "unpack_be": (16, {}),
    "glv_sign_split": (1 + 4 + 1, {"fn_neg": 1, "select16": 1}),
    # the carry chain of 32 columns (31 shifts fused into the next
    # column's add) with the masks of its top 8 limbs only
    "carry_top8": (31 + 8, {}),
    "limbs_to_words_be": (8, {}),
}

# the T-lane forms of field.cuh, templates on T: (a lane's own
# operations for one call as a function of T, {counted callee as the
# source writes it: call sites}), where "<T>" stands for the caller's T
# and "<H>" for half of it (at least 1).
# A lane issues its share of the row's products (grp_cols) and, whole,
# the fold, the exchanges (grp_sum), the carries and everything that is
# not a product; at T = 1 each is its one-thread form.  The kernels'
# bounds count the row's work, one-thread forms (per_row); per_lane
# counts what one lane issues.
GROUP: dict[str, tuple] = {
    "grp_fp_mul": (lambda T: 0, {"grp_fold_cols<T>": 1,
                                 "grp_sum<T,16>": 1, "carry_tail": 1}),
    # at T = 1 a square's a_i * a_j and a_j * a_i are one product
    "grp_fp_sqr": (lambda T: -SQR_SAVED if T == 1 else 0,
                   {"grp_fp_mul<T>": 1}),
    "grp_fn_mul": (lambda T: 0, {"grp_cols<T>": 1, "grp_sum<T,32>": 1,
                                 "fn_red_cols<32>": 1}),
    "grp_jac_double": (lambda T: 0, {
        "grp_fp_sqr<T>": 5, "grp_fp_mul<T>": 2, "fp_add": 1, "fp_sub": 5,
        "fp_mul_small": 5}),
    "grp_jac_add_mixed": (lambda T: 3, {
        "grp_fp_sqr<T>": 3, "grp_fp_mul<T>": 8, "fp_sub": 6,
        "fp_mul_small": 5, "is_zero_mod": 3, "select16": 5,
        "grp_jac_double<T>": 1}),
    # #10's row: the ok product and its 1 - inf; the canonicalisations,
    # selects and words run whole in every lane
    "grp_recover_finish": (lambda T: 2, {
        "is_zero_mod": 1, "cond_sub_p": 3, "grp_fp_sqr<T>": 1,
        "grp_fp_mul<T>": 3, "select16": 4, "limbs_to_words_be": 2}),
    # #1's row: the flags (r_ok 2, s_ok 2, v_ok, hi, x_ok 3, the product
    # 3), x's 16-step carry chain (a product-add, a shift-add and a mask a
    # step, no carry into the first) and t[0] + 7 whole in every lane; the
    # square and the product of y^2 shared out
    "grp_recover_prelude": (lambda T: 2 + 2 + 1 + 1 + 3 + 3 + 16 * 3 - 1 + 1,
                            {"is_zero": 2, "lt_const": 3,
                             "grp_fp_sqr<T>": 1, "grp_fp_mul<T>": 1,
                             "carry_tail": 1}),
    # #4's row: at T = 1 one lane's reduction of z, two products and the
    # negation (the selects on h = 0 fold away); at T >= 2 a lane's half:
    # the reduction, the selects and the negation whole, one of the two
    # products shared over H = T / 2 lanes ("<H" below)
    "grp_u1u2": (lambda T: (-ops(f"grp_fn_mul<{T // 2}>") if T > 1
                            else -2 * ops("select16")),
                 {"fn_red_cols<17>": 1, "select16": 2, "grp_fn_mul<H>": 2,
                  "fn_neg": 1}),
    # #3's row: the compare (16 ISETPs and their and) and the parity flip
    # whole in every lane, as the canonicalisations, the negation and the
    # select are; the square shared out
    "grp_y_fix": (lambda T: 16 + 1, {"grp_fp_sqr<T>": 1, "cond_sub_p": 3,
                                     "fp_neg": 1, "select16": 1}),
    # #11's column on a pair of lanes (T >= 2; at T = 1 keccak_words):
    # each lane half of every operation of the round and the shuffles,
    # the lanes past the pair the same again
    "grp_keccak_words": (lambda T: KECCAK_PAIR, {}),
    # one scalar of #5's row: the products by g1, g2 (16 limbs) and by
    # c1, c2 (8 limbs) shared out; the carries, reductions, subtractions
    # and sign splits run whole in every lane
    "grp_glv_track": (lambda T: 0, {
        "grp_cols<T>": 2, "grp_sum<T,32>": 2, "carry_top8": 2,
        "grp_cols<T,8>": 4, "grp_sum<T,24>": 4, "fn_red_cols<24>": 4,
        "fn_sub": 3, "glv_sign_split": 2}),
}

# the digits of one GLV magnitude as #5's kernels store them (33 windows,
# MSD first): a shift and a mask a digit, the mask alone for the 9 at
# bit 0
GLV_DIGITS = 9 + 24 * 2

# grp_jac_add_mixed's counted calls that run only where the points
# differ (its else branch, the sum): where they are equal the doubling
# runs in their place
ADD_SUM_CALLS = {"grp_fp_sqr<T>": 2, "grp_fp_mul<T>": 5, "fp_sub": 4,
                 "fp_mul_small": 5, "select16": 2}

# the counted calls in the source of the two templates counted by formula
# that call others: mul_cols (and fold32) at T = 1, the pick and the
# shift above it
FORMULA_CALLS = {
    "grp_cols": {"mul_cols<NA,16>": 1, "grp_pick<T,NA>": 1,
                 "grp_shift<T>": 1},
    "grp_fold_cols": {"mul_cols<16,16>": 1, "fold32": 2, "grp_pick<T>": 1,
                      "grp_shift<T>": 2},
}

# (caller, callee): calls that run only on some rows, left out of ops()
DATA_DEPENDENT = {("grp_jac_add_mixed", "grp_jac_double<T>")}

# the kernels of csrc/verify.cu: kernel name -> (__global__ function,
# {counted field.cuh callee: call sites}); each is one call over one row,
# and tests/test_torch_opcount.py holds the calls against the source
VERIFY_KERNELS: dict[str, tuple[str, dict[str, int]]] = {
    "fn_mul": ("k_fn_mul", {"fn_mul": 1}),
    "fn_red17": ("k_fn_red17", {"fn_red_cols<17>": 1}),
    "fp_add": ("k_fp_add", {"fp_add": 1}),
    "keccak_block": ("k_keccak_block", {"keccak_words": 1}),
}

# the kernels of csrc/glue.cu, in the same form
GLUE_KERNELS: dict[str, tuple[str, dict[str, int]]] = {
    "fp_sub": ("k_fp_sub", {"fp_sub": 1}),
    "fp_neg": ("k_fp_neg", {"fp_neg": 1}),
    "fp_mul_small": ("k_fp_mul_small", {"fp_mul_small": 1}),
    "fn_sub": ("k_fn_sub", {"fn_sub": 1}),
    "fn_neg": ("k_fn_neg", {"fn_neg": 1}),
    # limbs 24..31 of a * g: the product's columns and their carry chain
    "mulhi8": ("k_mulhi8", {"mul_cols<16,16>": 1, "carry<32,32>": 1}),
}


# the kernels of csrc/tiling.cu: kernel name -> (__global__ function,
# {counted field.cuh callee: call sites in its body}); their loops run
# those calls many times, which per_row counts, and
# tests/test_torch_opcount.py holds the call sites against the source
TILING_KERNELS: dict[str, tuple[str, dict[str, int]]] = {
    # table products, 4 squarings and one product a window
    "pow_mod_rows8_p": ("k_pow_rows8_p", {"fp_mul": 3}),
    "pow_mod_rows8_n": ("k_pow_rows8_n", {"fn_mul": 3}),
    "strauss_tab_rows8": ("k_strauss_rows8", {"jac_double": 1, "fp_neg": 1,
                                              "jac_add_mixed": 1}),
    "keccak_rows_grid": ("k_keccak_round", {}),
}


# the kernels of csrc/profile.cu, in the same form; the rows8 pair calls
# the file's chain template (mul_chain_rows8) at 64 and at 1 products,
# and k_fp_mul_chain's one fp_mul call site runs in a loop of PROFILE_CHAIN,
# the harness's chain (harness/profile_mulchain.py CHAIN)
PROFILE_CHAIN = 64
PROFILE_KERNELS: dict[str, tuple[str, dict[str, int]]] = {
    "fp_mul_chain": ("k_fp_mul_chain", {"fp_mul": 1}),
    "fp_mul_chain_rows8": ("k_fp_mul_chain_rows8",
                           {"mul_chain_rows8<64>": 1}),
    "fp_mul_rows8": ("k_fp_mul_rows8", {"mul_chain_rows8<1>": 1}),
    # one float32 add an element, counted as one operation
    "add_one_f32": ("k_add_one_f32", {}),
    # one float32 multiply an element (#21), likewise
    "mul_scalar_f32": ("k_mul_scalar_f32", {}),
}


@functools.cache
def ops(name: str) -> int:
    """u32 operations of one call of a field.cuh function (``"fp_mul"``
    or a template instance such as ``"fn_red_cols<32>"``; a T-lane form's
    such as ``"grp_fp_mul<4>"`` counts one lane's)."""
    if "<" in name:
        base, args = name[:-1].split("<")
        targs = [int(a) for a in args.split(",")]
        if base in TEMPLATES:
            return TEMPLATES[base](*targs)
        own, calls = GROUP[base]
        T = targs[0]
        return own(T) + sum(n * ops(_of(T, callee))
                            for callee, n in calls.items()
                            if (base, callee) not in DATA_DEPENDENT)
    own, calls = HELPERS[name]
    return own + sum(n * ops(callee) for callee, n in calls.items())


def _of(T: int, callee: str) -> str:
    """A group form's callee at the caller's T: "<T" -> T, "<H" -> T / 2
    (at least 1)."""
    return callee.replace("<T", f"<{T}").replace("<H", f"<{max(T // 2, 1)}")


def _at(T: int, calls: dict[str, int]) -> int:
    return sum(n * ops(_of(T, callee)) for callee, n in calls.items())


def glv_lane(T: int) -> int:
    """u32 operations one lane of #5's T-lane group issues: at T = 1 both
    scalars' splits and digits; at T >= 2 its half's split, shared over
    H = T / 2 lanes, and the digits it stores: both magnitudes' at H = 1;
    at H >= 2 a select of its magnitude's 9 low limbs, its windows' digits
    and, at H = 4, a select between two windows' digits."""
    if T == 1:
        return 2 * (ops("grp_glv_track<1>") + 2 * GLV_DIGITS)
    H = T // 2
    if H == 1:
        return ops("grp_glv_track<1>") + 2 * GLV_DIGITS
    R = H // 2
    selects = sum(1 for m in range(-(-33 // R)) for q in range(1, R)
                  if R * m + q < 33)
    return ops(f"grp_glv_track<{H}>") + 9 + GLV_DIGITS + selects


def keccak_lane(T: int) -> int:
    """u32 operations one lane of #11's T-lane group issues for its
    column: the whole permutation at T = 1 (keccak_words), its half's and
    the shuffles at T >= 2 (grp_keccak_words, the lanes past the pair
    repeating it)."""
    if T == 1:
        return ops("keccak_words")
    return ops(f"grp_keccak_words<{T}>")


def per_lane(T: int, windows: int = 33, negations: float = 0.0,
             ladder_doublings: float = 0.0) -> dict[str, float]:
    """u32 operations one lane of a T-lane group issues for its row in
    the prelude, pow, y_fix, u1u2, ladder, point-table, GLV, fp_mul,
    fp_canon, finish and keccak_rows kernels: every window's work, whatever
    its digit (``negations``: the
    mean number of flagged adds a row; at T = 1, the one thread's), the
    table's doubling and 13 adds on a row whose points differ, the
    prelude's unpacking and checks with its share of y^2's products, u1u2's
    reduction and negation with its share of one of its products (both at
    T = 1), the GLV split (:func:`glv_lane`), one product (fp_mul), one
    conditional
    subtract (fp_canon, one lane a row at any T), the finish's four
    products with its canonicalisations, selects and words, y_fix's
    square with its canonicalisations, compare and negation, and the
    column's 24 Keccak rounds (at T >= 2 a lane's half of each and its
    shuffles)."""
    mul, sqr = ops(f"grp_fp_mul<{T}>"), ops(f"grp_fp_sqr<{T}>")
    fn_mul = ops(f"grp_fn_mul<{T}>")
    fn_sqr = fn_mul - (SQR_SAVED if T == 1 else 0)
    dbl = ops(f"grp_jac_double<{T}>")
    madd = ops(f"grp_jac_add_mixed<{T}>")
    # per window 4 doublings and 4 adds in place (a zero digit's add is
    # undone from a copy in shared memory); an add that meets equal points
    # runs the doubling in place of its sum.  The point table: its first
    # entry, R + R, a doubling; then 13 adds
    return {
        "pow_mod_p": 14 * mul + 64 * (4 * sqr + mul),
        "pow_mod_n": 14 * fn_mul + 64 * (4 * fn_sqr + fn_mul),
        "strauss_tab": (windows * 4 * (dbl + madd)
                        + negations * ops("fp_neg")
                        + ladder_doublings * (dbl - _at(T, ADD_SUM_CALLS))),
        "point_table": 13 * madd + dbl,
        "glv_digits": glv_lane(T),
        "recover_prelude": (3 * ops("unpack_be")
                            + ops(f"grp_recover_prelude<{T}>")),
        "u1u2": ops(f"grp_u1u2<{T}>"),
        "fp_mul": mul,
        "fp_canon": ops("cond_sub_p"),
        "recover_finish": ops(f"grp_recover_finish<{T}>"),
        "y_fix": ops(f"grp_y_fix<{T}>"),
        "keccak_rows": keccak_lane(T),
    }


def pow_work(e: int) -> tuple[int, int, int]:
    """``(table products, squarings, window products)`` that the window
    pow (64 four-bit digits of ``e``, MSD first, a table a^2..a^15 built
    each entry from the one before) needs for one row of ``a^e``: the
    table up to ``e``'s largest digit, and from the first nonzero digit
    on, whose window takes its entry as the accumulator, 4 squarings a
    window and a product for each nonzero digit.  The kernels issue all
    64 windows: the squarings of the accumulator's start, 1, and the
    products by 1 of a zero digit are not counted."""
    digits = [(e >> (4 * (63 - w))) & 15 for w in range(64)]
    live = [w for w, d in enumerate(digits) if d]
    if not live:
        return 0, 0, 0
    return (max(max(digits) - 1, 0), 4 * (63 - live[0]), len(live) - 1)


def pow_row(e: int, modulus: str) -> int:
    """u32 operations one row of ``a^e`` needs (:func:`pow_work`), mod P
    (``modulus="p"``, ``fp_sqr`` squarings) or N (``"n"``): the operation
    count of the pow kernels' bound, and of their rows8 twins'."""
    table, squarings, products = pow_work(e)
    if modulus == "p":
        mul, sqr = ops("fp_mul"), ops("fp_sqr")
    elif modulus == "n":
        mul = ops("fn_mul")
        sqr = mul - SQR_SAVED
    else:
        raise ValueError("modulus must be 'p' or 'n'")
    return (table + products) * mul + squarings * sqr


def per_row(windows: int = 33, negations: float = 0.0,
            ladder_doublings: float = 0.0, doublings: float | None = None,
            adds: float | None = None) -> dict[str, float]:
    """u32 operations per row of each kernel (per padded row for
    glv_digits, recover_finish and keccak_rows, which cover Bpad).
    ``fn_red17`` counts one row of 17 columns, ``keccak_block`` one
    row of 34 words, ``keccak_rows_grid`` one column, ``fp_mul_chain``
    one column of ``PROFILE_CHAIN`` products and ``add_one_f32`` and
    ``mul_scalar_f32`` one element.  The rows8 kernels count their
    default-layout twins' function; the pows are :func:`pow_row`'s.

    The ladders count what the caller's digits need, as means a row:
    ``doublings`` (from the window of the row's first nonzero digit on:
    before it the accumulator is the point at infinity), ``adds`` (one
    for each nonzero digit but the first, which lands on infinity and is
    the looked-up point itself; a zero digit's add is computed and
    thrown away), ``negations`` (the nonzero digits whose sign flag is
    set) and ``ladder_doublings`` (adds that meet equal points and so
    run the doubling in place of the sum).  By default every digit is
    nonzero and no flag is set: the most a row can need.  An
    accumulator that comes back to infinity part way (opposite points)
    is not seen: its next doublings and add count as needed.  The point
    table doubles once on every row: its first entry is R + R.
    """
    mul, dbl, madd = ops("fp_mul"), ops("jac_double"), ops("jac_add_mixed")
    add_sum = _at(1, ADD_SUM_CALLS)
    doublings = 4 * (windows - 1) if doublings is None else doublings
    adds = 4 * windows - 1 if adds is None else adds
    ladder = (doublings * dbl + adds * madd
              + negations * ops("fp_neg")
              + ladder_doublings * (dbl - add_sum))
    return {
        "recover_prelude": (3 * ops("unpack_be")
                            + ops("grp_recover_prelude<1>")),
        "y_fix": ops("grp_y_fix<1>"),
        "u1u2": ops("grp_u1u2<1>"),
        "glv_digits": 2 * (ops("grp_glv_track<1>") + 2 * GLV_DIGITS),
        "point_table": 14 * madd + dbl - add_sum,
        "fp_mul": mul,
        "fp_canon": ops("cond_sub_p"),
        "strauss_tab": ladder,
        "recover_finish": ops("grp_recover_finish<1>"),
        "keccak_rows": ops("keccak_words"),
        "strauss_tab_rows8": ladder,
        "keccak_rows_grid": KECCAK_ROUND,
        **{name: sum(n * ops(callee) for callee, n in calls.items())
           for name, (_, calls) in (VERIFY_KERNELS | GLUE_KERNELS).items()},
        "fp_mul_chain": PROFILE_CHAIN * mul,
        "fp_mul_chain_rows8": ops("mul_chain_rows8<64>"),
        "fp_mul_rows8": ops("mul_chain_rows8<1>"),
        "add_one_f32": 1,
        "mul_scalar_f32": 1,
    }
