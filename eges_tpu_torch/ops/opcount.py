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
(997 counted), each loop of the pow against ``fp_sqr`` (757), and each
kernel without a branch or a call against its instruction count.

``HELPERS`` gives each device function of ``field.cuh`` its own
operations (its loops, counted by hand) and the counted functions it
calls, with how many call sites.  ``tests/test_torch_opcount.py``
parses ``field.cuh``, ``verify.cu``, ``glue.cu``, ``tiling.cu`` and
``profile.cu`` and holds every function's and kernel's calls equal to
its entry, so a changed formula fails a test instead of moving the
bound unseen.  Templates are counted by formula (``TEMPLATES``), keyed
in ``HELPERS`` by their arguments, for example ``"mul_cols<16,16>"``.

Work that depends on the data is counted as this run's data needs it:
``jac_add_mixed`` runs ``jac_double`` only on rows where both points are
equal (``DATA_DEPENDENT``), so its count leaves the doubling out and
``per_row`` adds the doublings the caller says the data takes.
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


TEMPLATES = {"mul_cols": mul_cols, "carry": carry, "fn_red_cols": fn_red_cols,
             "mul_chain_rows8": mul_chain_rows8}

# carry_tail: two 16-step carry chains (16 masks, 15 shift-adds), each
# with its fold of the top carry (a shift, a product-add, a shift-add),
# then the closing 5-step chain
CARRY_TAIL = 2 * (16 + 15 + 3) + 5 + 4
# keccak_words, a round on u32 halves: theta's 5 parities (2 LOP3s a
# half), 5 rotations of 2 funnel shifts and 25 lanes' xor with two
# parities (a LOP3 a half), rho's 24 rotations of 2 funnel shifts, chi (a
# LOP3 a half a lane) and iota (one xor a half)
KECCAK = 24 * (2 * (5 * 2 + 25 + 25 + 1) + 5 * 2 + 24 * 2)
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
    "fp_mul": (16 + 14 + 2, {"mul_cols<16,16>": 1, "carry_tail": 1}),
    "fp_sqr": (-SQR_SAVED, {"fp_mul": 1}),
    "fp_add": (16, {"carry_tail": 1}),
    "fp_sub": (16 * adds(4), {"carry_tail": 1}),
    "fp_neg": (0, {"fp_sub": 1}),
    "fp_mul_small": (16, {"carry_tail": 1}),
    "is_zero_mod": (16 * 2 + 1, {}),
    "select16": (16, {}),
    "jac_double": (0, {"fp_sqr": 5, "fp_mul": 2, "fp_add": 1, "fp_sub": 5,
                       "fp_mul_small": 5}),
    "jac_add_mixed": (3, {"fp_sqr": 3, "fp_mul": 8, "fp_sub": 6,
                          "fp_mul_small": 5, "is_zero_mod": 3,
                          "select16": 5, "jac_double": 1}),
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
    # the flags (r_ok 2, s_ok 2, v_ok, hi, x_ok 3, the product 3), x's
    # 16-step carry chain (a product-add, a shift-add and a mask a step,
    # no carry into the first) and t[0] + 7
    "recover_prelude": (2 + 2 + 1 + 1 + 3 + 3 + 16 * 3 - 1 + 1, {"is_zero": 2, "lt_const": 3, "fp_sqr": 1,
                             "fp_mul": 1, "carry_tail": 1}),
    "y_fix": (16 + 1, {"fp_sqr": 1, "cond_sub_p": 3, "fp_neg": 1,
                           "select16": 1}),
    "u1u2": (0, {"fn_red_cols<17>": 1, "fn_mul": 2, "fn_neg": 1}),
    "glv_sign_split": (1 + 4 + 1, {"fn_neg": 1, "select16": 1}),
    # a shift and a mask a digit, the mask alone for the 9 at bit 0
    "glv_digits33": (9 + 24 * 2, {}),
    "glv_track": (0, {"mul_cols<16,16>": 6, "carry<32,32>": 2,
                      "fn_red_cols<32>": 4, "fn_sub": 3, "glv_sign_split": 2,
                      "glv_digits33": 2}),
    "limbs_to_words_be": (8, {}),
    "recover_finish": (2, {"is_zero_mod": 1, "cond_sub_p": 3, "fp_sqr": 1,
                           "fp_mul": 3, "select16": 4,
                           "limbs_to_words_be": 2}),
}

# (caller, callee): calls that run only on some rows, left out of ops()
DATA_DEPENDENT = {("jac_add_mixed", "jac_double")}

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
    or a template instance such as ``"fn_red_cols<32>"``)."""
    if "<" in name:
        base, args = name[:-1].split("<")
        fn = TEMPLATES[base]
        return fn(*(int(a) for a in args.split(",")))
    own, calls = HELPERS[name]
    return own + sum(n * ops(callee) for callee, n in calls.items()
                     if (name, callee) not in DATA_DEPENDENT)


def per_row(windows: int = 33, negations: float = 0.0,
            ladder_doublings: float = 0.0) -> dict[str, float]:
    """u32 operations per row of each kernel (per padded row for
    glv_digits, recover_finish and keccak_rows, which cover Bpad).
    ``fn_red17`` counts one row of 17 columns, ``keccak_block`` one
    row of 34 words, ``keccak_rows_grid`` one column, ``fp_mul_chain``
    one column of ``PROFILE_CHAIN`` products and ``add_one_f32`` and
    ``mul_scalar_f32`` one element.  The rows8 kernels do their
    default-layout twins' arithmetic per row.

    ``negations`` is the mean number of ladder adds per row whose point
    is negated (``windows`` x the rows' set sign flags), and
    ``ladder_doublings`` the mean number of ladder adds per row that meet
    equal points and so run the doubling path.  The point table doubles
    once on every row: its first entry is R + R.
    """
    mul, dbl, madd = ops("fp_mul"), ops("jac_double"), ops("jac_add_mixed")
    # the pow kernels: 14 table products, then 64 windows of 4 squarings
    # (acc * acc) and one product
    fn_mul = ops("fn_mul")
    pow_p = 14 * mul + 64 * (4 * ops("fp_sqr") + mul)
    pow_n = 14 * fn_mul + 64 * (4 * (fn_mul - SQR_SAVED) + fn_mul)
    # the ladder kernels: per window 4 doublings and 4 adds, each add's
    # result kept by a 3-value select on d != 0
    ladder = (windows * 4 * (dbl + madd + 3 * ops("select16"))
              + negations * ops("fp_neg") + ladder_doublings * dbl)
    return {
        "recover_prelude": 3 * ops("unpack_be") + ops("recover_prelude"),
        "pow_mod_p": pow_p,
        "pow_mod_n": pow_n,
        "y_fix": ops("y_fix"),
        "u1u2": ops("u1u2"),
        "glv_digits": 2 * ops("glv_track"),
        "point_table": 14 * madd + dbl,
        "fp_mul": mul,
        "fp_canon": ops("cond_sub_p"),
        "strauss_tab": ladder,
        "recover_finish": ops("recover_finish"),
        "keccak_rows": ops("keccak_words"),
        "pow_mod_rows8_p": pow_p,
        "pow_mod_rows8_n": pow_n,
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
