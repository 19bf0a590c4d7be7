"""u32 operations per row of each kernel: the operation half of the
bound that ``chip_smoke.py`` sets beside each kernel's time.

Counted from ``csrc/field.cuh`` and the kernel sources: each add, sub,
mul, and, or, xor, shift, compare or select of one 32-bit lane is one
operation, and a 64-bit keccak lane operation is two; copies, loads and
stores are not counted.  ``HELPERS`` gives each device function of
``field.cuh`` its own operations (its loops, counted by hand) and the
counted functions it calls, with how many call sites.
``tests/test_torch_opcount.py`` parses ``field.cuh``, ``verify.cu``,
``glue.cu`` and ``tiling.cu`` and holds every function's and kernel's
calls equal to its entry, so a changed formula fails a test
instead of moving the bound unseen.  Templates are counted by formula
(``TEMPLATES``), keyed in ``HELPERS`` by their arguments, for example
``"mul_cols<16,16>"``.

Work that depends on the data is counted as this run's data needs it:
``jac_add_mixed`` runs ``jac_double`` only on rows where both points are
equal (``DATA_DEPENDENT``), so its count leaves the doubling out and
``per_row`` adds the doublings the caller says the data takes.
"""

from __future__ import annotations

import functools


def mul_cols(na: int, nb: int) -> int:
    """Schoolbook columns: mul, and, shift and two adds per limb pair."""
    return na * nb * 5


def carry(nc: int, nout: int) -> int:
    """Carry chain over ``nc`` columns into ``nout`` limbs."""
    return 3 * nc + 2 * max(0, nout - nc)


def fn_red_cols(w: int) -> int:
    """``w`` columns -> canonical mod N (the template's recursion)."""
    if w > 16:
        nh = w - 15
        w2 = max(16, nh + 9)
        return carry(w - 16, nh) + mul_cols(nh, 9) + w2 + fn_red_cols(w2)
    return (carry(16, 17) + 2 * (mul_cols(1, 9) + 16 + carry(16, 17))
            + 2 * ops("cond_sub_n"))


TEMPLATES = {"mul_cols": mul_cols, "carry": carry, "fn_red_cols": fn_red_cols}

# carry_tail: two 16-step carry chains each with its 3-operation fold,
# then the closing 5-step chain
CARRY_TAIL = 2 * (16 * 3 + 3) + 5 * 3
# keccak_words: 24 rounds of theta (20 + 20 + 25), rho (24 rotations of
# 3), chi (25 x 3) and iota (1), each 64-bit operation counted twice
KECCAK = 2 * 24 * (5 * 4 + 5 * 4 + 25 + 24 * 3 + 25 * 3 + 1)
# k_keccak_round, per column (its 25 lanes together), on u32 halves: 24
# rounds of theta (5 lanes fold 5 parities: 4 xors a half; 25 lanes each
# a 2-funnel-shift rotation and 4 xors), rho (25 rotations: a 2-select
# swap and 2 funnel shifts), chi (25 x 3 a half) and iota (2)
KECCAK_ROUND = 24 * (5 * 4 * 2 + 25 * 6 + 25 * 4 + 25 * 3 * 2 + 2)

# device function of field.cuh: (own operations, {counted callee: call
# sites}); a templated callee is keyed by its arguments
HELPERS: dict[str, tuple[int, dict[str, int]]] = {
    "carry_tail": (CARRY_TAIL, {}),
    "fp_mul": (16 * 3 + 2 * 3, {"mul_cols<16,16>": 1, "carry_tail": 1}),
    "fp_sqr": (0, {"fp_mul": 1}),
    "fp_add": (16, {"carry_tail": 1}),
    "fp_sub": (16 * 3, {"carry_tail": 1}),
    "fp_neg": (0, {"fp_sub": 1}),
    "fp_mul_small": (16, {"carry_tail": 1}),
    "is_zero_mod": (16 * 4 + 1, {}),
    "select16": (16, {}),
    "jac_double": (0, {"fp_sqr": 5, "fp_mul": 2, "fp_add": 1, "fp_sub": 5,
                       "fp_mul_small": 5}),
    "jac_add_mixed": (3, {"fp_sqr": 3, "fp_mul": 8, "fp_sub": 6,
                          "fp_mul_small": 5, "is_zero_mod": 3,
                          "select16": 5, "jac_double": 1}),
    "sub_const_chain": (16 * 6, {}),
    "lt_const": (0, {"sub_const_chain": 1}),
    "cond_sub": (0, {"sub_const_chain": 1, "select16": 1}),
    "cond_sub_p": (0, {"cond_sub": 1}),
    "cond_sub_n": (0, {"cond_sub": 1}),
    "fn_mul": (0, {"mul_cols<16,16>": 1, "fn_red_cols<32>": 1}),
    "fn_sub": (16 * 3, {"fn_red_cols<16>": 1}),
    "is_zero": (16 * 2, {}),
    "fn_neg": (0, {"is_zero": 1, "fn_sub": 1, "select16": 1}),
    "keccak_words": (KECCAK, {}),
    "unpack_be": (16 * 2, {}),
    "recover_prelude": (92, {"is_zero": 2, "lt_const": 3, "fp_sqr": 1,
                             "fp_mul": 1, "carry_tail": 1}),
    "y_fix": (16 * 2 + 3, {"fp_sqr": 1, "cond_sub_p": 3, "fp_neg": 1,
                           "select16": 1}),
    "u1u2": (0, {"fn_red_cols<17>": 1, "fn_mul": 2, "fn_neg": 1}),
    "glv_sign_split": (9, {"fn_neg": 1, "select16": 1}),
    "glv_digits33": (33 * 2, {}),
    "glv_track": (0, {"mul_cols<16,16>": 6, "carry<32,32>": 2,
                      "fn_red_cols<32>": 4, "fn_sub": 3, "glv_sign_split": 2,
                      "glv_digits33": 2}),
    "limbs_to_words_be": (8 * 10, {}),
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


@functools.cache
def ops(name: str) -> int:
    """u32 operations of one call of a field.cuh function (``"fp_mul"``
    or a template instance such as ``"fn_red_cols<32>"``)."""
    if "<" in name:
        base, args = name[:-1].split("<")
        return TEMPLATES[base](*(int(a) for a in args.split(",")))
    own, calls = HELPERS[name]
    return own + sum(n * ops(callee) for callee, n in calls.items()
                     if (name, callee) not in DATA_DEPENDENT)


def per_row(windows: int = 33, negations: float = 0.0,
            ladder_doublings: float = 0.0) -> dict[str, float]:
    """u32 operations per row of each kernel (per padded row for
    glv_digits, recover_finish and keccak_rows, which cover Bpad).
    ``fn_red17`` counts one row of 17 columns, ``keccak_block`` one
    row of 34 words and ``keccak_rows_grid`` one column.  The rows8
    kernels do their default-layout twins' arithmetic per row.

    ``negations`` is the mean number of ladder adds per row whose point
    is negated (``windows`` x the rows' set sign flags), and
    ``ladder_doublings`` the mean number of ladder adds per row that meet
    equal points and so run the doubling path.  The point table doubles
    once on every row: its first entry is R + R.
    """
    mul, dbl, madd = ops("fp_mul"), ops("jac_double"), ops("jac_add_mixed")
    # the pow kernels: 14 table products, then 64 windows of 4 squarings
    # and one product
    pow_p, pow_n = (14 + 64 * 5) * mul, (14 + 64 * 5) * ops("fn_mul")
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
    }
