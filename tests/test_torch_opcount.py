"""The op count behind chip_smoke.py's bounds, held against the CUDA
source it counts: every device function of ``field.cuh`` makes exactly
the counted calls that ``eges_tpu_torch/ops/opcount.py`` lists for it
(the T-lane forms ``grp_*<T>`` included), and so does every kernel of
``verify.cu`` and ``glue.cu``; every kernel of ``tiling.cu`` and
``profile.cu`` has exactly the counted call sites listed for it, and so
does ``profile.cu``'s chain template; the point table of ``ladder.cu``
and the prelude, u1u2, GLV, fp_mul, fp_canon and finish kernels of
``recover.cu`` make the calls their lane counts count."""

from __future__ import annotations

import collections
import pathlib
import re

import pytest

from eges_tpu_torch.ops import opcount
from eges_tpu_torch.ops.bigint import N, P

FIELD_CUH = (pathlib.Path(__file__).resolve().parents[1] / "eges_tpu_torch"
             / "ops" / "csrc" / "field.cuh")
VERIFY_CU = FIELD_CUH.with_name("verify.cu")
GLUE_CU = FIELD_CUH.with_name("glue.cu")
TILING_CU = FIELD_CUH.with_name("tiling.cu")
PROFILE_CU = FIELD_CUH.with_name("profile.cu")
LADDER_CU = FIELD_CUH.with_name("ladder.cu")
RECOVER_CU = FIELD_CUH.with_name("recover.cu")
# functions of field.cuh that move values and count no operations
# (rotl64 is counted inside keccak_words' own operations; rows8_at is
# the address of a rows8 tile element)
UNCOUNTED = {"copy16", "zero16", "one16", "rotl64", "rows8_at", "load_rows8",
             "store_rows8"}

_DEF = re.compile(r"^(template\s*<[^>]*>\s*)?(?:EG_FD|EG_CALL)\s+[\w\s*]*?"
                  r"\b(\w+)\s*\(", re.M)
_CALL = re.compile(r"\b([A-Za-z_]\w*)\s*(<[^<>;(){}]*>)?\s*\(")


def _source(path=FIELD_CUH) -> str:
    return re.sub(r"//[^\n]*", "", path.read_text())


def _definitions(src: str) -> dict[str, tuple[bool, str]]:
    """name -> (is a template, body between its outer braces)."""
    out = {}
    for m in _DEF.finditer(src):
        start = src.index("{", m.end())
        depth, i = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
            if depth == 0:
                break
        out[m.group(2)] = (m.group(1) is not None, src[start:i])
    return out


def _counted_calls(body: str) -> collections.Counter:
    counted = set(opcount.HELPERS) | set(opcount.TEMPLATES) | set(
        opcount.GROUP)
    calls = collections.Counter()
    for m in _CALL.finditer(body):
        if m.group(1) in counted:
            targs = re.sub(r"\s+", "", m.group(2) or "")
            calls[m.group(1) + targs] += 1
    return calls


def _templates(path) -> set[str]:
    return {n for n, (tmpl, _) in _definitions(_source(path)).items()
            if tmpl}


def test_every_field_function_is_counted_or_moves_only():
    defs = _definitions(_source())
    plain = {n for n, (tmpl, _) in defs.items() if not tmpl}
    templates = {n for n, (tmpl, _) in defs.items() if tmpl}
    assert plain == set(opcount.HELPERS) | UNCOUNTED
    assert templates | _templates(PROFILE_CU) == (set(opcount.TEMPLATES)
                                                  | set(opcount.GROUP))


@pytest.mark.parametrize("name", sorted(opcount.HELPERS))
def test_helper_calls_match_the_source(name):
    _, body = _definitions(_source())[name]
    assert dict(_counted_calls(body)) == opcount.HELPERS[name][1]


@pytest.mark.parametrize("caller,callee", sorted(opcount.DATA_DEPENDENT))
def test_data_dependent_calls_run_under_a_branch(caller, callee):
    _, body = _definitions(_source())[caller]
    assert re.search(r"\bif\s*\(\s*\w+\s*\)\s*\{?\s*" + re.escape(callee)
                     + r"\s*\(", body)


@pytest.mark.parametrize("name", sorted(opcount.GROUP))
def test_group_form_calls_match_the_source(name):
    tmpl, body = _definitions(_source())[name]
    assert tmpl and dict(_counted_calls(body)) == opcount.GROUP[name][1]


@pytest.mark.parametrize("name", sorted(opcount.FORMULA_CALLS))
def test_formula_template_calls_match_the_source(name):
    tmpl, body = _definitions(_source())[name]
    assert tmpl and dict(_counted_calls(body)) == opcount.FORMULA_CALLS[name]


@pytest.mark.parametrize("group,one", [
    ("grp_fp_mul", "fp_mul"), ("grp_fp_sqr", "fp_sqr"),
    ("grp_fn_mul", "fn_mul"), ("grp_jac_double", "jac_double"),
    ("grp_jac_add_mixed", "jac_add_mixed")])
def test_one_lane_group_form_counts_as_the_one_thread_form(group, one):
    """T = 1 is the one-thread form: the same count; the one-thread point
    formulas are calls of it."""
    assert opcount.ops(f"{group}<1>") == opcount.ops(one)
    if one.startswith("jac_"):
        assert opcount.HELPERS[one] == (0, {f"{group}<1>": 1})


@pytest.mark.parametrize("T", [2, 4, 8])
def test_a_lane_issues_between_its_share_and_the_row(T):
    """A lane of a T-lane group issues less than the one thread of a row
    and at least the one thread's work over T (the share phase sass holds
    each lane's pow loop to); what a row needs, the bound's count, is no
    more than the one thread issues."""
    one, lane = opcount.per_lane(1), opcount.per_lane(T)
    for kernel in ("pow_mod_p", "pow_mod_n", "strauss_tab", "point_table",
                   "glv_digits", "fp_mul", "recover_finish",
                   "recover_prelude", "u1u2", "y_fix", "keccak_rows"):
        assert one[kernel] / T <= lane[kernel] < one[kernel]
    # fp_canon runs one lane a row: a lane has the row's work
    assert lane["fp_canon"] == one["fp_canon"] == opcount.per_row()[
        "fp_canon"]
    assert opcount.ops(f"grp_fp_sqr<{T}>") >= opcount.ops("fp_sqr") // T
    assert opcount.per_row()["strauss_tab"] < one["strauss_tab"]
    assert opcount.pow_row(P - 2, "p") < one["pow_mod_p"]
    assert opcount.pow_row(N - 2, "n") < one["pow_mod_n"]


def test_the_mixed_add_count_leaves_the_doubling_out():
    mul, sqr = opcount.ops("fp_mul"), opcount.ops("fp_sqr")
    assert sqr == mul - opcount.SQR_SAVED == 757
    assert opcount.ops("jac_double") == (
        5 * sqr + 2 * mul + opcount.ops("fp_add") + 5 * opcount.ops("fp_sub")
        + 5 * opcount.ops("fp_mul_small"))
    assert opcount.ops("jac_add_mixed") == (
        3 * sqr + 8 * mul + 6 * opcount.ops("fp_sub")
        + 5 * opcount.ops("fp_mul_small") + 3 * opcount.ops("is_zero_mod")
        + 5 * opcount.ops("select16") + 3)
    rows = opcount.per_row()
    add_sum = (2 * sqr + 5 * mul + 4 * opcount.ops("fp_sub")
               + 5 * opcount.ops("fp_mul_small") + 2 * opcount.ops("select16"))
    assert rows["point_table"] == (14 * opcount.ops("jac_add_mixed")
                                   + opcount.ops("jac_double") - add_sum)
    more = opcount.per_row(ladder_doublings=2.0)
    for ladder in ("strauss_tab", "strauss_tab_rows8"):
        assert more[ladder] - rows[ladder] == 2 * (
            opcount.ops("jac_double") - add_sum)


@pytest.mark.parametrize("e,want", [
    (P - 2, (14, 252, 63)), ((P + 1) // 4, (14, 252, 62)),
    (N - 2, (14, 252, 61)), (1, (0, 0, 0)), (0, (0, 0, 0)),
    (0x2 << 4, (1, 4, 0)), ((0x3 << 4 * 62) + 0x1, (2, 248, 1))])
def test_pow_work_leaves_out_products_by_one(e, want):
    """Table products up to the largest digit; squarings and products
    from the first nonzero digit on, none for a zero digit."""
    assert opcount.pow_work(e) == want


def test_pow_row_counts_its_products():
    mul, sqr = opcount.ops("fp_mul"), opcount.ops("fp_sqr")
    fn_mul = opcount.ops("fn_mul")
    assert opcount.pow_row(P - 2, "p") == 77 * mul + 252 * sqr
    assert opcount.pow_row(N - 2, "n") == (
        75 * fn_mul + 252 * (fn_mul - opcount.SQR_SAVED))
    with pytest.raises(ValueError):
        opcount.pow_row(P - 2, "q")


def test_ladder_counts_what_its_digits_need():
    """By default every digit is nonzero: window 0's doublings (of the
    point at infinity) and the first add (onto it) are left out; the
    caller's counts replace them."""
    dbl, madd = opcount.ops("jac_double"), opcount.ops("jac_add_mixed")
    neg = opcount.ops("fp_neg")
    assert opcount.per_row()["strauss_tab"] == 128 * dbl + 131 * madd
    got = opcount.per_row(doublings=100.0, adds=90.5, negations=3.0)
    assert got["strauss_tab"] == 100 * dbl + 90.5 * madd + 3 * neg


def test_point_table_lane_counts_its_doubling_and_13_adds():
    """``k_point_table_t<T>`` (ladder.cu) runs one doubling (entry 2R)
    and, in its 14-entry loop, the mixed add of the ladder; ``per_lane``
    counts 13 of those adds and the doubling."""
    src = _source(LADDER_CU)
    start = src.index("{", src.index("point_table_rows("))
    depth, i = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            break
    body = src[start:i]
    assert dict(_counted_calls(body)) == {"grp_jac_double<T>": 1,
                                          "grp_jac_add_mixed<T>": 1}
    assert re.search(r"for \(int d = 0; d < 14; \+\+d\)", body)
    for T in (1, 2, 4, 8):
        assert opcount.per_lane(T)["point_table"] == (
            13 * opcount.ops(f"grp_jac_add_mixed<{T}>")
            + opcount.ops(f"grp_jac_double<{T}>"))


def _template_body(path, name) -> str:
    """The body of the template function ``name`` of a kernel source,
    comments removed."""
    src = _source(path)
    start = src.index("{", src.index(name + "("))
    depth, i = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            break
    return src[start:i]


def _glv_lane_calls(T):
    """The group calls one lane of ``k_glv_digits_t<T>`` makes: both
    scalars' splits at T = 1, its half's over T / 2 lanes beyond."""
    return (2 if T == 1 else 1) * opcount.ops(
        f"grp_glv_track<{max(T // 2, 1)}>")


@pytest.mark.parametrize("body,calls,kernel,lane_calls", [
    ("fp_mul_rows", {"grp_fp_mul<T>": 1}, "fp_mul",
     lambda T: opcount.ops(f"grp_fp_mul<{T}>")),
    ("finish_rows", {"grp_recover_finish<T>": 1}, "recover_finish",
     lambda T: opcount.ops(f"grp_recover_finish<{T}>")),
    ("glv_half", {"grp_glv_track<H>": 1}, "glv_digits", _glv_lane_calls),
    ("k_fp_canon", {"cond_sub_p": 1}, "fp_canon",
     lambda T: opcount.ops("cond_sub_p")),
    ("prelude_rows", {"unpack_be": 3, "grp_recover_prelude<T>": 1},
     "recover_prelude", lambda T: 3 * opcount.ops("unpack_be")
     + opcount.ops(f"grp_recover_prelude<{T}>")),
    ("u1u2_rows", {"grp_u1u2<T>": 1}, "u1u2",
     lambda T: opcount.ops(f"grp_u1u2<{T}>")),
    ("y_fix_rows", {"grp_y_fix<T>": 1}, "y_fix",
     lambda T: opcount.ops(f"grp_y_fix<{T}>")),
    ("keccak_cols", {"keccak_words": 1, "grp_keccak_words<T>": 1},
     "keccak_rows", lambda T: opcount.ops(
         "keccak_words" if T == 1 else f"grp_keccak_words<{T}>"))])
def test_recover_lane_kernels_make_their_counted_calls(body, calls, kernel,
                                                      lane_calls):
    """``k_fp_mul_t<T>``, ``k_recover_finish_t<T>``, ``k_glv_digits_t<T>``,
    ``k_recover_prelude_t<T>`` (beside its three unpackings), ``k_u1u2_t<T>``,
    ``k_y_fix_t<T>``, ``k_keccak_rows_t<T>`` (keccak_words at T = 1, the
    pair's form beyond) and the tiled ``k_fp_canon`` (recover.cu) make one
    counted call a row (the GLV kernel one split a half-group, two written
    out at T = 1), which
    ``per_lane`` counts at each T, beside the digits the GLV lanes take
    from the magnitudes, and ``per_row`` at T = 1, the one-thread count."""
    src = _template_body(RECOVER_CU, body)
    assert dict(_counted_calls(src)) == calls
    for T in (1, 2, 4, 8):
        digits = (opcount.per_lane(T)[kernel] - lane_calls(T)
                  if kernel == "glv_digits" else 0)
        assert opcount.per_lane(T)[kernel] == lane_calls(T) + digits
        assert 0 <= digits <= 2 * 2 * opcount.GLV_DIGITS
    assert opcount.per_row()[kernel] == opcount.per_lane(1)[kernel]
    if kernel == "glv_digits":
        rows = _template_body(RECOVER_CU, "glv_rows")
        assert re.search(r"constexpr int H = T > 1 \? T / 2 : 1;", rows)
        assert len(re.findall(r"glv_half<1>\(u[12], ", rows)) == 2
        assert len(re.findall(r"glv_half<H>\(", rows)) == 1
        assert opcount.per_row()[kernel] == 2 * (
            opcount.ops("grp_glv_track<1>") + 2 * opcount.GLV_DIGITS)


def test_group_glv_split_counts_its_products_and_its_whole_steps():
    """grp_glv_track<T>: two products by 16-limb constants and four by the
    8-limb quotients shared out and summed, their carries, 24-column
    reductions, subtractions and sign splits whole in every lane; at T = 1
    the products are mul_cols<16, 16> and mul_cols<8, 16> and the carry
    keeps the top 8 limbs of 32 columns (39 operations)."""
    whole = (2 * opcount.ops("carry_top8") + 4 * opcount.fn_red_cols(24)
             + 3 * opcount.ops("fn_sub") + 2 * opcount.ops("glv_sign_split"))
    assert opcount.ops("carry_top8") == 39
    assert opcount.grp_cols(1, 8) == opcount.mul_cols(8, 16)
    assert opcount.ops("grp_glv_track<1>") == whole + (
        2 * opcount.mul_cols(16, 16) + 4 * opcount.mul_cols(8, 16))
    for T in (2, 4):
        assert opcount.ops(f"grp_glv_track<{T}>") == whole + (
            2 * opcount.grp_cols(T) + 4 * opcount.grp_cols(T, 8)
            + 2 * opcount.grp_sum(T, 32) + 4 * opcount.grp_sum(T, 24))


def test_group_finish_counts_its_products_and_its_whole_steps():
    """The finish's four products shared out, its canonicalisations,
    selects, zero test and words whole in every lane: at T = 1 the
    one-thread finish (4058, as before the lanes); more lanes take less of
    the products only."""
    whole = (2 + opcount.ops("is_zero_mod") + 3 * opcount.ops("cond_sub_p")
             + 4 * opcount.ops("select16")
             + 2 * opcount.ops("limbs_to_words_be"))
    for T in (1, 2, 4, 8):
        assert opcount.ops(f"grp_recover_finish<{T}>") == whole + (
            opcount.ops(f"grp_fp_sqr<{T}>") + 3 * opcount.ops(
                f"grp_fp_mul<{T}>"))
    assert opcount.per_row()["recover_finish"] == (
        whole + opcount.ops("fp_sqr") + 3 * opcount.ops("fp_mul")) == 4058


def test_group_prelude_and_u1u2_count_their_lanes():
    """At T = 1 the prelude's and u1u2's group forms count as the
    one-thread functions they replace: the checks, x and t[0] + 7 (60), the
    square and the product of y^2; u1u2's reduction of z, two products
    and the negation (5,369).  At T >= 2 a prelude lane shares both
    products; a u1u2 lane runs the reduction, the selects and the
    negation whole and shares one product over T / 2 lanes."""
    whole = (60 + 2 * opcount.ops("is_zero") + 3 * opcount.ops("lt_const")
             + opcount.CARRY_TAIL)
    assert opcount.ops("grp_recover_prelude<1>") == (
        whole + opcount.ops("fp_sqr") + opcount.ops("fp_mul"))
    assert opcount.ops("grp_u1u2<1>") == (
        opcount.fn_red_cols(17) + 2 * opcount.ops("fn_mul")
        + opcount.ops("fn_neg")) == 5369
    for T in (2, 4, 8):
        assert opcount.ops(f"grp_recover_prelude<{T}>") == whole + (
            opcount.ops(f"grp_fp_sqr<{T}>") + opcount.ops(f"grp_fp_mul<{T}>"))
        assert opcount.ops(f"grp_u1u2<{T}>") == (
            opcount.fn_red_cols(17) + 2 * opcount.ops("select16")
            + opcount.ops(f"grp_fn_mul<{T // 2}>") + opcount.ops("fn_neg"))


def test_the_sum_runs_only_where_the_points_differ():
    """The calls of grp_jac_add_mixed's else branch (the sum) are
    ADD_SUM_CALLS; its doubling branch holds the doubling alone."""
    _, body = _definitions(_source())["grp_jac_add_mixed"]
    m = re.search(r"if \(dbl\) \{(.*?)\} else \{(.*?)\n  \}", body, re.S)
    assert dict(_counted_calls(m.group(1))) == {"grp_jac_double<T>": 1}
    assert dict(_counted_calls(m.group(2))) == opcount.ADD_SUM_CALLS


_KERNEL = re.compile(r"__global__\s+void\s+__launch_bounds__\(\w+\)\s*"
                     r"(k_\w+)\s*\(")


def _kernel_bodies(path) -> dict[str, str]:
    """``__global__`` function name -> its body, comments removed."""
    src = re.sub(r"//[^\n]*", "", path.read_text())
    out = {}
    for m in _KERNEL.finditer(src):
        start = src.index("{", m.end())
        depth, i = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
            if depth == 0:
                break
        out[m.group(1)] = src[start:i]
    return out


def test_every_verify_kernel_is_counted():
    assert set(_kernel_bodies(VERIFY_CU)) == {
        fn for fn, _ in opcount.VERIFY_KERNELS.values()}


@pytest.mark.parametrize("name", sorted(opcount.VERIFY_KERNELS))
def test_verify_kernel_calls_match_the_source(name):
    fn, calls = opcount.VERIFY_KERNELS[name]
    assert dict(_counted_calls(_kernel_bodies(VERIFY_CU)[fn])) == calls


def test_verify_kernel_counts():
    rows = opcount.per_row()
    assert rows["fn_mul"] == (opcount.mul_cols(16, 16)
                              + opcount.fn_red_cols(32)) == 2315
    assert rows["fn_red17"] == opcount.fn_red_cols(17) == 375
    assert rows["fp_add"] == 16 + opcount.CARRY_TAIL == 93
    assert rows["keccak_block"] == rows["keccak_rows"] == opcount.KECCAK
    assert opcount.KECCAK == 24 * 180 == 4320


def test_every_glue_kernel_is_counted():
    assert set(_kernel_bodies(GLUE_CU)) == {
        fn for fn, _ in opcount.GLUE_KERNELS.values()}


@pytest.mark.parametrize("name", sorted(opcount.GLUE_KERNELS))
def test_glue_kernel_calls_match_the_source(name):
    fn, calls = opcount.GLUE_KERNELS[name]
    assert dict(_counted_calls(_kernel_bodies(GLUE_CU)[fn])) == calls


def test_glue_kernel_counts():
    rows = opcount.per_row()
    sub = 16 * 2 + opcount.CARRY_TAIL
    assert rows["fp_sub"] == rows["fp_neg"] == sub == 109
    assert rows["fp_mul_small"] == 16 + opcount.CARRY_TAIL == 93
    assert rows["fn_sub"] == 16 * 2 + opcount.fn_red_cols(16) == 332
    assert rows["fn_neg"] == (rows["fn_sub"] + opcount.ops("is_zero")
                              + opcount.ops("select16")) == 364
    assert rows["mulhi8"] == (opcount.mul_cols(16, 16)
                              + opcount.carry(32, 32)) == 951


def test_every_tiling_kernel_is_counted():
    assert set(_kernel_bodies(TILING_CU)) == {
        fn for fn, _ in opcount.TILING_KERNELS.values()}


@pytest.mark.parametrize("name", sorted(opcount.TILING_KERNELS))
def test_tiling_kernel_calls_match_the_source(name):
    fn, calls = opcount.TILING_KERNELS[name]
    assert dict(_counted_calls(_kernel_bodies(TILING_CU)[fn])) == calls


def test_tiling_kernel_counts():
    """The rows8 kernels do their default-layout twins' arithmetic per
    row; the round kernel counts its 25 lanes' operations per column."""
    rows = opcount.per_row(negations=5.0, ladder_doublings=1.0)
    # both pows and both ladders compute one function each: the rows8
    # twins' bounds count what it needs (pow_row, per_row's ladder)
    assert rows["strauss_tab_rows8"] == rows["strauss_tab"]
    theta = 5 * 2 * 2 + 25 * (2 + 2)
    assert rows["keccak_rows_grid"] == opcount.KECCAK_ROUND == (
        24 * (theta + 25 * 4 + 25 * 2 + 2)) == 6528


def test_every_profile_kernel_is_counted():
    assert set(_kernel_bodies(PROFILE_CU)) == {
        fn for fn, _ in opcount.PROFILE_KERNELS.values()}


@pytest.mark.parametrize("name", sorted(opcount.PROFILE_KERNELS))
def test_profile_kernel_calls_match_the_source(name):
    fn, calls = opcount.PROFILE_KERNELS[name]
    assert dict(_counted_calls(_kernel_bodies(PROFILE_CU)[fn])) == calls


def test_profile_chain_template_matches_the_source():
    assert _templates(PROFILE_CU) == {"mul_chain_rows8"}
    _, body = _definitions(_source(PROFILE_CU))["mul_chain_rows8"]
    assert dict(_counted_calls(body)) == {"fp_mul": 1}
    assert re.search(r"#pragma unroll 1\s*for \(int i = 0; i < CHAIN;",
                     PROFILE_CU.read_text())


@pytest.mark.parametrize("count,want", [
    (lambda: opcount.adds(1), 0), (lambda: opcount.adds(2), 1),
    (lambda: opcount.adds(4), 2), (lambda: opcount.mul_cols(1, 9), 27),
    (lambda: opcount.mul_cols(2, 2), 13),
    (lambda: opcount.carry(16, 17), 32), (lambda: opcount.carry(3, 5), 7)])
def test_issued_instruction_rules(count, want):
    """Three-input adds; a pair's product and mask plus its column's
    shift-adds and adds (2 x 2: 8 + columns 0, 2, 2, 1); a carry chain's
    masks and fused shift-adds, one extract a limb past the columns."""
    assert count() == want


def test_profile_kernel_counts():
    """fp_mul is its folds' 32 + mul_cols<16,16> 888 + carry_tail 77 =
    997 instructions a row; the chains run 64 of them."""
    rows = opcount.per_row()
    assert opcount.mul_cols(16, 16) == 888 and opcount.CARRY_TAIL == 77
    assert opcount.ops("fp_mul") == 32 + 888 + 77 == 997
    assert rows["fp_mul_chain"] == rows["fp_mul_chain_rows8"] == (
        opcount.PROFILE_CHAIN * 997) == 63808
    assert rows["fp_mul_rows8"] == rows["fp_mul"] == 997
    assert rows["add_one_f32"] == 1
    assert rows["mul_scalar_f32"] == 1


def test_group_y_fix_and_keccak_count_their_lanes():
    """y_fix's group form at T = 1 counts as the one-thread y_fix it
    replaces (1,094: the square, three canonicalisations, the compare,
    the negation and the select); more lanes take less of the square
    only.  A Keccak lane of a pair (T >= 2) issues half of each of a
    round's 180 operations and 29 shuffles (119 a round), the lanes past
    the pair (T = 4, 8) the same again; one lane a column the whole
    4,320."""
    whole = (17 + 3 * opcount.ops("cond_sub_p") + opcount.ops("fp_neg")
             + opcount.ops("select16"))
    assert opcount.per_row()["y_fix"] == whole + opcount.ops("fp_sqr") == 1094
    for T in (1, 2, 4, 8):
        assert opcount.ops(f"grp_y_fix<{T}>") == whole + opcount.ops(
            f"grp_fp_sqr<{T}>")
    round_ops = opcount.KECCAK // 24
    assert round_ops == 180 and opcount.per_row()["keccak_rows"] == 4320
    assert opcount.KECCAK_PAIR == 24 * (round_ops // 2 + 29) == 2856
    for T in (2, 4, 8):
        assert opcount.per_lane(T)["keccak_rows"] == opcount.KECCAK_PAIR


def test_keccak_pair_loop_takes_the_counted_rounds_a_trip():
    """Phase sass takes the round loop of grp_keccak_words 24 /
    KECCAK_UNROLL times and keccak_words' 24: the pragmas in field.cuh are
    those."""
    src = _source()
    defs = _definitions(src)
    assert re.search(r"#pragma unroll %d\s+for \(int rnd = 0; rnd < "
                     r"24; \+\+rnd\)" % opcount.KECCAK_UNROLL,
                     defs["grp_keccak_words"][1])
    assert re.search(r"#pragma unroll 1\s+for \(int rnd = 0; rnd < 24; "
                     r"\+\+rnd\)", defs["keccak_words"][1])
    assert 24 % opcount.KECCAK_UNROLL == 0
