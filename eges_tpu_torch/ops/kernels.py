"""The twenty-nine kernels of batched sender recovery, classic ECDSA
verify, one-block keccak256, the un-fused (stacked and single-row)
recovery and verify path, the reference's TPU-tiling configuration, the
profiling harness's micro-benchmarks and the analysis fixture's scalar
multiply, each with its plain PyTorch version and its launch count.

Every public function keeps the name, signature and array layouts of
the reference wrapper in ``eges_tpu/ops/pallas_kernels.py`` it replaces,
so tests compare array with array.  Limb and word tensors are
``torch.int32`` (read as ``uint32_t`` by the kernels); wire bytes are
``torch.uint8``.  ``Bpad`` is the batch rounded up to a multiple of the
lane block, the reference's ``LANE_BLOCK`` (:func:`lane_block`).

A wrapper given CUDA tensors launches its kernel from ``csrc/recover.cu``,
``csrc/verify.cu``, ``csrc/glue.cu``, ``csrc/tiling.cu`` or
``csrc/profile.cu`` on the current stream and adds one to
``LAUNCHES[name]``; given CPU tensors it runs the plain version
(``*_plain``), which repeats the kernel's arithmetic with
``ops/field.py`` and is also what ``chip_smoke.py`` holds each kernel
against on the card.  There is no
fallback from one to the other.

What bounds each kernel on the H100: the work is 16-bit limb products
and carry chains on u32, one thread per row.  The card issues about ten
u32 operations in the time it moves one byte of device memory.
``fp_mul``, ``fp_canon``, ``recover_prelude``, ``y_fix``,
``recover_finish``, ``fp_add``, ``fn_red17`` and the glue kernels
``fp_sub``, ``fp_neg``, ``fp_mul_small``, ``fn_sub``, ``fn_neg`` and
``mulhi8`` (only just) issue fewer than that per byte they read and
write (``ops/opcount.py``), so bytes bound them; the other eleven issue
more (the pow and ladder kernels several hundred times more) and integer
operations bound them.  Each reads its
inputs and writes its outputs once and keeps every intermediate in
registers.  ``PERF.md`` has each one's time beside its bound.  The pow,
the point table and the ladder, nearly all of a recovery's card time,
and the prelude, ``y_fix``, ``u1u2``, the GLV split, ``fp_mul``, the
finish and ``keccak_rows`` (a column) run a group of T lanes a row
(``csrc/field.cuh`` ``grp_*``), so that a batch puts more warps on more
SMs; :func:`lanes_for` picks T and the block size from the row count,
and :func:`recover_prelude_lanes`, :func:`pow_mod_lanes`,
:func:`y_fix_lanes`, :func:`u1u2_lanes`, :func:`point_table_lanes`,
:func:`strauss_tab_lanes`, :func:`glv_digits_lanes`,
:func:`fp_mul_lanes`, :func:`fp_canon_lanes` (one lane a row, any block
size), :func:`recover_finish_lanes` and :func:`keccak_rows_lanes` launch
any instance (every one gives the same bits).  The prelude, ``y_fix``,
``u1u2``, ``fp_mul`` and ``fp_canon`` move their rows through shared
memory, so that device memory sees 16-byte accesses, neighbour to
neighbour.

The tiling configuration is the reference's: ``EGES_TPU_LANE_BLOCK``
sets the lane block, ``EGES_TPU_ROWS8=1`` sends ``pow_mod_pallas`` and
``strauss_tab`` to their rows8 kernels (values re-laid into (8, 128)
tiles of 1024 rows, see :func:`to_rows8`), and
``EGES_TPU_KECCAK_GRID=1`` sends ``keccak_rows_pallas`` and
``keccak_block_pallas`` to the round kernel, which leaves the whole
50-word state.  Each has a CUDA kernel of its own in ``csrc/tiling.cu``
and a launch count of its own, so a run shows which layout it took.

The harness's kernels (``csrc/profile.cu``, ``eges_tpu_torch/harness/``)
time F_P multiplies in both layouts: 64 chained products on ``[16, B]``
limb-major columns (:func:`fp_mul_chain_pallas`) and on rows8 tiles
(:func:`fp_mul_chain_rows8`), one product on tiles
(:func:`fp_mul_rows8`), and the cost of one hand-written launch
(:func:`add_one_f32`, ``x + 1.0``).  Beside them, :func:`mul_scalar_f32`
(``x * s``) is the counterpart of the reference's launch-purity fixture
kernel, whose ``s`` was the host clock burned into a trace; here ``s``
is an argument, and the kernel streams 16-byte accesses.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from eges_tpu_torch.ops import build, curve, field
from eges_tpu_torch.ops.field import NLIMBS, int_to_limbs
from eges_tpu_torch.ops.opcount import PROFILE_CHAIN

POW_WINDOWS = 64
ROWS8_BLOCK = 1024  # rows of one rows8 tile: 8 sublanes x 128 lanes
M32 = 0xFFFFFFFF

KERNELS = ("recover_prelude", "pow_mod", "y_fix", "u1u2", "glv_digits",
           "point_table", "fp_mul", "fp_canon", "strauss_tab",
           "recover_finish", "keccak_rows", "fn_mul", "fn_red17", "fp_add",
           "keccak_block", "pow_mod_rows8", "strauss_tab_rows8",
           "keccak_rows_grid", "fp_mul_chain", "fp_mul_chain_rows8",
           "fp_mul_rows8", "add_one_f32", "mul_scalar_f32", "fp_sub",
           "fp_neg", "fp_mul_small", "fn_sub", "fn_neg", "mulhi8")

# launches of each kernel since the last reset_launches()
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in KERNELS:
            LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the configuration (pallas_kernels.py:73-78, 772-783, 1777)
# ---------------------------------------------------------------------------

def lane_block() -> int:
    """Batch columns per lane block: ``EGES_TPU_LANE_BLOCK`` (256 unless
    set), a positive multiple of 128, else ``ValueError``.  The reference
    reads the variable once, when ``pallas_kernels`` is imported; this
    reads it at every call, so one process (the tests,
    ``chip_smoke.py``) can run both configurations between calls."""
    block = int(os.environ.get("EGES_TPU_LANE_BLOCK", "256"))
    if block <= 0 or block % 128:
        raise ValueError(
            f"EGES_TPU_LANE_BLOCK={block}: must be a positive multiple "
            "of 128 (TPU lane width)")
    return block


def rows8_enabled() -> bool:
    """``EGES_TPU_ROWS8=1``: the pow and ladder kernels take rows8 tiles.
    Raises unless the lane block is a multiple of ROWS8_BLOCK."""
    if os.environ.get("EGES_TPU_ROWS8", "") != "1":
        return False
    block = lane_block()
    if block % ROWS8_BLOCK:
        raise ValueError(
            "EGES_TPU_ROWS8=1 requires EGES_TPU_LANE_BLOCK to be a "
            f"multiple of {ROWS8_BLOCK} (got {block}) so every "
            "padded batch width re-lays into (8, 128) tiles")
    return True


def keccak_grid_enabled() -> bool:
    """``EGES_TPU_KECCAK_GRID=1``: keccak goes through the round kernel."""
    return os.environ.get("EGES_TPU_KECCAK_GRID", "") == "1"


def bpad(b: int) -> int:
    """``b`` rounded up to a multiple of the lane block."""
    block = lane_block()
    return -(-b // block) * block


# ---------------------------------------------------------------------------
# lanes a row of the prelude, pow, y_fix, u1u2, point-table, ladder, GLV,
# fp_mul, finish and keccak_rows kernels, and the block size of fp_canon
# (csrc/recover.cu, ladder.cu)
# ---------------------------------------------------------------------------

LANES = build.LANES            # the instances of each kernel
LANE_THREADS = (64, 128, 256)   # the block sizes they take
# the widest row pitch, in bytes, the prelude's kernel reads in place
# (csrc/recover.cu EG_PRELUDE_MAX_PITCH)
PRELUDE_MAX_PITCH = 256
# kernel -> ((most rows, lanes, threads), ...): the first entry whose row
# limit the row count does not pass (None: no limit).  From the sweep of
# chip_smoke.py phase lanes (PERF.md has its times), the fastest instance
# at each swept count: the ladder and the point table at 256, 1024, 4096
# and 8192 rows, the pow at the same counts and at 16384 and 131072 rows
# (mod P: its table launches).  The fastest lanes are about the most
# whose rows * lanes threads still run in one wave; past 8192 rows, where
# the main path launches no pow mod N, that one keeps one lane a row; the
# ladder keeps T = 4 (T = 2 spills a few bytes), and so does the point
# table (T = 8 takes two waves there).  fp_mul and the finish are swept
# at the same counts (fp_mul also at 16384 and 131072) on cold times: a
# launch of either takes less than the wrapper's host time, which back
# to back events would measure.  fp_mul takes 4 lanes a row up to 8192
# rows, some 8% faster than one, 2 up to 16384, and one lane in blocks
# of 64 past them, where bytes bound it and one lane was 2-3% faster
# than two (131072 rows, PERF.md: two calls on an H100); the finish takes 4 lanes in blocks of 128 at
# every count (within 2% of the fastest, about 1.5x faster than one).
# The GLV split, swept at 256-8192 rows on cold times, takes 4 lanes (two
# a scalar) in blocks of 128 at every count: within 1% of the fastest,
# about 3.5-4x faster than one lane; 8 lanes add shuffles to a chain
# whose reductions every lane runs whole.  fp_canon, one lane a row,
# takes blocks of 64 at every count (256-131072 rows).  The prelude and
# u1u2, swept at 256-8192 rows on cold times, take 8 lanes in blocks of
# 128 up to 1024 rows; beyond, the prelude 4 in blocks of 64 and u1u2 8
# in blocks of 64 up to 4096 rows and 4 in blocks of 64 past them (8 lanes
# a row there issue twice a 4-lane group's instructions: every lane runs
# u1u2's reductions whole).  y_fix, swept at 256-8192 rows on cold times,
# takes 8 lanes in blocks of 64 up to 1024 rows, 4 up to 4096 and 2
# beyond, 7-15% faster than one lane (bytes and the tiles' round trip
# bound it); keccak_rows takes a pair of lanes a column in blocks of 64
# at every count, 10-14% faster than one lane: 4 and 8 lanes repeat the
# pair's chain on more warps.
LANES_RULE = {
    "strauss_tab": ((256, 4, 128), (4096, 8, 64), (None, 4, 256)),
    "point_table": ((1024, 8, 128), (4096, 8, 256), (None, 4, 256)),
    "pow_mod_p": ((2048, 8, 64), (4096, 4, 64), (8192, 2, 128),
                  (16384, 1, 128), (None, 1, 256)),
    "pow_mod_n": ((256, 4, 128), (2048, 8, 64), (4096, 4, 128),
                  (8192, 2, 128), (None, 1, 128)),
    "fp_mul": ((8192, 4, 64), (16384, 2, 64), (None, 1, 64)),
    "recover_finish": ((None, 4, 128),),
    "glv_digits": ((None, 4, 128),),
    "fp_canon": ((None, 1, 64),),
    "recover_prelude": ((1024, 8, 128), (None, 4, 64)),
    "u1u2": ((1024, 8, 128), (4096, 8, 64), (None, 4, 64)),
    "y_fix": ((1024, 8, 64), (4096, 4, 64), (None, 2, 64)),
    "keccak_rows": ((None, 2, 64),),
}


def lanes_for(kernel: str, rows: int, device="cuda") -> tuple[int, int]:
    """``(lanes a row, threads a block)`` of ``kernel`` (a key of
    ``LANES_RULE``: ``"strauss_tab"``, ``"point_table"``, ``"pow_mod_p"``,
    ``"pow_mod_n"``, ``"glv_digits"``, ``"fp_mul"``, ``"fp_canon"`` (one
    lane a row), ``"recover_finish"``, ``"recover_prelude"``, ``"u1u2"``,
    ``"y_fix"`` or ``"keccak_rows"`` (columns)) at ``rows`` rows: the one
    rule
    the wrappers launch by.  A CPU device takes the
    plain version, whose arithmetic is one thread's: ``(1, 128)``."""
    if rows <= 0:
        raise ValueError("rows must be positive")
    if torch.device(device).type != "cuda":
        return 1, 128
    for most, lanes, threads in LANES_RULE[kernel]:
        if most is None or rows <= most:
            return lanes, threads
    raise AssertionError(f"{kernel}: the rule has no entry for {rows} rows")


def _check_lanes(lanes: int, threads: int) -> None:
    if lanes not in LANES or threads not in LANE_THREADS:
        raise ValueError(f"lanes must be one of {LANES} and threads one of "
                         f"{LANE_THREADS}, got {lanes} and {threads}")


# ---------------------------------------------------------------------------
# the rows8 layout (pallas_kernels.py:800-818, 958-965)
# ---------------------------------------------------------------------------

def lay_rows8(rows: torch.Tensor) -> torch.Tensor:
    """``[R, wide]`` limb-major rows (wide a ROWS8_BLOCK multiple) ->
    ``[nb, R*8, 128]``: row ``r*8 + sublane`` of tile ``blk`` holds
    column ``blk*1024 + sublane*128 + lane``.  The strauss re-lay of the
    signs and the R tables (the reference's ``lay``)."""
    R, wide = rows.shape
    nb = wide // ROWS8_BLOCK
    return (rows.reshape(R, nb, 8, 128).permute(1, 0, 2, 3)
            .reshape(nb, R * 8, 128).contiguous())


def unlay_rows8(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`lay_rows8`: ``[nb, R*8, 128] -> [R, wide]``."""
    nb, r8, _ = t.shape
    return (t.reshape(nb, r8 // 8, 8, 128).permute(1, 0, 2, 3)
            .reshape(r8 // 8, nb * ROWS8_BLOCK).contiguous())


def to_rows8(a: torch.Tensor) -> torch.Tensor:
    """``[B, 16]`` (B a ROWS8_BLOCK multiple) -> ``[nb, 128, 128]`` with
    row ``limb*8 + sublane``; batch row b = blk*1024 + s*128 + l."""
    return lay_rows8(a.T)


def from_rows8(t: torch.Tensor, B: int) -> torch.Tensor:
    """``[nb, 128, 128]`` tiles -> the first ``B`` rows as ``[B, 16]``."""
    return unlay_rows8(t).T[:B].contiguous()


def pad_rows8(a: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``[B, 16]`` -> (zero rows appended to a ROWS8_BLOCK multiple, B)."""
    B = a.shape[0]
    return F.pad(a, (0, 0, 0, (-B) % ROWS8_BLOCK)), B


def lay_digits_rows8(dig: torch.Tensor) -> torch.Tensor:
    """``[W, 8, wide]`` ladder digits -> ``[nb, W, 64, 128]``: digit row
    t of window w at row ``t*8 + sublane`` of ``[blk, w]``."""
    W, _, wide = dig.shape
    return lay_rows8(dig.reshape(W * 8, wide)).reshape(
        wide // ROWS8_BLOCK, W, 64, 128)


# ---------------------------------------------------------------------------
# the reference's numpy uint32 arrays <-> the port's int32 tensors
# ---------------------------------------------------------------------------

def from_reference(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy uint32 array (any layout: ``[B, 16]`` rows or ``[rows,
    Bpad]`` limb-major) -> int32 tensor with the same bits and shape."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_reference(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array with the same bits and shape."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32).copy()


def _u(t: torch.Tensor) -> torch.Tensor:
    """int32 (or uint8) -> int64 holding the unsigned value."""
    return t.to(torch.int64) & M32


def _i(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the low 32 bits (wraps)."""
    return t.to(torch.int32)


def _one(rows: int, device) -> torch.Tensor:
    one = torch.zeros(rows, NLIMBS, dtype=torch.int64, device=device)
    one[:, 0] = 1
    return one


def pow_digits(e: int) -> bytes:
    """The 64 four-bit digits of a constant exponent, MSD first."""
    if e < 0 or e.bit_length() > 4 * POW_WINDOWS:
        raise ValueError("exponent must fit 256 bits")
    return bytes((e >> (4 * (POW_WINDOWS - 1 - w))) & 0xF
                 for w in range(POW_WINDOWS))


# ---------------------------------------------------------------------------
# plain versions (nothing here has a gradient: inference mode trims the
# per-operation overhead that bounds them on small batches)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def recover_prelude_plain(sigs, hashes):
    s = sigs[:, :65].to(torch.int64)
    r = field.unpack_be(s, 0)
    sv = field.unpack_be(s, 32)
    v = s[:, 64]
    z = field.unpack_be(hashes.to(torch.int64), 0)
    x, y_sq, ok = field.recover_prelude(r, sv, v)
    return tuple(_i(t) for t in (x, y_sq, ok, r, sv, z, v))


@torch.inference_mode()
def pow_mod_plain(a, e: int, modulus: str):
    return _pow_rows(a, e, modulus)


def _pow_rows(a, e: int, modulus: str):
    """The pow kernels' arithmetic on ``[M, 16]`` rows (shared by the
    plain versions of both layouts)."""
    mul = field.mul if modulus == "p" else field.fn_mul
    A = _u(a)
    one = _one(A.shape[0], A.device)
    tab = [one, A]
    cur = A
    for _ in range(2, 16):
        cur = mul(cur, A)
        tab.append(cur)
    acc = one
    for d in pow_digits(e):
        for _ in range(4):
            acc = mul(acc, acc)
        acc = mul(acc, tab[d])
    return _i(acc)


@torch.inference_mode()
def y_fix_plain(root, y_sq, v):
    y, ok = field.y_fix(_u(root), _u(y_sq), _u(v))
    return _i(y), _i(ok)


@torch.inference_mode()
def u1u2_plain(z, s, r_inv):
    u1, u2 = field.u1u2(_u(z), _u(s), _u(r_inv))
    return _i(u1), _i(u2)


@torch.inference_mode()
def glv_digits_plain(u1, u2):
    B = u1.shape[0]
    wide = bpad(B)
    consts = curve.glv_consts()
    dig = torch.zeros(curve.GLV_WINDOWS, 8, wide, dtype=torch.int64,
                      device=u1.device)
    neg = torch.zeros(8, wide, dtype=torch.int64, device=u1.device)
    for half, u in enumerate((u1, u2)):
        U = F.pad(_u(u), (0, 0, 0, wide - B))
        d1, n1, d2, n2 = field.glv_track(U, consts)
        dig[:, 2 * half] = d1.T
        dig[:, 2 * half + 1] = d2.T
        neg[2 * half] = n1
        neg[2 * half + 1] = n2
    return _i(dig), _i(neg)


@torch.inference_mode()
def point_table_plain(px, py):
    PX, PY = _u(px), _u(py)
    X, Y, Z = PX, PY, _one(PX.shape[0], PX.device)
    outs = []
    for _ in range(14):
        X, Y, Z = field.jac_add_mixed(X, Y, Z, PX, PY)
        outs.append((X, Y, Z))
    return tuple(_i(torch.stack([o[c] for o in outs])) for c in range(3))


@torch.inference_mode()
def fp_mul_plain(a, b):
    return _i(field.mul(_u(a), _u(b)))


@torch.inference_mode()
def fp_canon_plain(a):
    return _i(field.cond_sub_p(_u(a)))


@functools.lru_cache(maxsize=4)
def _g_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    tgx, tgy = curve._g_table16()
    tlx, _ = curve._g_lam_table16()
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device)
                 for t in (tgx, tgy, tlx))


@torch.inference_mode()
def strauss_tab_plain(dig, neg, trx, tlrx, try_, batch: int):
    return _ladder(dig, neg, trx, tlrx, try_, batch)


def _ladder(dig, neg, trx, tlrx, try_, batch: int):
    """The ladder kernels' arithmetic at strauss_tab's layout (shared by
    the plain versions of both layouts)."""
    B = batch
    W = dig.shape[0]
    D = _u(dig[:, :4, :B])
    NG = _u(neg[:4, :B])
    gx, gy, lx = _g_tables(dig.device)

    def entries(rows):  # [256, Bpad] -> [B, 16 entries, 16 limbs]
        return _u(rows[:, :B]).reshape(16, NLIMBS, B).permute(2, 0, 1)

    tr, tlr, ty = entries(trx), entries(tlrx), entries(try_)
    ar = torch.arange(B, device=dig.device)
    X = torch.zeros(B, NLIMBS, dtype=torch.int64, device=dig.device)
    Y = _one(B, dig.device)
    Z = torch.zeros_like(X)
    for w in range(W):
        for _ in range(4):
            X, Y, Z = field.jac_double(X, Y, Z)
        for t in range(4):
            d = D[w, t]
            if t == 0:
                px, py = gx[d], gy[d]
            elif t == 1:
                px, py = lx[d], gy[d]
            else:
                px = (tr if t == 2 else tlr)[ar, d]
                py = ty[ar, d]
            py = field.select(NG[t], field.neg(py), py)
            AX, AY, AZ = field.jac_add_mixed(X, Y, Z, px, py)
            nz = d != 0
            X = field.select(nz, AX, X)
            Y = field.select(nz, AY, Y)
            Z = field.select(nz, AZ, Z)
    return _i(X), _i(Y), _i(Z)


@torch.inference_mode()
def recover_finish_plain(X, Y, Z, zi_raw, ok_in):
    B = X.shape[0]
    pad = bpad(B) - B
    rows = [F.pad(_u(t), (0, 0, 0, pad)) for t in (X, Y, Z, zi_raw)]
    qx, qy, ok, words = field.recover_finish(*rows, F.pad(_u(ok_in),
                                                          (0, pad)))
    return _i(qx[:B]), _i(qy[:B]), _i(ok[:B]), _i(words.T.contiguous())


@torch.inference_mode()
def keccak_rows_plain(words):
    return _i(field.keccak_words(_u(words).T).T.contiguous())


@torch.inference_mode()
def fn_mul_plain(a, b):
    return _i(field.fn_mul(_u(a), _u(b)))


@torch.inference_mode()
def fn_red17_plain(a):
    return _i(field.fn_red_cols(_u(a)))


@torch.inference_mode()
def fp_add_plain(a, b):
    return _i(field.add(_u(a), _u(b)))


@torch.inference_mode()
def keccak_block_plain(words):
    return _i(field.keccak_words(_u(words)))


@torch.inference_mode()
def fp_sub_plain(a, b):
    return _i(field.sub(_u(a), _u(b)))


@torch.inference_mode()
def fp_neg_plain(a):
    return _i(field.neg(_u(a)))


@torch.inference_mode()
def fp_mul_small_plain(a, k: int):
    return _i(field.mul_small(_u(a), k))


@torch.inference_mode()
def fn_sub_plain(a, b):
    return _i(field.fn_sub(_u(a), _u(b)))


@torch.inference_mode()
def fn_neg_plain(a):
    return _i(field.fn_neg(_u(a)))


@torch.inference_mode()
def mulhi8_plain(a, g: int):
    return _i(field.mulhi8(_u(a), _g_limbs(g)))


def _tiles_of(rows: torch.Tensor, nb: int) -> torch.Tensor:
    """``[B, 16]`` -> ``nb`` rows8 tiles, the rows past B zero."""
    return to_rows8(F.pad(rows, (0, 0, 0, nb * ROWS8_BLOCK - rows.shape[0])))


@torch.inference_mode()
def pow_mod_rows8_plain(at, e: int, modulus: str, rows: int):
    """``[nb, 128, 128]`` rows8 tiles -> tiles of the per-row ``a^e`` of
    the first ``rows`` rows, the other rows zero."""
    return _tiles_of(_pow_rows(from_rows8(at, rows), e, modulus),
                     at.shape[0])


@torch.inference_mode()
def strauss_tab_rows8_plain(digl, negl, trl, tlrl, tyl, batch: int):
    """The ladder over rows8-laid inputs (``[nb, W, 64, 128]`` digits,
    ``[nb, 64, 128]`` signs, ``[nb, 2048, 128]`` tables) -> Jacobian
    ``(X, Y, Z)`` of the first ``batch`` rows as ``[nb, 128, 128]``
    tiles, the other rows zero."""
    nb, W = digl.shape[:2]
    wide = nb * ROWS8_BLOCK
    dig = unlay_rows8(digl.reshape(nb, W * 64, 128)).reshape(W, 8, wide)
    outs = _ladder(dig, unlay_rows8(negl), unlay_rows8(trl),
                   unlay_rows8(tlrl), unlay_rows8(tyl), batch)
    return tuple(_tiles_of(o, nb) for o in outs)


@torch.inference_mode()
def keccak_rows_grid_plain(words):
    return _i(field.keccak_state(_u(words).T).T.contiguous())


def fp_mul_chain_plain(a, b, chain: int = PROFILE_CHAIN):
    """``[16, B]`` limb-major columns -> ``chain`` products ``a = a * b``:
    as many calls of :func:`fp_mul_plain` on the ``[B, 16]`` rows."""
    A, Bv = a.T.contiguous(), b.T.contiguous()
    for _ in range(chain):
        A = fp_mul_plain(A, Bv)
    return A.T.contiguous()


def _mul_chain_rows8_plain(at, bt, chain: int):
    """``[nb, 128, 128]`` rows8 tiles -> tiles of ``chain`` products
    ``a = a * b`` per row (all ``nb * 1024`` rows): profile.cu's
    ``mul_chain_rows8`` template."""
    rows = at.shape[0] * ROWS8_BLOCK
    A, Bv = from_rows8(at, rows), from_rows8(bt, rows)
    for _ in range(chain):
        A = fp_mul_plain(A, Bv)
    return to_rows8(A)


def fp_mul_chain_rows8_plain(at, bt):
    return _mul_chain_rows8_plain(at, bt, PROFILE_CHAIN)


def fp_mul_rows8_plain(at, bt):
    return _mul_chain_rows8_plain(at, bt, 1)


@torch.inference_mode()
def add_one_f32_plain(x):
    return x + 1.0


def _f32(s) -> float:
    """``s`` rounded to float32 (a Python float that float32 holds
    exactly): the one cast of the scalar, made on the host for the kernel
    and its plain version alike."""
    return ctypes.c_float(s).value


@torch.inference_mode()
def mul_scalar_f32_plain(x, s):
    return x * _f32(s)


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "eg_init": [_P, _I],
    "eg_recover_prelude": [_P, _I, _P, _I] + [_P] * 7 + [_I, _I, _P],
    "eg_pow_mod": [_P, _P, _I, _P, _I, _I, _I, _P],
    "eg_y_fix": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    "eg_u1u2": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    "eg_glv_digits": [_P, _P, _I, _I, _P, _P, _I, _I, _P],
    "eg_fp_mul": [_P, _P, _I, _P, _I, _I, _I, _P],
    "eg_fp_canon": [_P, _I, _P, _I, _I, _P],
    **{f"eg_strauss_t{t}": [_P] * 5 + [_I] * 3 + [_P] * 3 + [_I] + [_P]
       for t in build.LANES},
    **{f"eg_point_table_t{t}": [_P, _P, _I, _P, _P, _P, _I, _P]
       for t in build.LANES},
    "eg_recover_finish": [_P] * 5 + [_I] * 2 + [_P] * 4 + [_I] * 2 + [_P],
    "eg_keccak_rows": [_P, _I, _P, _I, _I, _P],
    "eg_init_verify": [_P, _I],
    "eg_fn_mul": [_P, _P, _I, _P, _P],
    "eg_fn_red17": [_P, _I, _P, _P],
    "eg_fp_add": [_P, _P, _I, _P, _P],
    "eg_keccak_block": [_P, _I, _P, _P],
    "eg_init_glue": [_P, _I],
    "eg_fp_sub": [_P, _P, _I, _P, _P],
    "eg_fp_neg": [_P, _I, _P, _P],
    "eg_fp_mul_small": [_P, _I, _I, _P, _P],
    "eg_fn_sub": [_P, _P, _I, _P, _P],
    "eg_fn_neg": [_P, _I, _P, _P],
    "eg_mulhi8": [_P, _P, _I, _P, _P],
    "eg_init_tiling": [_P, _I],
    "eg_pow_rows8": [_P, _P, _I, _I, _P, _I, _P],
    "eg_strauss_rows8": [_P] * 5 + [_I] * 3 + [_P] * 3 + [_P],
    "eg_keccak_round": [_P, _I, _P, _P],
    "eg_init_profile": [_P, _I],
    **{f"eg_init_ladder_t{t}": [_P, _I] for t in build.LANES},
    "eg_fp_mul_chain": [_P, _P, _I, _I, _I, _P, _P],
    "eg_fp_mul_chain_rows8": [_P, _P, _I, _P, _P],
    "eg_fp_mul_rows8": [_P, _P, _I, _P, _P],
    "eg_add_one_f32": [_P, _I, _P, _P],
    "eg_mul_scalar_f32": [_P, ctypes.c_float, _I, _P, _P],
}
# one per translation unit: each has its own constants block
_INITS = ("eg_init", "eg_init_verify", "eg_init_glue", "eg_init_tiling",
          "eg_init_profile",
          *(f"eg_init_ladder_t{t}" for t in build.LANES))


def pack_constants() -> np.ndarray:
    """The ``Consts`` block of ``csrc/field.cuh``, field by field."""
    tgx, tgy = curve._g_table16()
    tlx, _ = curve._g_lam_table16()
    ndelta = list(field.N_DELTA_LIMBS) + [0] * (16 - len(field.N_DELTA_LIMBS))
    rc = [(c & M32, c >> 32) for c in field.KECCAK_RC]
    parts = [field.P_LIMBS, field.SUBC_LIMBS, field.N_LIMBS, ndelta,
             field.FN_SUBC_LIMBS, curve.glv_consts(), tgx, tgy, tlx, rc]
    return np.concatenate([np.asarray(p, np.uint32).reshape(-1)
                           for p in parts])


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (at first use), load and initialise the kernel library."""
    lib = ctypes.CDLL(build.build()["path"])
    for name, args in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    consts = pack_constants()
    for init in _INITS:
        err = getattr(lib, init)(consts.ctypes.data, consts.size)
        if err:
            raise RuntimeError(f"{init} failed: {err}")
    return lib


def _launch(name: str, fn_name: str, *args) -> None:
    fn = getattr(library(), fn_name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args], stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:
        # analysis: allow-launch-purity(the launch census, under its lock)
        LAUNCHES[name] += 1


def _check(t: torch.Tensor, what: str, shape, dtype=torch.int32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _on_card(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    another device type."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all operands must be on one device")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=like.device)


def _rows(t: torch.Tensor) -> int:
    if t.dim() != 2:
        raise ValueError(f"expected a [rows, n] tensor, got {tuple(t.shape)}")
    return t.shape[0]


# ---------------------------------------------------------------------------
# public kernels (names and layouts of the reference wrappers)
# ---------------------------------------------------------------------------

def recover_prelude_pallas(sigs, hashes):
    """``sigs [B, W]`` u8 wire signatures (W >= 65: r, s and v from bytes
    0-64), ``hashes [B, 32]`` u8 -> ``(x, y_sq, ok, r, s, z, v)``: limbs
    ``[B, 16]``, flags ``[B]``.  Replaces ``recover_prelude_pallas``
    (pallas_kernels.py:1519), on :func:`lanes_for`'s lanes a row."""
    lanes, threads = lanes_for("recover_prelude", max(_rows(sigs), 1),
                               sigs.device)
    return recover_prelude_lanes(sigs, hashes, lanes, threads)


def recover_prelude_lanes(sigs, hashes, lanes: int, threads: int):
    """:func:`recover_prelude_pallas` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_recover_prelude_t<lanes>``.  The kernel
    reads the rows where they lie: any ``[B, W]`` uint8 tensor with
    W >= 65, unit byte stride and a row pitch of 65 to
    ``PRELUDE_MAX_PITCH`` bytes, at any offset, without a copy (rows
    further apart, or bytes that are not adjacent, are first copied to
    ``[B, 65]``); hashes that are not contiguous are made so.  The outputs
    are fresh, aligned tensors.  Every instance gives the same bits; the
    wrapper launches :func:`lanes_for`'s, and chip_smoke.py phase lanes
    times them all."""
    _check_lanes(lanes, threads)
    B = _rows(sigs)
    if sigs.dtype != torch.uint8:
        raise TypeError(f"sigs: expected torch.uint8, got {sigs.dtype}")
    if sigs.shape[1] < 65:
        raise ValueError(f"sigs: expected [B, 65 or more], got "
                         f"{tuple(sigs.shape)}")
    if hashes.dtype != torch.uint8:
        raise TypeError(f"hashes: expected torch.uint8, got {hashes.dtype}")
    if tuple(hashes.shape) != (B, 32):
        raise ValueError(f"hashes: expected shape {(B, 32)}, got "
                         f"{tuple(hashes.shape)}")
    if not _on_card(sigs, hashes):
        return recover_prelude_plain(sigs, hashes)
    pitch = sigs.stride(0) if B > 1 else 65
    if sigs.stride(1) != 1 or not 65 <= pitch <= PRELUDE_MAX_PITCH:
        sigs, pitch = sigs[:, :65].contiguous(), 65
    hashes = hashes.contiguous()
    x, ysq, r, s, z = (_empty((B, NLIMBS), sigs) for _ in range(5))
    ok, v = _empty((B,), sigs), _empty((B,), sigs)
    _launch("recover_prelude", "eg_recover_prelude", sigs, pitch, hashes, B,
            x, ysq, ok, r, s, z, v, lanes, threads)
    return x, ysq, ok, r, s, z, v


def pow_mod_pallas(a, e: int, modulus: str):
    """``[M, 16] -> [M, 16]``: per-row ``a^e`` for a constant e, relaxed
    mod P (``modulus="p"``) or canonical mod N (``"n"``).  Replaces
    ``pow_mod_pallas`` (pallas_kernels.py:525); the one-hot digit input
    of the TPU kernel becomes 64 digit bytes passed with the launch, and
    :func:`lanes_for` sets the lanes a row.  Under ``rows8_enabled()``
    this is :func:`pow_mod_rows8`."""
    if rows8_enabled():
        return pow_mod_rows8(a, e, modulus)
    if modulus not in ("p", "n"):
        raise ValueError("modulus must be 'p' or 'n'")
    lanes, threads = lanes_for("pow_mod_" + modulus, max(_rows(a), 1),
                               a.device)
    return pow_mod_lanes(a, e, modulus, lanes, threads)


def pow_mod_lanes(a, e: int, modulus: str, lanes: int, threads: int):
    """:func:`pow_mod_pallas` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_pow_p_t<lanes>`` or
    ``k_pow_n_t<lanes>``.  Every instance gives the same bits; the
    wrapper launches :func:`lanes_for`'s, and chip_smoke.py phase lanes
    times them all."""
    if modulus not in ("p", "n"):
        raise ValueError("modulus must be 'p' or 'n'")
    _check_lanes(lanes, threads)
    M = _rows(a)
    _check(a, "a", (M, NLIMBS))
    digits = pow_digits(e)
    if not _on_card(a):
        return pow_mod_plain(a, e, modulus)
    out = _empty((M, NLIMBS), a)
    buf = ctypes.create_string_buffer(digits, POW_WINDOWS)
    _launch("pow_mod", "eg_pow_mod", a, out, M, ctypes.addressof(buf),
            int(modulus == "n"), lanes, threads)
    return out


def y_fix_pallas(root, y_sq, v):
    """``(root, y_sq) [B, 16]``, ``v [B]`` -> ``(y [B, 16], y_ok [B])``.
    Replaces ``y_fix_pallas`` (pallas_kernels.py:1569), on
    :func:`lanes_for`'s lanes a row.  Any contiguous ``[B, 16]`` int32
    operands, views at any offset included."""
    lanes, threads = lanes_for("y_fix", max(_rows(root), 1), root.device)
    return y_fix_lanes(root, y_sq, v, lanes, threads)


def y_fix_lanes(root, y_sq, v, lanes: int, threads: int):
    """:func:`y_fix_pallas` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_y_fix_t<lanes>``, whose rows go through
    shared-memory tiles as :func:`fp_mul_lanes`' do (16-byte vectors where
    ``root`` and ``y_sq`` start on a 16-byte boundary, single words
    otherwise, without a copy; ``y`` is a fresh, aligned tensor).  Every
    instance gives the same bits; the wrapper launches
    :func:`lanes_for`'s, and chip_smoke.py phase lanes times them all."""
    _check_lanes(lanes, threads)
    B = _rows(root)
    _check(root, "root", (B, NLIMBS))
    _check(y_sq, "y_sq", (B, NLIMBS))
    _check(v, "v", (B,))
    if not _on_card(root, y_sq, v):
        return y_fix_plain(root, y_sq, v)
    y, ok = _empty((B, NLIMBS), root), _empty((B,), root)
    vec = int(root.data_ptr() % 16 == 0 and y_sq.data_ptr() % 16 == 0)
    _launch("y_fix", "eg_y_fix", root, y_sq, v, B, y, ok, vec, lanes,
            threads)
    return y, ok


def u1u2_pallas(z, s, r_inv):
    """``(z, s, r_inv) [B, 16]`` -> ``(u1, u2) [B, 16]`` canonical mod N.
    Replaces ``u1u2_pallas`` (pallas_kernels.py:1610), on
    :func:`lanes_for`'s lanes a row.  Any contiguous ``[B, 16]`` int32
    operands, views at any offset included."""
    lanes, threads = lanes_for("u1u2", max(_rows(z), 1), z.device)
    return u1u2_lanes(z, s, r_inv, lanes, threads)


def u1u2_lanes(z, s, r_inv, lanes: int, threads: int):
    """:func:`u1u2_pallas` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_u1u2_t<lanes>`` (at T >= 2 half the
    group computes u1 and half u2).  The kernel reads 16-byte vectors
    where all three operands start on a 16-byte boundary and single words
    otherwise, without a copy; the outputs are fresh, aligned tensors.
    Every instance gives the same bits; the wrapper launches
    :func:`lanes_for`'s, and chip_smoke.py phase lanes times them all."""
    _check_lanes(lanes, threads)
    B = _rows(z)
    for t, what in ((z, "z"), (s, "s"), (r_inv, "r_inv")):
        _check(t, what, (B, NLIMBS))
    if not _on_card(z, s, r_inv):
        return u1u2_plain(z, s, r_inv)
    u1, u2 = _empty((B, NLIMBS), z), _empty((B, NLIMBS), z)
    vec = int(all(t.data_ptr() % 16 == 0 for t in (z, s, r_inv)))
    _launch("u1u2", "eg_u1u2", z, s, r_inv, B, u1, u2, vec, lanes, threads)
    return u1, u2


def glv_digits_pallas(u1, u2):
    """``u1/u2 [B, 16]`` canonical mod-N scalars -> ``(dig [33, 8, Bpad],
    neg [8, Bpad])`` for :func:`strauss_tab`.  Replaces
    ``glv_digits_pallas`` (pallas_kernels.py:1389), on :func:`lanes_for`'s
    lanes a row (of the Bpad rows it covers)."""
    lanes, threads = lanes_for("glv_digits", max(bpad(_rows(u1)), 1),
                               u1.device)
    return glv_digits_lanes(u1, u2, lanes, threads)


def glv_digits_lanes(u1, u2, lanes: int, threads: int):
    """:func:`glv_digits_pallas` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_glv_digits_t<lanes>`` (at T >= 2 half
    the group splits u1 and half u2).  Every instance gives the same bits,
    rows 4-7 of ``dig`` and ``neg`` written as zeros by the kernel; the
    wrapper launches :func:`lanes_for`'s, and chip_smoke.py phase lanes
    times them all."""
    _check_lanes(lanes, threads)
    B = _rows(u1)
    _check(u1, "u1", (B, NLIMBS))
    _check(u2, "u2", (B, NLIMBS))
    if not _on_card(u1, u2):
        return glv_digits_plain(u1, u2)
    wide = bpad(B)
    dig = _empty((curve.GLV_WINDOWS, 8, wide), u1)
    neg = _empty((8, wide), u1)
    _launch("glv_digits", "eg_glv_digits", u1, u2, B, wide, dig, neg, lanes,
            threads)
    return dig, neg


def point_table_pallas(px, py):
    """``[B, 16]`` affine R -> Jacobian ``d*R`` for d in 2..15, each of X,
    Y, Z ``[14, B, 16]``.  Replaces ``point_table_pallas``
    (pallas_kernels.py:611); the entry walk on the TPU grid is a loop in
    a group of :func:`lanes_for`'s lanes a row."""
    lanes, threads = lanes_for("point_table", max(_rows(px), 1), px.device)
    return point_table_lanes(px, py, lanes, threads)


def point_table_lanes(px, py, lanes: int, threads: int):
    """:func:`point_table_pallas` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_point_table_t<lanes>``
    (``csrc/ladder.cu``).  Every instance gives the same bits; the
    wrapper launches :func:`lanes_for`'s, and chip_smoke.py phase lanes
    times them all."""
    _check_lanes(lanes, threads)
    B = _rows(px)
    _check(px, "px", (B, NLIMBS))
    _check(py, "py", (B, NLIMBS))
    if not _on_card(px, py):
        return point_table_plain(px, py)
    X, Y, Z = (_empty((14, B, NLIMBS), px) for _ in range(3))
    _launch("point_table", f"eg_point_table_t{lanes}", px, py, B, X, Y, Z,
            threads)
    return X, Y, Z


def _binary(name: str, a, b, plain):
    """``[M, 16] op [M, 16] -> [M, 16]``: the launch of a two-operand
    kernel ``eg_<name>``, or its plain version for CPU tensors."""
    M = _rows(a)
    _check(a, "a", (M, NLIMBS))
    _check(b, "b", (M, NLIMBS))
    if not _on_card(a, b):
        return plain(a, b)
    out = _empty((M, NLIMBS), a)
    _launch(name, "eg_" + name, a, b, M, out)
    return out


def _unary(name: str, a, plain):
    """``[M, 16] -> [M, 16]``: the launch of a one-operand kernel
    ``eg_<name>``, or its plain version for CPU tensors."""
    M = _rows(a)
    _check(a, "a", (M, NLIMBS))
    if not _on_card(a):
        return plain(a)
    out = _empty((M, NLIMBS), a)
    _launch(name, "eg_" + name, a, M, out)
    return out


def fp_mul_pallas(a, b):
    """``[M, 16] x [M, 16] -> [M, 16]`` relaxed F_P product.  Replaces
    ``fp_mul_pallas`` (pallas_kernels.py:279), on :func:`lanes_for`'s
    lanes a row.  Any contiguous ``[M, 16]`` int32 operands, views at
    any offset included."""
    lanes, threads = lanes_for("fp_mul", max(_rows(a), 1), a.device)
    return fp_mul_lanes(a, b, lanes, threads)


def fp_mul_lanes(a, b, lanes: int, threads: int):
    """:func:`fp_mul_pallas` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_fp_mul_t<lanes>``.  The kernel reads
    16-byte vectors where both operands start on a 16-byte boundary and
    single words otherwise (a view 4, 8 or 12 bytes in), without a copy;
    the output is a fresh, aligned tensor.  Every instance gives the
    same bits; the wrapper launches :func:`lanes_for`'s, and
    chip_smoke.py phase lanes times them all."""
    _check_lanes(lanes, threads)
    M = _rows(a)
    _check(a, "a", (M, NLIMBS))
    _check(b, "b", (M, NLIMBS))
    if not _on_card(a, b):
        return fp_mul_plain(a, b)
    out = _empty((M, NLIMBS), a)
    vec = int(a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    _launch("fp_mul", "eg_fp_mul", a, b, M, out, vec, lanes, threads)
    return out


def fp_canon_pallas(a):
    """``[M, 16]`` relaxed F_P -> canonical [0, P).  Replaces
    ``fp_canon_pallas`` (pallas_kernels.py:1282), in :func:`lanes_for`'s
    blocks.  Any contiguous ``[M, 16]`` int32 operand, views at any
    offset included."""
    lanes, threads = lanes_for("fp_canon", max(_rows(a), 1), a.device)
    return fp_canon_lanes(a, lanes, threads)


def fp_canon_lanes(a, lanes: int, threads: int):
    """:func:`fp_canon_pallas` in blocks of ``threads``, one lane a row
    (``lanes`` must be 1: the kernel's borrow chain is too short to
    share): the launch of ``k_fp_canon``, whose rows go through a
    shared-memory tile as :func:`fp_mul_lanes`' do (16-byte vectors where
    ``a`` starts on a 16-byte boundary, single words otherwise, without a
    copy; the output is a fresh, aligned tensor).  Every block size gives
    the same bits; the wrapper launches :func:`lanes_for`'s, and
    chip_smoke.py phase lanes times them all."""
    _check_lanes(lanes, threads)
    if lanes != 1:
        raise ValueError(f"fp_canon runs one lane a row, got {lanes}")
    M = _rows(a)
    _check(a, "a", (M, NLIMBS))
    if not _on_card(a):
        return fp_canon_plain(a)
    out = _empty((M, NLIMBS), a)
    _launch("fp_canon", "eg_fp_canon", a, M, out, int(a.data_ptr() % 16 == 0),
            threads)
    return out


def strauss_tab(dig, neg, trx, tlrx, try_, batch: int):
    """GLV/Strauss ladder ``u1*G + u2*R``: ``dig [W, 8, Bpad]`` (rows 0-3
    the window digits of g1/g2/r1/r2, MSD first), ``neg [8, Bpad]`` (rows
    0-3 the half-scalar signs), ``trx/tlrx/try_ [256, Bpad]`` (R and
    lambda*R x, shared y; row ``16*d + k`` = limb k of entry d).
    Returns Jacobian ``(X, Y, Z)`` each ``[batch, 16]``.  Replaces
    ``strauss_tab`` (pallas_kernels.py:384), on :func:`lanes_for`'s lanes
    a row; under ``rows8_enabled()`` this is :func:`strauss_tab_rows8`."""
    if rows8_enabled():
        return strauss_tab_rows8(dig, neg, trx, tlrx, try_, batch)
    lanes, threads = lanes_for("strauss_tab", max(batch, 1), dig.device)
    return strauss_tab_lanes(dig, neg, trx, tlrx, try_, batch, lanes,
                             threads)


def strauss_tab_lanes(dig, neg, trx, tlrx, try_, batch: int, lanes: int,
                      threads: int):
    """:func:`strauss_tab` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_strauss_t<lanes>``
    (``csrc/ladder.cu``).  Every instance gives the same bits; the
    wrapper launches :func:`lanes_for`'s, and chip_smoke.py phase lanes
    times them all."""
    _check_lanes(lanes, threads)
    W, _, wide = dig.shape
    if batch <= 0 or batch > wide:
        raise ValueError("batch must be in 1..Bpad")
    _check(dig, "dig", (W, 8, wide))
    _check(neg, "neg", (8, wide))
    for t, what in ((trx, "trx"), (tlrx, "tlrx"), (try_, "try_")):
        _check(t, what, (16 * NLIMBS, wide))
    if not _on_card(dig, neg, trx, tlrx, try_):
        return strauss_tab_plain(dig, neg, trx, tlrx, try_, batch)
    X, Y, Z = (_empty((batch, NLIMBS), dig) for _ in range(3))
    _launch("strauss_tab", f"eg_strauss_t{lanes}", dig, neg, trx, tlrx,
            try_, batch, wide, W, X, Y, Z, threads)
    return X, Y, Z


def recover_finish_pallas(X, Y, Z, zi_raw, ok_in):
    """``(X, Y, Z, zi_raw) [B, 16]``, ``ok_in [B]`` -> ``(qx, qy [B, 16]
    canonical and masked, ok [B], words [34, Bpad])``.  Replaces
    ``recover_finish_pallas`` (pallas_kernels.py:1685), on
    :func:`lanes_for`'s lanes a row (of the Bpad rows it covers)."""
    lanes, threads = lanes_for("recover_finish", max(bpad(_rows(X)), 1),
                               X.device)
    return recover_finish_lanes(X, Y, Z, zi_raw, ok_in, lanes, threads)


def recover_finish_lanes(X, Y, Z, zi_raw, ok_in, lanes: int, threads: int):
    """:func:`recover_finish_pallas` on ``lanes`` lanes a row in blocks of
    ``threads``: the launch of ``k_recover_finish_t<lanes>``.  Every
    instance gives the same bits; the wrapper launches
    :func:`lanes_for`'s, and chip_smoke.py phase lanes times them all."""
    _check_lanes(lanes, threads)
    B = _rows(X)
    for t, what in ((X, "X"), (Y, "Y"), (Z, "Z"), (zi_raw, "zi_raw")):
        _check(t, what, (B, NLIMBS))
    _check(ok_in, "ok_in", (B,))
    if not _on_card(X, Y, Z, zi_raw, ok_in):
        return recover_finish_plain(X, Y, Z, zi_raw, ok_in)
    wide = bpad(B)
    qx, qy = _empty((B, NLIMBS), X), _empty((B, NLIMBS), X)
    ok, words = _empty((B,), X), _empty((34, wide), X)
    _launch("recover_finish", "eg_recover_finish", X, Y, Z, zi_raw, ok_in, B,
            wide, qx, qy, ok, words, lanes, threads)
    return qx, qy, ok, words


def keccak_rows_pallas(words):
    """``[34, wide]`` padded block words -> ``[8, wide]`` digest words,
    one Keccak-f[1600] per column.  Replaces ``keccak_rows_pallas``
    (pallas_kernels.py:1781), on :func:`lanes_for`'s lanes a column; the
    kernel uses native 64-bit lanes at one lane a column, 32-bit halves on
    a pair of lanes at 2, 4 and 8.  Under
    ``keccak_grid_enabled()`` the round kernel (:func:`keccak_rows_grid`)
    computes the whole state and the digest rows are gathered from it,
    as the reference's grid branch does."""
    if words.dim() != 2:
        raise ValueError("words must be [34, wide]")
    wide = words.shape[1]
    _check(words, "words", (34, wide))
    if keccak_grid_enabled():
        # lanes 0..3 of the lo and hi halves: lo0 hi0 lo1 hi1 ...
        st = keccak_rows_grid(words).view(2, 25, wide)
        return st[:, :4].permute(1, 0, 2).reshape(8, wide)
    lanes, threads = lanes_for("keccak_rows", max(wide, 1), words.device)
    return keccak_rows_lanes(words, lanes, threads)


def keccak_rows_lanes(words, lanes: int, threads: int):
    """:func:`keccak_rows_pallas` (the default layout) on ``lanes`` lanes
    a column in blocks of ``threads``: the launch of
    ``k_keccak_rows_t<lanes>`` (at T >= 2 a pair of lanes holds the
    two 32-bit halves of the state, lanes past the pair repeating it).
    Every
    instance gives the same bits; the wrapper launches
    :func:`lanes_for`'s, and chip_smoke.py phase lanes times them all."""
    _check_lanes(lanes, threads)
    if words.dim() != 2:
        raise ValueError("words must be [34, wide]")
    wide = words.shape[1]
    _check(words, "words", (34, wide))
    if not _on_card(words):
        return keccak_rows_plain(words)
    out = _empty((8, wide), words)
    _launch("keccak_rows", "eg_keccak_rows", words, wide, out, lanes,
            threads)
    return out


def fn_mul_pallas(a, b):
    """``[M, 16] x [M, 16] -> [M, 16]`` canonical mod-N product.  Replaces
    ``fn_mul_pallas`` (pallas_kernels.py:1114)."""
    return _binary("fn_mul", a, b, fn_mul_plain)


def fn_red17_pallas(a):
    """``[M, 17]`` small (below 2^16) columns -> ``[M, 16]`` canonical
    mod N.  Replaces ``fn_red17_pallas`` (pallas_kernels.py:1294)."""
    M = _rows(a)
    _check(a, "a", (M, NLIMBS + 1))
    if not _on_card(a):
        return fn_red17_plain(a)
    out = _empty((M, NLIMBS), a)
    _launch("fn_red17", "eg_fn_red17", a, M, out)
    return out


def fp_add_pallas(a, b):
    """``[M, 16] + [M, 16] -> [M, 16]`` relaxed F_P sum.  Replaces
    ``fp_add_pallas`` (pallas_kernels.py:1270)."""
    return _binary("fp_add", a, b, fp_add_plain)


def keccak_block_pallas(words):
    """``[B, 34]`` little-endian words of one padded block per row ->
    ``[B, 8]`` digest words.  Replaces ``keccak_block_pallas``
    (pallas_kernels.py:745), which padded B to LANE_BLOCK and transposed
    for the column kernel; this kernel reads the rows as they are and
    masks the ragged edge.  Under ``keccak_grid_enabled()`` the rows are
    padded and transposed as the reference does, for the round kernel."""
    B = _rows(words)
    _check(words, "words", (B, 34))
    if keccak_grid_enabled():
        wt = F.pad(words, (0, 0, 0, bpad(B) - B)).T.contiguous()
        return keccak_rows_pallas(wt).T[:B].contiguous()
    if not _on_card(words):
        return keccak_block_plain(words)
    out = _empty((B, 8), words)
    _launch("keccak_block", "eg_keccak_block", words, B, out)
    return out


def fp_sub_pallas(a, b):
    """``[M, 16] - [M, 16] -> [M, 16]`` relaxed F_P difference.  Replaces
    ``fp_sub_pallas`` (pallas_kernels.py:1274)."""
    return _binary("fp_sub", a, b, fp_sub_plain)


def fp_neg_pallas(a):
    """``[M, 16] -> [M, 16]`` relaxed F_P negation.  Replaces
    ``fp_neg_pallas`` (pallas_kernels.py:1278)."""
    return _unary("fp_neg", a, fp_neg_plain)


def fp_mul_small_pallas(a, k: int):
    """``[M, 16] -> [M, 16]`` relaxed F_P ``k * a`` for a small constant
    0 <= k < 16.  Replaces ``fp_mul_small_pallas``
    (pallas_kernels.py:1448), which compiled one kernel per k; here k
    goes with the launch."""
    if not 0 <= k < 16:
        raise ValueError("fp_mul_small takes 0 <= k < 16")
    M = _rows(a)
    _check(a, "a", (M, NLIMBS))
    if not _on_card(a):
        return fp_mul_small_plain(a, k)
    out = _empty((M, NLIMBS), a)
    _launch("fp_mul_small", "eg_fp_mul_small", a, k, M, out)
    return out


def fn_sub_pallas(a, b):
    """``[M, 16] - [M, 16] -> [M, 16]`` canonical mod-N difference of
    canonical operands.  Replaces ``fn_sub_pallas``
    (pallas_kernels.py:1286)."""
    return _binary("fn_sub", a, b, fn_sub_plain)


def fn_neg_pallas(a):
    """``[M, 16] -> [M, 16]`` canonical mod-N negation (0 stays 0).
    Replaces ``fn_neg_pallas`` (pallas_kernels.py:1290)."""
    return _unary("fn_neg", a, fn_neg_plain)


@functools.lru_cache(maxsize=8)
def _g_limbs(g: int) -> tuple[int, ...]:
    """The 16 limbs of a mulhi8 constant (raises unless 0 <= g < 2^256)."""
    return tuple(int(v) for v in int_to_limbs(g))


def mulhi8_pallas(a, g: int):
    """``[M, 16] -> [M, 8]``: limbs 24..31 of ``a * g`` for a 256-bit
    constant g, the GLV rounding ``(k * g) >> 384``.  Replaces
    ``mulhi8_pallas`` (pallas_kernels.py:1299); g's limbs go with the
    launch."""
    limbs = _g_limbs(g)
    M = _rows(a)
    _check(a, "a", (M, NLIMBS))
    if not _on_card(a):
        return mulhi8_plain(a, g)
    out = _empty((M, 8), a)
    buf = (ctypes.c_uint32 * NLIMBS)(*limbs)
    _launch("mulhi8", "eg_mulhi8", a, ctypes.addressof(buf), M, out)
    return out


# ---------------------------------------------------------------------------
# the tiling configuration's kernels (csrc/tiling.cu)
# ---------------------------------------------------------------------------

def _tiles(t: torch.Tensor, what: str, rows: int) -> int:
    """Check a ``[nb, rows, 128]`` rows8 tensor; returns nb."""
    if t.dim() != 3:
        raise ValueError(f"{what}: expected [nb, {rows}, 128] rows8 tiles, "
                         f"got {tuple(t.shape)}")
    _check(t, what, (t.shape[0], rows, 128))
    return t.shape[0]


def pow_rows8_tiles(at, e: int, modulus: str, rows: int):
    """``[nb, 128, 128]`` rows8 tiles -> tiles of the per-row ``a^e``
    (relaxed mod P or canonical mod N) of the first ``rows`` rows, the
    other rows zero: the launch of ``k_pow_rows8_p`` or
    ``k_pow_rows8_n``, 64 digit bytes passed with it."""
    if modulus not in ("p", "n"):
        raise ValueError("modulus must be 'p' or 'n'")
    nb = _tiles(at, "at", NLIMBS * 8)
    if not 0 < rows <= nb * ROWS8_BLOCK:
        raise ValueError("rows must be in 1..nb*1024")
    digits = pow_digits(e)
    if not _on_card(at):
        return pow_mod_rows8_plain(at, e, modulus, rows)
    out = torch.empty_like(at)
    buf = ctypes.create_string_buffer(digits, POW_WINDOWS)
    _launch("pow_mod_rows8", "eg_pow_rows8", at, out, rows, nb,
            ctypes.addressof(buf), int(modulus == "n"))
    return out


def pow_mod_rows8(a, e: int, modulus: str):
    """``[M, 16] -> [M, 16]``, the contract of :func:`pow_mod_pallas`:
    the rows padded to a ROWS8_BLOCK multiple (whatever the lane block)
    and re-laid into tiles for :func:`pow_rows8_tiles`.  Replaces
    ``pow_mod_rows8`` (pallas_kernels.py:861)."""
    M = _rows(a)
    _check(a, "a", (M, NLIMBS))
    ap, B = pad_rows8(a)
    return from_rows8(pow_rows8_tiles(to_rows8(ap), e, modulus, B), B)


def strauss_rows8_tiles(digl, negl, trl, tlrl, tyl, batch: int):
    """The ladder over rows8-laid inputs (``[nb, W, 64, 128]`` digits,
    ``[nb, 64, 128]`` signs, ``[nb, 2048, 128]`` R and lambda*R x and
    shared y tables) -> Jacobian ``(X, Y, Z)`` tiles ``[nb, 128, 128]``
    of the first ``batch`` rows, the other rows zero: the launch of
    ``k_strauss_rows8``."""
    if digl.dim() != 4:
        raise ValueError(f"digl: expected [nb, W, 64, 128], got "
                         f"{tuple(digl.shape)}")
    nb, W = digl.shape[:2]
    _check(digl, "digl", (nb, W, 64, 128))
    for t, what, rows in ((negl, "negl", 64), (trl, "trl", 2048),
                          (tlrl, "tlrl", 2048), (tyl, "tyl", 2048)):
        if _tiles(t, what, rows) != nb:
            raise ValueError(f"{what}: {t.shape[0]} tiles, digits have {nb}")
    if not 0 < batch <= nb * ROWS8_BLOCK:
        raise ValueError("batch must be in 1..nb*1024")
    if not _on_card(digl, negl, trl, tlrl, tyl):
        return strauss_tab_rows8_plain(digl, negl, trl, tlrl, tyl, batch)
    X, Y, Z = (_empty((nb, NLIMBS * 8, 128), digl) for _ in range(3))
    _launch("strauss_tab_rows8", "eg_strauss_rows8", digl, negl, trl, tlrl,
            tyl, batch, nb, W, X, Y, Z)
    return X, Y, Z


def strauss_tab_rows8(dig, neg, trx, tlrx, try_, batch: int):
    """The contract of :func:`strauss_tab` with Bpad a ROWS8_BLOCK
    multiple (raises otherwise): the inputs re-laid into rows8 tiles for
    :func:`strauss_rows8_tiles`, the first ``batch`` rows of its tiles
    returned.  Replaces ``strauss_tab_rows8`` (pallas_kernels.py:948)."""
    if dig.dim() != 3:
        raise ValueError(f"dig: expected [W, 8, Bpad], got {tuple(dig.shape)}")
    W, _, wide = dig.shape
    if wide % ROWS8_BLOCK:
        raise ValueError(f"strauss_tab_rows8: Bpad {wide} is not a multiple "
                         f"of {ROWS8_BLOCK}")
    if batch <= 0 or batch > wide:
        raise ValueError("batch must be in 1..Bpad")
    _check(dig, "dig", (W, 8, wide))
    _check(neg, "neg", (8, wide))
    for t, what in ((trx, "trx"), (tlrx, "tlrx"), (try_, "try_")):
        _check(t, what, (16 * NLIMBS, wide))
    outs = strauss_rows8_tiles(lay_digits_rows8(dig), lay_rows8(neg),
                               lay_rows8(trx), lay_rows8(tlrx),
                               lay_rows8(try_), batch)
    return tuple(from_rows8(o, batch) for o in outs)


def keccak_rows_grid(words):
    """``[34, wide]`` padded block words -> ``[50, wide]``: the state
    after Keccak-f[1600] per column, lo halves of lanes 0..24 in rows
    0-24 and hi halves in rows 25-49, as the TPU round-grid kernel
    leaves it.  The launch of ``k_keccak_round``; replaces the grid
    branch of ``keccak_rows_pallas`` and ``_keccak_round_kernel``
    (pallas_kernels.py:1713, 1789)."""
    if words.dim() != 2:
        raise ValueError("words must be [34, wide]")
    wide = words.shape[1]
    _check(words, "words", (34, wide))
    if not _on_card(words):
        return keccak_rows_grid_plain(words)
    out = _empty((50, wide), words)
    _launch("keccak_rows_grid", "eg_keccak_round", words, wide, out)
    return out


# ---------------------------------------------------------------------------
# the profiling harness's kernels (csrc/profile.cu)
# ---------------------------------------------------------------------------

def fp_mul_chain_pallas(a, b, chain: int = PROFILE_CHAIN, lane: int = 256):
    """``[16, B] x [16, B]`` limb-major (limb k of column c at ``[k, c]``)
    -> ``[16, B]``: ``chain`` chained relaxed F_P products ``a = a * b``
    per column in one launch of ``lane``-thread blocks.  Replaces
    ``_chain_kernel_1d`` launched by ``run_1d``
    (harness/profile_mulchain.py:29, 47).  ``lane`` is a multiple of 128
    up to 1024 and B a multiple of it, else ``ValueError``: the
    reference's grid of ``B // lane`` blocks would leave the tail
    unwritten."""
    if a.dim() != 2:
        raise ValueError(f"a: expected [16, B], got {tuple(a.shape)}")
    wide = a.shape[1]
    _check(a, "a", (NLIMBS, wide))
    _check(b, "b", (NLIMBS, wide))
    if lane <= 0 or lane > 1024 or lane % 128:
        raise ValueError(f"lane {lane}: must be a multiple of 128 up to 1024")
    if wide % lane:
        raise ValueError(f"B = {wide} is not a multiple of the lane {lane}")
    if chain < 0:
        raise ValueError("chain must be >= 0")
    if not _on_card(a, b):
        return fp_mul_chain_plain(a, b, chain)
    out = _empty((NLIMBS, wide), a)
    _launch("fp_mul_chain", "eg_fp_mul_chain", a, b, wide, chain, lane, out)
    return out


def _tile_pair(at, bt) -> int:
    """Check two ``[nb, 128, 128]`` rows8 value tiles; returns nb."""
    nb = _tiles(at, "at", NLIMBS * 8)
    if _tiles(bt, "bt", NLIMBS * 8) != nb:
        raise ValueError(f"bt: {bt.shape[0]} tiles, at has {nb}")
    return nb


def fp_mul_chain_rows8(at, bt):
    """``[nb, 128, 128]`` rows8 tiles -> tiles of ``PROFILE_CHAIN`` (64)
    chained relaxed F_P products ``a = a * b`` per row (``to_rows8``'s
    layout).  Replaces ``_chain_kernel_8x``
    (harness/profile_mulchain.py:38, launched at :77)."""
    nb = _tile_pair(at, bt)
    if not _on_card(at, bt):
        return fp_mul_chain_rows8_plain(at, bt)
    out = torch.empty_like(at)
    _launch("fp_mul_chain_rows8", "eg_fp_mul_chain_rows8", at, bt, nb, out)
    return out


def fp_mul_rows8(at, bt):
    """``[nb, 128, 128]`` rows8 tiles -> tiles of the relaxed F_P product
    per row.  Replaces ``_fp_mul8b_kernel`` (harness/profile_mul8b.py:34,
    launched at :50); ``fp_mul8b`` there re-lays ``[B, 16]`` rows around
    it."""
    nb = _tile_pair(at, bt)
    if not _on_card(at, bt):
        return fp_mul_rows8_plain(at, bt)
    out = torch.empty_like(at)
    _launch("fp_mul_rows8", "eg_fp_mul_rows8", at, bt, nb, out)
    return out


def add_one_f32(x):
    """``x + 1.0`` on a contiguous float32 tensor, one hand-written kernel
    launch.  Replaces the ``pallasnop`` copy kernel ``_kern``
    (harness/profile_floor.py:105, launched at :113)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("x: expected a tensor")
    _check(x, "x", x.shape, torch.float32)
    if x.numel() >= 2**31:
        raise ValueError("x: too many elements for one launch")
    if not _on_card(x):
        return add_one_f32_plain(x)
    out = torch.empty_like(x)
    _launch("add_one_f32", "eg_add_one_f32", x, x.numel(), out)
    return out


def mul_scalar_f32(x, s):
    """``x * s`` on a contiguous float32 tensor, ``s`` cast to float32 on
    the host, one hand-written kernel launch.  Replaces the launch-purity
    fixture's ``_impure_kernel`` (tests/analysis_fixtures/jit/eges_tpu/
    ops/impure_kernel.py:10, launched at :16), whose ``s`` is the host
    clock read at trace time.  Any contiguous float32 tensor, a view at
    any offset included: the output is allocated at the input's offset
    mod 16 bytes, so both share their aligned elements (the kernel
    streams 16-byte accesses)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("x: expected a tensor")
    _check(x, "x", x.shape, torch.float32)
    if x.numel() >= 2**31:
        raise ValueError("x: too many elements for one launch")
    if not _on_card(x):
        return mul_scalar_f32_plain(x, s)
    out = _same_phase_empty(x)
    _launch("mul_scalar_f32", "eg_mul_scalar_f32", x, _f32(s), x.numel(), out)
    return out


def _same_phase_empty(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``x``'s shape, type and device whose data starts
    at ``x``'s address mod 16 bytes (a view into a buffer up to 3
    elements longer), so that 16-byte accesses line up in both."""
    lead = x.data_ptr() % 16 // x.element_size()
    buf = torch.empty(x.numel() + lead, dtype=x.dtype, device=x.device)
    return buf[lead:].view(x.shape)


# the Pallas kernel each one replaces (eges_tpu/ops/pallas_kernels.py
# unless named)
REPLACES = {
    "recover_prelude": "eges_tpu/ops/pallas_kernels.py:1519",
    "pow_mod": "eges_tpu/ops/pallas_kernels.py:525",
    "y_fix": "eges_tpu/ops/pallas_kernels.py:1569",
    "u1u2": "eges_tpu/ops/pallas_kernels.py:1610",
    "glv_digits": "eges_tpu/ops/pallas_kernels.py:1389",
    "point_table": "eges_tpu/ops/pallas_kernels.py:611",
    "fp_mul": "eges_tpu/ops/pallas_kernels.py:279",
    "fp_canon": "eges_tpu/ops/pallas_kernels.py:1282",
    "strauss_tab": "eges_tpu/ops/pallas_kernels.py:384",
    "recover_finish": "eges_tpu/ops/pallas_kernels.py:1685",
    "keccak_rows": "eges_tpu/ops/pallas_kernels.py:1781",
    "fn_mul": "eges_tpu/ops/pallas_kernels.py:1114",
    "fn_red17": "eges_tpu/ops/pallas_kernels.py:1294",
    "fp_add": "eges_tpu/ops/pallas_kernels.py:1270",
    "keccak_block": "eges_tpu/ops/pallas_kernels.py:745",
    "fp_sub": "eges_tpu/ops/pallas_kernels.py:1274",
    "fp_neg": "eges_tpu/ops/pallas_kernels.py:1278",
    "fp_mul_small": "eges_tpu/ops/pallas_kernels.py:1448",
    "fn_sub": "eges_tpu/ops/pallas_kernels.py:1286",
    "fn_neg": "eges_tpu/ops/pallas_kernels.py:1290",
    "mulhi8": "eges_tpu/ops/pallas_kernels.py:1299",
    "pow_mod_rows8": "eges_tpu/ops/pallas_kernels.py:861",
    "strauss_tab_rows8": "eges_tpu/ops/pallas_kernels.py:948",
    "keccak_rows_grid": "eges_tpu/ops/pallas_kernels.py:1713",
    "fp_mul_chain": "harness/profile_mulchain.py:29",
    "fp_mul_chain_rows8": "harness/profile_mulchain.py:38",
    "fp_mul_rows8": "harness/profile_mul8b.py:34",
    "add_one_f32": "harness/profile_floor.py:105",
    "mul_scalar_f32": "tests/analysis_fixtures/jit/eges_tpu/ops/"
                      "impure_kernel.py:16",
}

# the source file each kernel is in (under ops/csrc)
SOURCE_OF = dict.fromkeys(KERNELS, "recover.cu")
SOURCE_OF["strauss_tab"] = SOURCE_OF["point_table"] = "ladder.cu"
SOURCE_OF.update(dict.fromkeys(("fn_mul", "fn_red17", "fp_add",
                                "keccak_block"), "verify.cu"))
SOURCE_OF.update(dict.fromkeys(("fp_sub", "fp_neg", "fp_mul_small", "fn_sub",
                                "fn_neg", "mulhi8"), "glue.cu"))
SOURCE_OF.update(dict.fromkeys(("pow_mod_rows8", "strauss_tab_rows8",
                                "keccak_rows_grid"), "tiling.cu"))
SOURCE_OF.update(dict.fromkeys(("fp_mul_chain", "fp_mul_chain_rows8",
                                "fp_mul_rows8", "add_one_f32",
                                "mul_scalar_f32"), "profile.cu"))
