"""256-bit integers as 16 little-endian 16-bit limbs, and arithmetic mod
the secp256k1 prime P and group order N on them.

The limb layout of ``eges_tpu.ops.bigint``, kept so that the port's
values and the reference's compare array with array: a field element is
a ``[..., 16]`` array of limbs, least significant first, each below
2^16 (``int32`` tensors in the port, ``uint32`` numpy arrays on the
host).  The constants and conversions (Python ints and numpy) are
defined in ``ops/field.py``, below the kernels, and re-exported here;
the field library lives in ``ops/field.py`` (PyTorch) and
``ops/csrc/field.cuh`` (CUDA).

Below them, the port of the reference's ``Mod``/``FieldP``/``OrderN``
front door (``FP`` and ``FN``), for operands of any leading shape: each
arithmetic method flattens its operands to ``[-1, 16]``, calls one
kernel wrapper of ``ops/kernels.py`` and restores the shape, as the
reference's batched ``_glue`` branch does (``eges_tpu/ops/bigint.py``
``FieldP``, ``OrderN``).  There is no XLA-form twin: on the CPU the
wrappers run their plain versions.  A single row's ``[16]`` operands
reach each kernel as ``[1, 16]``.  Flags are ``int32`` 0/1 tensors of
the leading shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from eges_tpu_torch.ops import field
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.field import (  # noqa: F401
    LIMB_BITS, MASK, NLIMBS, N, P, int_to_limbs, limbs_to_int)


# ---------------------------------------------------------------------------
# limb helpers, any leading shape
# ---------------------------------------------------------------------------

def bytes_be_to_limbs(b) -> torch.Tensor:
    """``[..., 32]`` big-endian bytes (an integer tensor, or a numpy
    array) -> ``[..., 16]`` int32 limbs."""
    t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))
    return field.unpack_be(t.to(torch.int32), 0)


def limbs_to_bytes_be(a: torch.Tensor) -> torch.Tensor:
    """``[..., 16]`` limbs -> ``[..., 32]`` big-endian bytes (uint8)."""
    le = torch.stack([a & 0xFF, (a >> 8) & 0xFF], dim=-1)
    return le.reshape(*a.shape[:-1], 2 * NLIMBS).flip(-1).to(torch.uint8)


def big_add(a: torch.Tensor, b: torch.Tensor,
            n_out: int | None = None) -> torch.Tensor:
    """``a + b`` carried into ``n_out`` limbs (default: one more than the
    wider operand)."""
    w = max(a.shape[-1], b.shape[-1])
    cols = F.pad(a, (0, w - a.shape[-1])) + F.pad(b, (0, w - b.shape[-1]))
    return field.carry(cols, w + 1 if n_out is None else n_out)


@functools.lru_cache(maxsize=8)
def _limb_index(device: torch.device) -> torch.Tensor:
    return torch.arange(NLIMBS, dtype=torch.int32, device=device)


def big_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row ``a < b`` flag for 16-limb values (limbs below 2^16; ``b``
    may be a ``[16]`` row): the most significant limb where the two
    differ decides (the borrow of the reference's ``a - b`` chain, in a
    few whole-value operations)."""
    d = a - b
    top = torch.where(d != 0, _limb_index(d.device), -1).amax(
        -1, keepdim=True)
    lt = torch.gather(d, -1, top.clamp(min=0).long()) < 0
    return (lt & (top >= 0)).squeeze(-1).to(torch.int32)


def select(flag: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """``flag ? a : b`` per row, the flag broadcast over the limb axis."""
    return torch.where((flag != 0)[..., None], a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Per-row all-limbs-zero flag."""
    return (a == 0).all(-1).to(torch.int32)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row limbwise equality flag."""
    return (a == b).all(-1).to(torch.int32)


@functools.lru_cache(maxsize=16)
def const_row(x: int, device: torch.device) -> torch.Tensor:
    """The constant ``x`` as a ``[16]`` int32 limb row on ``device``, made
    once: it broadcasts against ``[..., 16]`` values in tensor
    operations."""
    return torch.from_numpy(int_to_limbs(x).astype(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def const_rows(x: int, rows: int, device: torch.device) -> torch.Tensor:
    """``rows`` contiguous copies of the constant ``x`` as ``[rows, 16]``
    int32 limbs, made once per (constant, rows, device).  Shared: the
    kernels and the tensor operations only read it."""
    return const_row(x, device).expand(rows, NLIMBS).contiguous()


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, NLIMBS).contiguous()


def _launch(fn, *args: torch.Tensor, **kw) -> torch.Tensor:
    """One kernel over the operands flattened to ``[-1, 16]``, its output
    reshaped to their leading shape (a 2-D batch goes as it is)."""
    shape = args[0].shape
    for a in args[1:]:
        if a.shape != shape:
            raise ValueError(f"operand shapes differ: {tuple(shape)} vs "
                             f"{tuple(a.shape)}")
    if len(shape) == 2:
        return fn(*args, **kw)
    out = fn(*(_flat(a) for a in args), **kw)
    return out.reshape(*shape[:-1], out.shape[-1])


# ---------------------------------------------------------------------------
# arithmetic mod P and mod N
# ---------------------------------------------------------------------------

class Mod:
    """Arithmetic mod a constant ``m`` (secp256k1's P or N) on ``[..., 16]``
    int32 limbs, one kernel launch per operation."""

    def __init__(self, m: int, modulus: str):
        self.m = m
        self.modulus = modulus  # the pow kernel's name for m

    def m_limbs(self, like: torch.Tensor) -> torch.Tensor:
        """The modulus' limbs as a ``[16]`` row on ``like``'s device (it
        broadcasts against ``like``)."""
        return const_row(self.m, like.device)

    def const(self, x: int, like: torch.Tensor) -> torch.Tensor:
        """``x mod m`` in the shape of ``like``: one cached contiguous
        tensor per (constant, shape, device)."""
        rows = like.numel() // NLIMBS
        return const_rows(x % self.m, rows, like.device).view(like.shape)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def inv_batched(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat inverse ``a^(m-2)`` (0 for 0) of every row: the pow
        kernel over the flattened rows, canonicalised as the reference's
        kernel branch does (``eges_tpu/ops/bigint.py`` ``inv_batched``;
        the mod-N kernel is canonical already)."""
        return self.canon(_launch(K.pow_mod_pallas, a, e=self.m - 2,
                                  modulus=self.modulus))

    # canonical-representation hooks; FieldP overrides them for its
    # relaxed values
    def canon(self, a: torch.Tensor) -> torch.Tensor:
        return a

    def is_zero_mod(self, a: torch.Tensor) -> torch.Tensor:
        return is_zero(a)

    def eq_mod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return eq(self.canon(a), self.canon(b))


class FieldP(Mod):
    """The base field F_P with relaxed values: results lie anywhere in
    [0, 2^256), and ``canon``, ``is_zero_mod`` and ``eq_mod`` compare
    residues.  P = 3 mod 4 gives the square root."""

    def __init__(self):
        super().__init__(P, "p")

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _launch(K.fp_mul_pallas, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _launch(K.fp_add_pallas, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _launch(K.fp_sub_pallas, a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return _launch(K.fp_neg_pallas, a)

    def mul_small(self, a: torch.Tensor, k: int) -> torch.Tensor:
        return _launch(K.fp_mul_small_pallas, a, k=k)

    def canon(self, a: torch.Tensor) -> torch.Tensor:
        """Relaxed -> canonical [0, P): one conditional subtract."""
        return _launch(K.fp_canon_pallas, a)

    def is_zero_mod(self, a: torch.Tensor) -> torch.Tensor:
        """a = 0 (mod P) for relaxed a: the limbs are exactly 0 or P."""
        return is_zero(a) | eq(a, self.m_limbs(a))

    def sqrt(self, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(a^((P+1)/4), root_exists)``: the pow kernel over the
        flattened rows for every shape.  The reference takes it for 2-D
        operands and a rolled ``pow_const`` for others; the two give the
        same residue in possibly different relaxed encodings, and every
        caller canonicalises the root before it reads a bit
        (``eges_tpu/ops/bigint.py`` ``FieldP.sqrt``), so the values agree
        at one launch in place of some five hundred."""
        r = _launch(K.pow_mod_pallas, a, e=(P + 1) // 4, modulus="p")
        return r, self.eq_mod(self.sqr(r), a)


class OrderN(Mod):
    """The scalars mod the group order N, canonical values."""

    def __init__(self):
        super().__init__(N, "n")

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _launch(K.fn_mul_pallas, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _launch(K.fn_sub_pallas, a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return _launch(K.fn_neg_pallas, a)

    def red(self, wide: torch.Tensor) -> torch.Tensor:
        """``[..., 17]`` small columns (a 16-limb value with a zero top
        limb appended) -> canonical mod N."""
        if wide.shape[-1] != NLIMBS + 1:
            raise ValueError("red takes [..., 17] columns")
        flat = wide.reshape(-1, NLIMBS + 1).contiguous()
        return K.fn_red17_pallas(flat).reshape(*wide.shape[:-1], NLIMBS)


FP = FieldP()
FN = OrderN()
