"""dtype-promotion: default dtypes and 64-bit floats in device code.

The port's counterpart of the JAX repo's ``harness/analysis/dtypes.py``.
The limb kernels read ``int32`` words (as ``uint32_t``) and wire bytes as
``uint8``; a constructor without a dtype makes float32 (``torch.zeros``)
or takes its type from the fill (``torch.full``, ``torch.tensor`` of a
literal: int64 or float32), and a float32 limb buffer passed to a kernel
is read as garbage or refused by the wrapper's dtype check.

Whole-file scan of the port's ``ops/`` and ``crypto/`` modules that
import torch (the device layer; the harness stays host-side):

* ``torch.zeros/ones/empty/full`` without an explicit ``dtype=``;
* ``torch.tensor``/``torch.as_tensor`` of a python literal (list/tuple/
  numeric constant/comprehension) without ``dtype=`` — tensors built
  from existing typed values keep their dtype and are exempt;
* any ``torch.float64``/``torch.double`` reference, and ``dtype=float``
  (python's float is float64 to torch).

Unlike the reference's 64-bit sub-rule, int64 is not flagged: it is the
port's deliberate CPU carrier for 32-bit limb values, because torch on
the CPU has no uint32 arithmetic (``ROADMAP.md``, rig facts), and the
plain versions hold limbs in int64 by design (``ops/field.py``).
"""

from __future__ import annotations

import ast

from eges_tpu_torch.harness.analysis import hotpath
from eges_tpu_torch.harness.analysis.core import Finding, Project

RULE = "dtype-promotion"

SCAN_PREFIXES = ("eges_tpu_torch/ops/", "eges_tpu_torch/crypto/")

_CTORS = frozenset({"zeros", "ones", "empty", "full"})
_WRAPPERS = frozenset({"tensor", "as_tensor"})
_BAD_DTYPES = frozenset({"float64", "double"})


def _torch_attr(node: ast.expr) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "torch"):
        return node.attr
    return None


def _literal_operand(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Tuple, ast.ListComp)):
        return True
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)) and not isinstance(node.value, bool)


def _dtype_kw(node: ast.Call) -> ast.expr | None:
    for kw in node.keywords:
        if kw.arg == "dtype":
            return kw.value
    return None


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for src in project.files:
        if not src.path.startswith(SCAN_PREFIXES):
            continue
        if not hotpath.imports_torch(src):
            continue
        for node in ast.walk(src.tree):
            attr = _torch_attr(node)
            if attr in _BAD_DTYPES:
                findings.append(Finding(
                    rule=RULE, path=src.path, line=node.lineno,
                    symbol=f"torch.{attr}",
                    message=f"torch.{attr} in device code — the kernels "
                            "read 32-bit limbs and bytes, and a 64-bit "
                            "float doubles every buffer's footprint; pin "
                            "torch.int32/uint8 (int64 only as the CPU "
                            "carrier)"))
                continue
            if not isinstance(node, ast.Call):
                continue
            fname = _torch_attr(node.func)
            if fname is None:
                continue
            dtype = _dtype_kw(node)
            if dtype is not None:
                if isinstance(dtype, ast.Name) and dtype.id == "float":
                    findings.append(Finding(
                        rule=RULE, path=src.path, line=node.lineno,
                        symbol=f"torch.{fname}",
                        message="dtype=float requests torch.float64 in "
                                "device code — pin an explicit 32-bit "
                                "torch dtype"))
                continue
            if fname in _CTORS:
                findings.append(Finding(
                    rule=RULE, path=src.path, line=node.lineno,
                    symbol=f"torch.{fname}",
                    message=f"torch.{fname} without an explicit dtype "
                            "defaults to float32 (or the fill's type) — "
                            "limb buffers must pin torch.int32/uint8 "
                            "explicitly"))
            elif fname in _WRAPPERS and len(node.args) == 1 and \
                    _literal_operand(node.args[0]):
                findings.append(Finding(
                    rule=RULE, path=src.path, line=node.lineno,
                    symbol=f"torch.{fname}",
                    message=f"torch.{fname} of a python literal without "
                            "dtype takes int64 or float32 from the "
                            "literal — pass dtype=torch.int32/uint8"))
    return findings
