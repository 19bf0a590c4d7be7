"""transfer-hygiene: H2D placement and staging discipline on the hot path.

A copy of the JAX repo's ``harness/analysis/transfer.py`` for torch.
Three habits keep host↔device traffic off the critical path, and this
rule enforces each:

* **no uploads inside loops** — a ``.to(<device>)``, ``.cuda()``, or
  ``torch.tensor``/``torch.as_tensor`` with ``device=`` in a
  ``for``/``while`` body issues one H2D transfer per iteration; batch
  the operands and upload once per batch;
* **a class that carries ``self.device`` uploads to that device** — a
  bare ``.cuda()`` sends the rows to the *current* card, and a
  ``torch.tensor``/``torch.as_tensor`` without ``device=`` leaves them
  on the host, wherever ``self.device`` says the compute runs; pass
  ``device=self.device`` or ``.to(self.device)``.  (The reference's
  exemptions for mesh-gated branches and ``*to_device*`` helpers wait
  for the port's mesh facade, ROADMAP.md A8.)
* **no staging-buffer reuse while a batch is in flight** — the
  split-phase ``stage_*`` half runs concurrently with an earlier
  batch's device compute; touching the single-buffer ``_stag*`` pool
  there overwrites operands the device may still be reading.  Staging
  must go through the double-buffered pair (``_pipe*``) or a
  checked-out pool slot.  The port has no split phase yet (ROADMAP.md
  A4), so on its tree this sub-rule has nothing to check; its fixture
  proves it.
"""

from __future__ import annotations

import ast

from eges_tpu_torch.harness.analysis import hotpath
from eges_tpu_torch.harness.analysis.core import Finding, Project

RULE = "transfer-hygiene"

_CTORS = frozenset({"tensor", "as_tensor"})
# constructors without device= build on the host: no transfer of their
# own, but on a device-carrying class the rows are then not where the
# compute runs
_HOST_CTORS = frozenset({"torch.tensor", "torch.as_tensor"})
# uploads that do not say where the rows go, and where they land instead
_UNPINNED = {".cuda()": "sends operands to the current card",
             "torch.tensor": "leaves operands on the host",
             "torch.as_tensor": "leaves operands on the host"}


def _device_like(node: ast.expr) -> bool:
    """An argument of ``.to(...)`` that names a device, not a dtype: a
    device string other than the host's, ``torch.device(...)``, or a
    name that says device (``self.device``, ``dev``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value != "cpu"
    if isinstance(node, ast.Call):
        f = node.func
        return isinstance(f, ast.Attribute) and f.attr == "device"
    name = (node.attr if isinstance(node, ast.Attribute)
            else node.id if isinstance(node, ast.Name) else "")
    return "dev" in name.lower()


def _upload_desc(node: ast.Call) -> str | None:
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    kw = {k.arg for k in node.keywords}
    if f.attr == "cuda":
        return ".cuda()"
    if f.attr == "to" and (
            "device" in kw or (node.args and _device_like(node.args[0]))):
        return ".to(<device>)"
    if f.attr in _CTORS and isinstance(f.value, ast.Name) \
            and f.value.id == "torch":
        return f"torch.{f.attr}" + (" with device=" if "device" in kw
                                    else "")
    return None


def _device_classes(graph: hotpath.HotGraph) -> set[tuple[str, str]]:
    """(path, class) pairs that assign ``self.device`` anywhere — these
    have a better home for tensors than the host or the current card."""
    carrying: set[tuple[str, str]] = set()
    for path, mod in graph.modules.items():
        for cname, tab in mod.classes.items():
            for fn in tab["methods"].values():
                for node in ast.walk(fn):
                    if (isinstance(node, ast.Attribute)
                            and isinstance(node.ctx, ast.Store)
                            and isinstance(node.value, ast.Name)
                            and node.value.id == "self"
                            and node.attr == "device"):
                        carrying.add((path, cname))
    return carrying


class _Scan(ast.NodeVisitor):
    def __init__(self, fn: hotpath.HotFunction, device_class: bool,
                 findings: list[Finding]):
        self.fn = fn
        self.device_class = device_class
        self.findings = findings
        self.loop_depth = 0
        self.staging = fn.node.name.startswith("stage")

    def visit_For(self, node: ast.For) -> None:
        self._loop(node)

    def visit_While(self, node: ast.While) -> None:
        self._loop(node)

    def _loop(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Attribute(self, node: ast.Attribute) -> None:
        fn = self.fn
        if (self.staging and isinstance(node.ctx, ast.Load)
                and node.attr.startswith("_stag")
                and "lock" not in node.attr
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            self.findings.append(Finding(
                rule=RULE, path=fn.path, line=node.lineno,
                symbol=fn.qualname,
                message=f"stage-phase access to single-buffer "
                        f"{node.attr} — the previous window's device "
                        "compute may still be reading it; use the "
                        "double-buffered pair or a checked-out pool "
                        "slot"))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        desc = _upload_desc(node)
        fn = self.fn
        if desc is not None:
            if self.loop_depth and desc not in _HOST_CTORS:
                self.findings.append(Finding(
                    rule=RULE, path=fn.path, line=node.lineno,
                    symbol=fn.qualname,
                    message=f"{desc} inside a loop on the hot path "
                            f"(via {fn.entry}) — one H2D transfer per "
                            "iteration; batch operands and upload once "
                            "per window"))
            elif self.device_class and desc in _UNPINNED:
                self.findings.append(Finding(
                    rule=RULE, path=fn.path, line=node.lineno,
                    symbol=fn.qualname,
                    message=f"{desc} {_UNPINNED[desc]} on a class that "
                            "carries self.device — pass "
                            "device=self.device or .to(self.device) so "
                            "rows land where the compute runs"))
        self.generic_visit(node)


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    graph = hotpath.hot_graph(project)
    carrying = _device_classes(graph)
    for fn in graph.functions():
        if not hotpath.imports_torch(fn.src):
            continue
        device_class = fn.cls is not None and (fn.path, fn.cls) in carrying
        scan = _Scan(fn, device_class, findings)
        for stmt in fn.node.body:
            scan.visit(stmt)
    return findings
