"""host-sync: blocking device reads on the verifier hot path.

A copy of the JAX repo's ``harness/analysis/host_sync.py`` for torch.
The facade is a pipeline — H2D upload, kernel launches, D2H collect —
and its throughput is set by the slowest stage.  A stray ``.item()`` /
``.tolist()`` / ``.cpu()`` / ``.numpy()`` / ``torch.cuda.synchronize()``
in the middle of that pipeline parks the host thread on the device and
turns asynchronous launches back into lock-step round trips (``PERF.md``
section 6: 330 glue operations that waited on the card slowed verify).

Scope: functions in the hot-path call graph (:mod:`hotpath`) living in
files that import torch — the host models and bucketing are torch-free
by contract and never touch the device, so they are out of scope by
construction, not by waiver.

Two sub-rules:

* a blocking read while **holding a lock** always fires, even at a
  resolve boundary: every concurrent caller serializes behind one
  device wait, which is a concurrency bug, not a pipeline tax;
* a blocking read **mid-pipeline** fires unless it is debug-gated
  (inside ``if self.debug_timing:`` / an ``EGES_VERIFIER_TIMING``
  check) or sits at a resolve boundary — the synchronous facade
  methods (``ecrecover``/``verify``/``recover_addresses``/
  ``recover_signers``) and the ``collect_*`` halves of the split-phase
  API, whose entire job is to wait for and download the result.
"""

from __future__ import annotations

import ast

from eges_tpu_torch.harness.analysis import hotpath
from eges_tpu_torch.harness.analysis.core import Finding, Project

RULE = "host-sync"

# synchronous facades and collect halves: waiting for the device is
# their contract, not a defect
_BOUNDARY_NAMES = frozenset({"ecrecover", "verify", "recover_addresses",
                             "recover_signers"})

_DEBUG_MARKS = ("debug_timing", "EGES_VERIFIER_TIMING", "debug")

# tensor methods that wait for the device and copy to the host
_SYNC_METHODS = {"item": ".item() (scalar D2H sync)",
                 "tolist": ".tolist() (D2H copy)",
                 "cpu": ".cpu() (D2H copy)",
                 "numpy": ".numpy() (D2H copy)"}


def _is_boundary(fn_name: str) -> bool:
    return fn_name in _BOUNDARY_NAMES or fn_name.startswith("collect")


def _is_debug_test(test: ast.expr) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in _DEBUG_MARKS:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _DEBUG_MARKS:
            return True
        if (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and "EGES_VERIFIER_TIMING" in node.value):
            return True
    return False


def _lock_name(expr: ast.expr) -> str | None:
    """Name of the lock in a ``with <expr>:`` item, or None."""
    node = expr
    if isinstance(node, ast.Call):
        node = node.func
    name = None
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    if name is not None and "lock" in name.lower():
        return name
    return None


def _blocking_call(node: ast.Call) -> str | None:
    """Describe the blocking device read this call performs, or None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr == "synchronize":
            return "synchronize (device fence)"
        if (f.attr in _SYNC_METHODS and not node.args
                and not node.keywords):
            return _SYNC_METHODS[f.attr]
    return None


class _Scan(ast.NodeVisitor):
    def __init__(self, hot_fn: hotpath.HotFunction,
                 findings: list[Finding]):
        self.fn = hot_fn
        self.findings = findings
        self.locks: list[str] = []
        self.debug_depth = 0

    def visit_With(self, node: ast.With) -> None:
        held = [n for item in node.items
                if (n := _lock_name(item.context_expr)) is not None]
        self.locks.extend(held)
        for stmt in node.body:
            self.visit(stmt)
        del self.locks[len(self.locks) - len(held):len(self.locks)]

    def visit_If(self, node: ast.If) -> None:
        gated = _is_debug_test(node.test)
        if gated:
            self.debug_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if gated:
            self.debug_depth -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    # nested defs start fresh scopes; the graph walks them separately
    # if they are actually reachable
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        desc = _blocking_call(node)
        if desc is not None:
            self._flag(node, desc)
        self.generic_visit(node)

    def _flag(self, node: ast.Call, desc: str) -> None:
        fn = self.fn
        if self.locks:
            self.findings.append(Finding(
                rule=RULE, path=fn.path, line=node.lineno,
                symbol=fn.qualname,
                message=f"{desc} while holding {self.locks[-1]} on the "
                        f"hot path (via {fn.entry}) — every concurrent "
                        "submitter serializes behind this device wait; "
                        "fence and download outside the lock"))
            return
        if self.debug_depth or _is_boundary(fn.node.name):
            return
        self.findings.append(Finding(
            rule=RULE, path=fn.path, line=node.lineno,
            symbol=fn.qualname,
            message=f"{desc} mid-pipeline on the hot path (via "
                    f"{fn.entry}) — stalls the dispatch loop on the "
                    "device; move the sync to a collect/resolve "
                    "boundary or gate it behind the timing debug flag"))


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    graph = hotpath.hot_graph(project)
    for fn in graph.functions():
        if not hotpath.imports_torch(fn.src):
            continue
        scan = _Scan(fn, findings)
        for stmt in fn.node.body:
            scan.visit(stmt)
    return findings
