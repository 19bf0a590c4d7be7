"""launch-purity: host side effects and implicit device waits in the code
that enqueues kernels.

The port's counterpart of the JAX repo's ``jit-purity`` rule
(``harness/analysis/jit_purity.py``).  PyTorch runs eagerly, so there is
no traced region; its place is taken by the *launch region*: every
function of ``eges_tpu_torch/ops/`` and ``eges_tpu_torch/crypto/`` from
which ``ops/kernels.py:_launch`` — the one place a kernel is put on the
stream — is reachable.  The region is computed by reverse reachability
over the hot-path call graph's resolution (:mod:`hotpath`), seeded at
``ops/kernels.py:_launch`` of whatever tree is scanned.  From each
region function the walk goes on into what it calls, as the reference
walks from a jit root, and flags, anywhere in a reached body:

* ``print`` and logger calls (host output once per launch);
* ``time.time()`` / ``monotonic()`` / ``perf_counter()`` (host clock
  reads, whose value a kernel then computes with);
* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` and ``.synchronize()`` on an event or a
  stream, and ``int()`` / ``float()`` / ``bool()`` of a value that is
  not visibly static (device→host waits that stall the enqueue);
* ``global`` / ``nonlocal`` declarations and subscript writes to
  module-level names (state shared by every caller in the process).

Casts are exempt when the argument is visibly static — a constant, or
derived from ``.shape``/``.ndim``/``.size``/``.dtype``/``len()`` — as in
the reference.  Three kinds of function are neither checked nor walked
through, each by a rule of this checker:

* ``lru_cache``/``cache`` functions: they run once per key on the host
  (``kernels.library()``, which builds and loads the kernels, and the
  constant tables);
* functions named ``*_plain``: the plain PyTorch versions, the CPU and
  test path a wrapper's ``_on_card`` branch selects;
* the facade's resolve methods (``ecrecover``, ``verify``,
  ``recover_addresses``, ``recover_signers``, ``collect_*``): waiting for
  and copying back the result is their job, and host-sync judges them.

The region ends at the facade: the reverse walk adds no caller of an
entry method (a resolve method, ``stage_*``, ``commit_*`` or
``collect_*``) of a class in a module of the architecture manifest's
facade layer (:mod:`layermap`, ``crypto/verifier.py`` in this repo).
Those callers use the facade as the harness and ``chip_smoke.py`` do —
the verifier scheduler's admission thread and lane workers, whose
clocks and casts order windows, not launches — and a ``commit_*``
itself, which enqueues the kernels, is still checked.  A method of the
same name anywhere else passes the region on to its callers.
"""

from __future__ import annotations

import ast

from eges_tpu_torch.harness.analysis import hotpath, layermap
from eges_tpu_torch.harness.analysis.core import Finding, Project

RULE = "launch-purity"

SCAN_PREFIXES = ("eges_tpu_torch/ops/", "eges_tpu_torch/crypto/")
SEED = ("eges_tpu_torch/ops/kernels.py", "_launch")

HOST_CLOCKS = frozenset({"time", "monotonic", "perf_counter",
                         "process_time", "time_ns"})
LOGGER_RECEIVERS = frozenset({"log", "logger", "logging", "LOG"})
LOGGER_METHODS = frozenset({"debug", "info", "warning", "error",
                            "exception", "critical", "geec", "gdbug",
                            "warn", "breakdown"})
STATIC_ATTRS = frozenset({"shape", "ndim", "size", "dtype", "itemsize"})
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
RESOLVE_METHODS = frozenset({"ecrecover", "verify", "recover_addresses",
                             "recover_signers"})
# a method with one of these names, or a resolve method, of a class in
# the facade layer is a facade entry: the launch region's top
ENTRY_PREFIXES = ("stage_", "commit_", "collect")
FACADE_LAYER = "facade"


def _facade_paths(project: Project, paths) -> set[str]:
    """The scanned files in the manifest's facade layer (a layer whose
    name ends in ``facade``); none without a manifest."""
    try:
        manifest = layermap.load(project.root)
    except layermap.ManifestError:
        return set()  # the layers rule reports the broken manifest
    if manifest is None:
        return set()
    out = set()
    for path in paths:
        module = path[:-3].replace("/", ".").removesuffix(".__init__")
        layer = manifest.layer_of(module)
        if layer is not None and layer[1].endswith(FACADE_LAYER):
            out.add(path)
    return out


def _module_globals(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


def _static_cast_arg(node: ast.expr) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant):
            return True
        if isinstance(n, ast.Attribute) and n.attr in STATIC_ATTRS:
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "len"):
            return True
    return False


def _exempt(fn: ast.FunctionDef, cls: str | None) -> bool:
    if hotpath.is_lru_cached(fn) or fn.name.endswith("_plain"):
        return True
    return cls is not None and (fn.name in RESOLVE_METHODS
                                or fn.name.startswith("collect"))


def _violations(path: str, qual: str, fn: ast.FunctionDef,
                globals_: set[str], root: str,
                out: list[Finding]) -> None:
    def emit(line: int, what: str) -> None:
        out.append(Finding(
            rule=RULE, path=path, line=line, symbol=qual,
            message=f"{what} inside the launch region (reached from "
                    f"{root})"))

    for node in ast.walk(fn):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            emit(node.lineno,
                 f"`{type(node).__name__.lower()}` declaration")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in globals_):
                    emit(t.lineno,
                         f"mutation of module-level `{t.value.id}`")
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                if f.id == "print":
                    emit(node.lineno, "`print`")
                elif f.id in ("float", "int", "bool") and node.args and \
                        not _static_cast_arg(node.args[0]):
                    emit(node.lineno,
                         f"`{f.id}()` on a possibly-device value "
                         "(host sync)")
            elif isinstance(f, ast.Attribute):
                recv = f.value.id if isinstance(f.value, ast.Name) else ""
                if recv == "time" and f.attr in HOST_CLOCKS:
                    emit(node.lineno, f"`time.{f.attr}()` host clock read")
                elif (recv in LOGGER_RECEIVERS
                        and f.attr in LOGGER_METHODS):
                    emit(node.lineno, f"logger call `{recv}.{f.attr}`")
                elif f.attr in SYNC_METHODS and not node.args:
                    emit(node.lineno, f"`.{f.attr}()` host sync")
                elif f.attr == "synchronize":
                    emit(node.lineno, "`.synchronize()` host sync")


def check(project: Project) -> list[Finding]:
    modules, by_method = hotpath.call_tables(project)

    # every function of the scanned packages, with its callees there
    funcs: dict[tuple[str, str], tuple[ast.FunctionDef, str | None]] = {}
    for path, mod in modules.items():
        if not path.startswith(SCAN_PREFIXES):
            continue
        for name, fn in mod.defs.items():
            funcs[(path, name)] = (fn, None)
        for cname, tab in mod.classes.items():
            for mname, fn in tab["methods"].items():
                funcs[(path, f"{cname}.{mname}")] = (fn, cname)
    if SEED not in funcs:
        return []
    calls: dict[tuple[str, str], list[tuple[str, str]]] = {}
    callers: dict[tuple[str, str], set[tuple[str, str]]] = {}
    for key, (fn, cls) in funcs.items():
        out = [c for c in hotpath.callees(modules[key[0]], fn, cls,
                                          modules, by_method)
               if c in funcs and c != key]
        calls[key] = out
        for c in out:
            callers.setdefault(c, set()).add(key)

    # the launch region: whatever reaches the seed, up to the facade's
    # entry methods
    facade = _facade_paths(project, {p for p, _ in funcs})
    region = {SEED}
    work = [SEED]
    while work:
        key = work.pop()
        fn, cls = funcs[key]
        if cls is not None and key[0] in facade and (
                fn.name in RESOLVE_METHODS
                or fn.name.startswith(ENTRY_PREFIXES)):
            continue
        for caller in callers.get(key, ()):
            if caller not in region:
                region.add(caller)
                work.append(caller)

    # each region function is checked as its own root; what it calls
    # outside the region is checked under its label
    findings: list[Finding] = []
    seen: set[tuple[str, str]] = set()
    globals_ = {path: _module_globals(modules[path].src.tree)
                for path in {p for p, _ in funcs}}
    for root in sorted(region):
        label = f"{root[0]}:{root[1]}"
        work = [root]
        while work:
            key = work.pop()
            if key in seen or (key in region and key != root):
                continue
            seen.add(key)
            fn, cls = funcs[key]
            if _exempt(fn, cls):
                continue
            _violations(key[0], key[1], fn, globals_[key[0]], label,
                        findings)
            work.extend(calls[key])
    return findings
