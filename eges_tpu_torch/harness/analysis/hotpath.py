"""Shared hot-path call graph for the port's device-hygiene checkers.

A copy of the JAX repo's ``harness/analysis/hotpath.py``.  The rules
host-sync and transfer-hygiene reason about the same region of code:
everything the verifier facade executes per batch.  This module
computes that region ONCE per :class:`Project` — a conservative call
graph rooted at the dispatch entry points — and the checkers share it,
so "hot" means the same thing to every rule.  launch-purity walks the
same call graph (:func:`modules`, :func:`callees`) from its own roots.

Roots are seeded two ways:

* **name-based** — the known entry surface: methods in
  :data:`ENTRY_METHODS` on classes whose name marks them as part of the
  dispatch plane (``*Scheduler``, ``*Verifier``, ``*DeviceTarget``,
  ``*DeviceLane``).  In the port today that is ``BatchVerifier``'s
  ``ecrecover``, ``recover_addresses`` and ``verify``;
* **annotation-based** — a ``# hot-path-entry`` comment on a ``def``
  line seeds that function explicitly (new entry points that don't fit
  the naming pattern declare themselves).

Edges are resolved conservatively, pure-AST, as in the reference:
``self.method()`` within the class (including ``self._x = self._y``
method aliases assigned in any method of the class), bare names through
module defs and the import table (lazy in-function imports included),
module-alias attribute calls, and ``obj.method()`` when at most
:data:`_UNIQUE_LIMIT` scanned classes define that method name
(over-approximation is the right failure mode for a hot SET).  One
edge more than the reference: a function passed by name as a call's
argument is taken as called, since the port's front door launches
through a helper that takes the kernel wrapper as its first argument
(``ops/bigint.py`` ``_launch(K.fp_mul_pallas, a, b)``).
"""

from __future__ import annotations

import ast

from eges_tpu_torch.harness.analysis.core import Project, SourceFile

# the scheduler/verifier dispatch surface: admission, the coalescing
# dispatcher, the per-device lane workers, and the split-phase +
# synchronous device facades they drive
ENTRY_METHODS = frozenset({
    "submit", "kick", "ecrecover", "verify", "recover_addresses",
    "recover_signers", "stage_recover", "commit_recover",
    "collect_recover", "_dispatch_loop", "_dispatch_forever",
    "_lane_loop", "_run_batch",
})

_ENTRY_CLASS_MARKS = ("Scheduler", "Verifier", "DeviceTarget",
                      "DeviceLane")

# obj.method() fallback: follow only when the method name is defined by
# at most this many scanned classes (beyond that the name is too
# generic to mean anything)
_UNIQUE_LIMIT = 2

_GENERIC_METHODS = frozenset({
    "get", "put", "set", "add", "pop", "append", "items", "keys",
    "values", "update", "close", "start", "join", "result", "copy",
    "read", "write", "send", "load", "save", "run",
})


def _entry_class(name: str) -> bool:
    return any(name.endswith(mark) or mark in name
               for mark in _ENTRY_CLASS_MARKS)


def _mod_paths(dotted: str) -> tuple[str, str]:
    base = dotted.replace(".", "/")
    return (base + ".py", base + "/__init__.py")


class _Module:
    """Symbol tables for one file: module defs, classes (methods plus
    ``self._x = self._y`` method aliases), and the import table — lazy
    in-function imports included (``ast.walk``, not just the body)."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.defs: dict[str, ast.FunctionDef] = {}
        self.classes: dict[str, dict] = {}
        self.imports: dict[str, str] = {}
        self.from_imports: dict[str, tuple[str, str]] = {}
        pkg = src.path.rsplit("/", 1)[0].replace("/", ".") \
            if "/" in src.path else ""
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or
                                 alias.name.split(".")[0]] = alias.name
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level:
                    base = pkg.rsplit(".", node.level - 1)[0] \
                        if node.level > 1 else pkg
                    mod = f"{base}.{mod}" if mod else base
                for alias in node.names:
                    self.from_imports[alias.asname or alias.name] = (
                        mod, alias.name)
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                methods: dict[str, ast.FunctionDef] = {}
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        methods[item.name] = item
                aliases: dict[str, str] = {}
                for item in ast.walk(node):
                    if not isinstance(item, ast.Assign):
                        continue
                    if not (isinstance(item.value, ast.Attribute)
                            and isinstance(item.value.value, ast.Name)
                            and item.value.value.id == "self"
                            and item.value.attr in methods):
                        continue
                    for t in item.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            aliases[t.attr] = item.value.attr
                self.classes[node.name] = {"methods": methods,
                                           "aliases": aliases}


class HotFunction:
    """One function in the hot set, with enough context to report on."""

    __slots__ = ("path", "qualname", "src", "node", "cls", "entry")

    def __init__(self, path: str, qualname: str, src: SourceFile,
                 node: ast.FunctionDef, cls: str | None, entry: str):
        self.path = path
        self.qualname = qualname
        self.src = src
        self.node = node
        self.cls = cls
        self.entry = entry  # the entry point this was first reached from


class HotGraph:
    def __init__(self, funcs: dict[tuple[str, str], HotFunction],
                 modules: dict[str, _Module]):
        self.funcs = funcs
        self.modules = modules

    def functions(self) -> list[HotFunction]:
        return [self.funcs[k] for k in sorted(self.funcs)]


def imports_torch(src: SourceFile) -> bool:
    """True when the file imports torch anywhere (module level or lazily
    inside a function) — files that are torch-free by contract (the
    pure-Python host models, bucketing) never touch the device and the
    device rules must stay silent on them."""
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            if any(a.name == "torch" or a.name.startswith("torch.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "torch" or mod.startswith("torch."):
                return True
    return False


def _named_def(mod: _Module, expr: ast.expr,
               modules: dict[str, _Module]) -> tuple[str, str] | None:
    """The module-level function a bare name or a module-alias attribute
    (``helper``, ``K.fp_mul_pallas``) denotes, through this module's defs
    and import table; None for anything else."""
    if isinstance(expr, ast.Name):
        if expr.id in mod.defs:
            return (mod.src.path, expr.id)
        if expr.id in mod.from_imports:
            dotted, orig = mod.from_imports[expr.id]
            for path in _mod_paths(dotted):
                if path in modules and orig in modules[path].defs:
                    return (path, orig)
        return None
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        recv = expr.value.id
        dotted = mod.imports.get(recv)
        if dotted is None and recv in mod.from_imports:
            base, orig = mod.from_imports[recv]
            dotted = f"{base}.{orig}" if base else orig
        if dotted:
            for path in _mod_paths(dotted):
                if path in modules and expr.attr in modules[path].defs:
                    return (path, expr.attr)
    return None


def callees(mod: _Module, fn: ast.FunctionDef, cls: str | None,
            modules: dict[str, _Module],
            by_method: dict[str, list[tuple[str, str]]]) -> list:
    """(path, qualname) pairs this body may call, conservatively."""
    out: list[tuple[str, str]] = []
    cls_tab = mod.classes.get(cls or "", {})
    methods = cls_tab.get("methods", {})
    aliases = cls_tab.get("aliases", {})
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        # a function handed to a call by name is taken as called
        for arg in [*node.args, *(kw.value for kw in node.keywords)]:
            target = _named_def(mod, arg, modules)
            if target is not None:
                out.append(target)
        f = node.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and cls):
            name = aliases.get(f.attr, f.attr)
            if name in methods:
                out.append((mod.src.path, f"{cls}.{name}"))
                continue
        target = _named_def(mod, f, modules)
        if target is not None:
            out.append(target)
            continue
        # obj.method() fallback: near-unique method names only
        if (isinstance(f, ast.Attribute)
                and f.attr not in _GENERIC_METHODS
                and not f.attr.startswith("__")):
            owners = by_method.get(f.attr, ())
            if 0 < len(owners) <= _UNIQUE_LIMIT:
                out.extend(owners)
    return out


def call_tables(project: Project) -> tuple[dict[str, _Module],
                                           dict[str, list[tuple[str, str]]]]:
    """Every file's symbol tables and the method-name owners the
    ``obj.method()`` fallback reads, computed once per project (the
    hot graph and launch-purity share them)."""
    cached = getattr(project, "_call_tables", None)
    if cached is not None:
        return cached
    modules = {src.path: _Module(src) for src in project.files}
    by_method: dict[str, list[tuple[str, str]]] = {}
    for path, mod in modules.items():
        for cname, tab in mod.classes.items():
            for mname in tab["methods"]:
                by_method.setdefault(mname, []).append(
                    (path, f"{cname}.{mname}"))
    project._call_tables = (modules, by_method)
    return modules, by_method


def hot_graph(project: Project) -> HotGraph:
    """The hot-path call graph, computed once and cached on the
    project (the device-hygiene checkers share one instance)."""
    cached = getattr(project, "_hot_graph", None)
    if cached is not None:
        return cached

    modules, by_method = call_tables(project)

    # seeds: the known entry surface + explicit annotations
    seeds: list[tuple[str, str]] = []
    for path, mod in modules.items():
        for cname, tab in mod.classes.items():
            for mname, fn in tab["methods"].items():
                if ((_entry_class(cname) and mname in ENTRY_METHODS)
                        or "hot-path-entry" in
                        mod.src.line_comment(fn.lineno)):
                    seeds.append((path, f"{cname}.{mname}"))
        for fname, fn in mod.defs.items():
            if "hot-path-entry" in mod.src.line_comment(fn.lineno):
                seeds.append((path, fname))

    funcs: dict[tuple[str, str], HotFunction] = {}
    work = [(path, qual, qual) for path, qual in sorted(seeds)]
    while work:
        path, qual, entry = work.pop()
        if (path, qual) in funcs:
            continue
        mod = modules.get(path)
        if mod is None:
            continue
        cls, _, mname = qual.rpartition(".")
        if cls:
            fn = mod.classes.get(cls, {}).get("methods", {}).get(mname)
        else:
            fn = mod.defs.get(qual)
        if fn is None:
            continue
        cls = cls or None
        funcs[(path, qual)] = HotFunction(path, qual, mod.src, fn, cls,
                                          entry)
        for cpath, cqual in callees(mod, fn, cls, modules, by_method):
            if (cpath, cqual) not in funcs:
                work.append((cpath, cqual, entry))

    graph = HotGraph(funcs, modules)
    project._hot_graph = graph
    return graph


def is_lru_cached(fn: ast.FunctionDef) -> bool:
    """``@functools.lru_cache`` / ``@cache`` functions build their
    result once per distinct key: host-side tables of constants and the
    kernel library, made once, not per launch."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = (target.attr if isinstance(target, ast.Attribute)
                else target.id if isinstance(target, ast.Name) else "")
        if name in ("lru_cache", "cache"):
            return True
    return False
