"""Architecture-conformance checker over the port: layer map, cycles,
privacy.

A copy of the JAX repo's ``harness/analysis/layers.py``, with the same
rule ids and finding texts.  It extracts the whole-tree module import
graph — pure-AST, like every checker in this package — and reports
three rules against the declared manifest
(:mod:`eges_tpu_torch.harness.analysis.layermap`, or an
``ARCHITECTURE.toml`` at the scan root):

* ``layer-violation`` — a lower-layer module imports a higher-layer
  one.  Eager and lazy (in-function / ``importlib.import_module``)
  imports both count: laziness changes *when* the dependency loads,
  not which way it points.  ``TYPE_CHECKING``-gated imports are
  tracked separately and exempt — they never execute.
* ``import-cycle`` — a strongly-connected component in the *eager*
  import graph (Tarjan).  One finding per cycle, anchored on the
  lexicographically-first member so the fingerprint is stable, with
  every member recorded in ``Finding.related_paths``.  Lazy imports
  are the sanctioned cycle-breaking idiom and are excluded.
* ``private-reach`` — importing or attribute-touching an
  ``_underscore`` name across declared package boundaries.  A
  ``# api: <name>`` comment on the def line blesses an intentional
  cross-package export; same-package reach and dunders are exempt.

The reference's fourth rule, ``perimeter-breach``, checks the ingress
surface, which the port does not have yet (ROADMAP.md, queue A).

Modules under a manifest ``root`` that match no declared package are a
manifest error (Report.errors → exit 2), never a silent skip.
"""

from __future__ import annotations

import ast
import re

from eges_tpu_torch.harness.analysis import layermap
from eges_tpu_torch.harness.analysis.core import Finding, Project, SourceFile

# import kinds
EAGER = "eager"      # module/class body — executes at import time
LAZY = "lazy"        # inside a function, or importlib/__import__ string
TYPING = "typing"    # under `if TYPE_CHECKING:` — never executes

# obj._method() fallback: follow an attribute reference only when at
# most this many scanned classes define the method name (the hotpath.py
# idiom — beyond that the name is too generic)
_UNIQUE_LIMIT = 2


class ImportEdge:
    __slots__ = ("src_mod", "dst_mod", "line", "kind")

    def __init__(self, src_mod: str, dst_mod: str, line: int, kind: str):
        self.src_mod = src_mod
        self.dst_mod = dst_mod
        self.line = line
        self.kind = kind


def module_name(path: str) -> str:
    """Dotted module name of a repo-relative ``.py`` path."""
    mod = path[:-3] if path.endswith(".py") else path
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


class ModuleGraph:
    """The tree's module import graph, computed once per Project."""

    def __init__(self, project: Project):
        self.modules: dict[str, SourceFile] = {}
        for src in project.files:
            self.modules[module_name(src.path)] = src
        self.edges: list[ImportEdge] = []
        for mod, src in sorted(self.modules.items()):
            self.edges.extend(self._file_edges(mod, src))

    # -- extraction -----------------------------------------------------

    def _file_edges(self, mod: str, src: SourceFile) -> list[ImportEdge]:
        # the package relative imports resolve against: the module
        # itself for a package __init__, its parent otherwise
        if src.path.endswith("/__init__.py"):
            pkg = mod
        else:
            pkg = mod.rpartition(".")[0]
        out: list[ImportEdge] = []
        seen: set[tuple[str, int, str]] = set()

        def add(target: str, line: int, kind: str) -> None:
            dst = self._resolve(target)
            if dst is None or dst == mod:
                return
            key = (dst, line, kind)
            if key in seen:
                return
            seen.add(key)
            out.append(ImportEdge(mod, dst, line, kind))

        def visit(node: ast.AST, lazy: bool, typing_only: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    visit(child, True, typing_only)
                elif isinstance(child, ast.If) and \
                        _is_type_checking(child.test):
                    for stmt in child.body:
                        visit_one(stmt, lazy, True)
                    for stmt in child.orelse:
                        visit_one(stmt, lazy, typing_only)
                else:
                    visit_one(child, lazy, typing_only)

        def visit_one(child: ast.AST, lazy: bool,
                      typing_only: bool) -> None:
            kind = TYPING if typing_only else (LAZY if lazy else EAGER)
            if isinstance(child, ast.Import):
                for alias in child.names:
                    add(alias.name, child.lineno, kind)
            elif isinstance(child, ast.ImportFrom):
                base = child.module or ""
                if child.level:
                    root = pkg
                    for _ in range(child.level - 1):
                        root = root.rpartition(".")[0]
                    base = f"{root}.{base}" if base else root
                for alias in child.names:
                    sub = f"{base}.{alias.name}" if base else alias.name
                    if sub in self.modules:
                        add(sub, child.lineno, kind)
                    else:
                        add(base, child.lineno, kind)
            elif isinstance(child, ast.Call):
                target = _import_call_target(child)
                if target:
                    # importlib/__import__ defer binding to call time;
                    # a module-level call still only fires lazily
                    add(target, child.lineno,
                        TYPING if typing_only else LAZY)
                visit(child, lazy, typing_only)
            else:
                visit(child, lazy, typing_only)

        visit(src.tree, False, False)
        return out

    def _resolve(self, target: str) -> str | None:
        """In-tree module a dotted import target lands on, else None
        (external imports are out of scope for the architecture map)."""
        while target:
            if target in self.modules:
                return target
            if "." not in target:
                return None
            target = target.rpartition(".")[0]
        return None


def _is_type_checking(test: ast.expr) -> bool:
    if isinstance(test, ast.Name):
        return test.id == "TYPE_CHECKING"
    if isinstance(test, ast.Attribute):
        return test.attr == "TYPE_CHECKING"
    return False


def _import_call_target(call: ast.Call) -> str | None:
    f = call.func
    name = (f.attr if isinstance(f, ast.Attribute)
            else f.id if isinstance(f, ast.Name) else "")
    if name not in ("import_module", "__import__"):
        return None
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def module_graph(project: Project) -> ModuleGraph:
    cached = getattr(project, "_module_graph", None)
    if cached is None:
        cached = ModuleGraph(project)
        project._module_graph = cached
    return cached


# -- rule 1: layer-violation ---------------------------------------------

def _check_layers(graph: ModuleGraph,
                  manifest: layermap.Manifest) -> list[Finding]:
    out = []
    for e in graph.edges:
        if e.kind == TYPING:
            continue
        src_layer = manifest.layer_of(e.src_mod)
        dst_layer = manifest.layer_of(e.dst_mod)
        if src_layer is None or dst_layer is None:
            continue
        if src_layer[0] >= dst_layer[0]:
            continue
        src = graph.modules[e.src_mod]
        out.append(Finding(
            rule="layer-violation", path=src.path, line=e.line,
            symbol=f"{e.src_mod} -> {e.dst_mod}",
            message=f"{src_layer[1]} module {e.src_mod} imports "
                    f"{dst_layer[1]} module {e.dst_mod} (import at "
                    f"line {e.line}) — lower layers must not depend "
                    f"on higher ones; move the code down, extract an "
                    f"interface, or waive a deliberate "
                    f"instrumentation hook"))
    return out


# -- rule 2: import-cycle ------------------------------------------------

def _tarjan(nodes: list[str],
            succ: dict[str, list[str]]) -> list[list[str]]:
    """Strongly-connected components, iterative Tarjan (the module
    graph is ~100s of nodes but recursion limits are not a budget we
    want to spend)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(succ.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(succ.get(nxt, ()))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    scc.append(member)
                    if member == node:
                        break
                sccs.append(scc)
    return sccs


def _cycle_path(anchor: str, members: set[str],
                succ: dict[str, list[str]]) -> list[str]:
    """A concrete path anchor -> ... -> anchor inside the SCC, so the
    message shows an actual cycle, not just membership."""
    seen = {anchor}
    path = [anchor]

    def dfs(node: str) -> bool:
        for nxt in sorted(succ.get(node, ())):
            if nxt not in members:
                continue
            if nxt == anchor and len(path) > 1:
                return True
            if nxt in seen:
                continue
            seen.add(nxt)
            path.append(nxt)
            if dfs(nxt):
                return True
            path.pop()
        return False

    dfs(anchor)
    return path


def _check_cycles(graph: ModuleGraph) -> list[Finding]:
    succ: dict[str, list[str]] = {}
    edge_line: dict[tuple[str, str], int] = {}
    for e in graph.edges:
        if e.kind != EAGER:
            continue
        succ.setdefault(e.src_mod, []).append(e.dst_mod)
        edge_line.setdefault((e.src_mod, e.dst_mod), e.line)
    out = []
    for scc in _tarjan(sorted(graph.modules), succ):
        if len(scc) < 2:
            continue
        members = set(scc)
        anchor = min(scc)
        cycle = _cycle_path(anchor, members, succ)
        line = 1
        for nxt in cycle[1:] + [anchor]:
            if (anchor, nxt) in edge_line:
                line = edge_line[(anchor, nxt)]
                break
        src = graph.modules[anchor]
        loop = " -> ".join(cycle + [anchor])
        out.append(Finding(
            rule="import-cycle", path=src.path, line=line,
            symbol="cycle:" + ",".join(sorted(members)),
            message=f"eager import cycle: {loop} "
                    f"({len(members)} modules) — break it with a lazy "
                    f"in-function import or extract the shared "
                    f"interface into a lower-layer module",
            related_paths=tuple(sorted(
                graph.modules[m].path for m in members))))
    return out


# -- rule 3: private-reach -----------------------------------------------

def _blessed_names(src: SourceFile) -> set[str]:
    """Names blessed by ``# api: <name>`` on their defining line
    (def/class/assignment) — intentional cross-package exports."""
    out: set[str] = set()

    def scan(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Assign,
                                  ast.AnnAssign)):
                for m in re.finditer(
                        r"api:\s*([A-Za-z_][A-Za-z0-9_]*)",
                        src.line_comment(child.lineno)):
                    out.add(m.group(1))
            if isinstance(child, ast.ClassDef):
                scan(child)

    scan(src.tree)
    return out


def _is_private(name: str) -> bool:
    return name.startswith("_") and not name.startswith("__")


def _receiver_module(recv: ast.expr, aliases: dict[str, str],
                     graph: ModuleGraph) -> str | None:
    """The in-tree module a receiver expression denotes, following the
    file's alias table for the chain root (``import x.y`` makes both
    ``x`` and ``x.y._name`` reach module objects)."""
    parts: list[str] = []
    node = recv
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id)
    if root is None:
        return None
    dotted = ".".join([root] + list(reversed(parts)))
    return dotted if dotted in graph.modules else None


def _check_private(graph: ModuleGraph,
                   manifest: layermap.Manifest) -> list[Finding]:
    out = []
    blessed: dict[str, set[str]] = {}

    def bless(dst_mod: str) -> set[str]:
        if dst_mod not in blessed:
            blessed[dst_mod] = _blessed_names(graph.modules[dst_mod])
        return blessed[dst_mod]

    # method-name owners across the tree, for the obj._method() check
    owners: dict[str, list[str]] = {}
    for mod, src in graph.modules.items():
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                            and _is_private(item.name):
                        owners.setdefault(item.name, []).append(mod)

    for mod, src in sorted(graph.modules.items()):
        src_pkg = manifest.package_of(mod)
        if src_pkg is None:
            continue

        # module aliases bound in this file (import x.y [as z] /
        # from pkg import submodule), for the alias._name check
        aliases: dict[str, str] = {}
        if src.path.endswith("/__init__.py"):
            pkg = mod
        else:
            pkg = mod.rpartition(".")[0]
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        if alias.name in graph.modules:
                            aliases[alias.asname] = alias.name
                    else:
                        top = alias.name.split(".")[0]
                        if top in graph.modules:
                            aliases[top] = top
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    root = pkg
                    for _ in range(node.level - 1):
                        root = root.rpartition(".")[0]
                    base = f"{root}.{base}" if base else root
                for alias in node.names:
                    sub = f"{base}.{alias.name}" if base else alias.name
                    if sub in graph.modules:
                        aliases[alias.asname or alias.name] = sub
                    # from X import _name — the import itself reaches
                    elif base in graph.modules \
                            and _is_private(alias.name):
                        dst_mod = base
                        dst_pkg = manifest.package_of(dst_mod)
                        if dst_pkg is None or dst_pkg == src_pkg:
                            continue
                        if alias.name in bless(dst_mod):
                            continue
                        out.append(Finding(
                            rule="private-reach", path=src.path,
                            line=node.lineno,
                            symbol=f"{mod} -> {dst_mod}.{alias.name}",
                            message=f"cross-package import of private "
                                    f"name {alias.name!r} from "
                                    f"{dst_mod} — bless it with "
                                    f"'# api: {alias.name}' on its "
                                    f"def line or export a public "
                                    f"alias"))

        # alias._name attribute reach + obj._method() near-unique reach
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Attribute) \
                    or not _is_private(node.attr):
                continue
            recv = node.value
            recv_mod = _receiver_module(recv, aliases, graph)
            if recv_mod is not None:
                dst_mod = recv_mod
                dst_pkg = manifest.package_of(dst_mod)
                if dst_pkg is None or dst_pkg == src_pkg:
                    continue
                if node.attr in bless(dst_mod):
                    continue
                if f"{dst_mod}.{node.attr}" in graph.modules:
                    continue  # private submodule import, not a name
                out.append(Finding(
                    rule="private-reach", path=src.path,
                    line=node.lineno,
                    symbol=f"{mod} -> {dst_mod}.{node.attr}",
                    message=f"cross-package reach into private name "
                            f"{node.attr!r} of {dst_mod} — bless it "
                            f"with '# api: {node.attr}' on its def "
                            f"line or export a public alias"))
                continue
            # instance reach: obj._method where at most _UNIQUE_LIMIT
            # classes define the name and ALL owners live in another
            # package (self._x and ambiguous names stay quiet)
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
                continue
            mod_owners = owners.get(node.attr, ())
            if not mod_owners or len(set(mod_owners)) > _UNIQUE_LIMIT:
                continue
            owner_pkgs = {manifest.package_of(m) for m in mod_owners}
            if None in owner_pkgs or src_pkg in owner_pkgs:
                continue
            if any(node.attr in bless(m) for m in set(mod_owners)):
                continue
            dst_mod = sorted(set(mod_owners))[0]
            out.append(Finding(
                rule="private-reach", path=src.path, line=node.lineno,
                symbol=f"{mod} -> {dst_mod}.{node.attr}",
                message=f"cross-package reach into private method "
                        f"{node.attr!r} (defined in {dst_mod}) — "
                        f"bless it with '# api: {node.attr}' on its "
                        f"def line or go through a public wrapper"))
    return out


# -- entry point ---------------------------------------------------------

def check(project: Project) -> list[Finding]:
    # the Project is memoized across runs (core.load_project), so
    # error appends must be idempotent — dedupe before appending
    def loud(msg: str) -> None:
        if msg not in project.errors:
            project.errors.append(msg)

    try:
        manifest = layermap.load(project.root)
    except layermap.ManifestError as e:
        loud(f"architecture manifest: {e}")
        return []
    if manifest is None:
        return []  # no architecture contract declared for this root
    graph = module_graph(project)

    # coverage is loud: a module under a declared root that matches no
    # layer package means the manifest is stale — exit 2, not a skip
    for mod in sorted(graph.modules):
        if manifest.under_root(mod) and manifest.layer_of(mod) is None:
            loud(
                f"architecture manifest ({manifest.source}): module "
                f"{mod} is under a declared root but matches no layer "
                f"package — add it to the layer map")

    out = []
    out.extend(_check_layers(graph, manifest))
    out.extend(_check_cycles(graph))
    out.extend(_check_private(graph, manifest))
    return out
