"""Declared architecture manifest for the port's layer-conformance
checker: a copy of the JAX repo's ``harness/analysis/layermap.py`` with
the port's own :data:`MANIFEST`.

The manifest names the port's layer map (``PERF.md`` section 3) so
:mod:`eges_tpu_torch.harness.analysis.layers` can machine-check it.
Two sources, first hit wins:

* ``ARCHITECTURE.toml`` at the scan root (fixture trees declare their
  own tiny manifests this way; parsed by the strict subset reader
  below — the analysis framework imports nothing but the stdlib);
* the :data:`MANIFEST` Python literal below (the real tree's map).

**Semantics.**  ``layers`` is ordered lowest → highest; each entry
carries a name and the dotted package prefixes it owns.  A module's
layer is the *longest* dotted-prefix match over every declared package
— except packages that are also listed in ``roots``, which match their
own module (the package ``__init__``) exactly and never swallow
descendants.  That exception is what makes coverage loud: every module
under a root must match some declared package, and one that doesn't is
a manifest error (exit 2), not a silent skip — a new module must be
placed in the map before it can land.

The reference's ``perimeter`` and ``facade`` keys (the ingress surface
that ``perimeter-breach`` checks) are not read: the port's gate has no
``perimeter-breach`` rule yet (its ``ingress/`` copy is placed as a
layer), so its map declares neither, and a fixture manifest that
declares them is checked for its layers alone.
"""

from __future__ import annotations

import dataclasses
import os

# The port's layer map, derived from its import graph (lazy imports
# included).  Lower layers must not import higher ones, eagerly OR
# lazily.  ``ops/curve.py`` lazily imports the host model
# ``crypto/secp256k1.py`` to build its window tables, so the pure-Python
# host copies of ``crypto/`` sit in the lowest layer, with the host
# verify paths (``crypto/native.py``, ``crypto/verify_host.py``) and the
# copies of the reference's ``utils/`` (metrics, tracing, profiler,
# ledger, devstats), which the facade and the scheduler publish into.
# ``crypto/verifier.py`` is the facade; the scheduler sits above it: it
# drives the facade's methods duck-typed and imports nothing of it.
# The host copies follow the reference's order above the registry:
# ``core/`` (chain, state, EVM, txpool, engines, the EVM tracer; the
# PoW sweep reaches ``ops/keccak.py``), ``consensus/`` with the network
# planes ``net/`` over it, the node layer over both (``ingress/``, the
# node service ``node/``, ``rpc/`` and ``bootnode/``, as the
# reference's L3-node), and ``sim/`` at the top with the harness (it
# wires every layer into a cluster); their host helpers (log, limits,
# journal, timeseries, debug, keys, bn254, the artifact store over
# ``ops/build.py``) sit in the lowest layer with the other ``utils/``
# and ``crypto/`` copies.
# The three sub-packages are roots as well as the package, so their
# ``__init__`` matches exactly and a new module under ``ops/``,
# ``crypto/`` or ``utils/`` is a manifest error until it is placed here.
MANIFEST = {
    "roots": ["eges_tpu_torch", "eges_tpu_torch.ops",
              "eges_tpu_torch.crypto", "eges_tpu_torch.utils"],
    "layers": [
        {"name": "L0-kernels",
         "packages": ["eges_tpu_torch", "eges_tpu_torch.ops",
                      "eges_tpu_torch.crypto", "eges_tpu_torch.utils",
                      "eges_tpu_torch.ops.build", "eges_tpu_torch.ops.kernels",
                      "eges_tpu_torch.ops.opcount", "eges_tpu_torch.ops.field",
                      "eges_tpu_torch.ops.curve",
                      "eges_tpu_torch.crypto.secp256k1",
                      "eges_tpu_torch.crypto.keccak",
                      "eges_tpu_torch.crypto.bucketing",
                      "eges_tpu_torch.crypto.native",
                      "eges_tpu_torch.crypto.verify_host",
                      "eges_tpu_torch.utils.metrics",
                      "eges_tpu_torch.utils.tracing",
                      "eges_tpu_torch.utils.profiler",
                      "eges_tpu_torch.utils.ledger",
                      "eges_tpu_torch.utils.devstats",
                      "eges_tpu_torch.utils.log",
                      "eges_tpu_torch.utils.limits",
                      "eges_tpu_torch.utils.journal",
                      "eges_tpu_torch.utils.timeseries",
                      "eges_tpu_torch.crypto.keys",
                      "eges_tpu_torch.crypto.bn254",
                      "eges_tpu_torch.crypto.aotstore",
                      "eges_tpu_torch.utils.debug"]},
        {"name": "L1-pipeline",
         "packages": ["eges_tpu_torch.ops.bigint", "eges_tpu_torch.ops.ec",
                      "eges_tpu_torch.ops.keccak"]},
        {"name": "L2-facade",
         "packages": ["eges_tpu_torch.crypto.verifier"]},
        {"name": "L3-scheduler",
         "packages": ["eges_tpu_torch.crypto.scheduler"]},
        {"name": "L4-registry",
         "packages": ["eges_tpu_torch.models"]},
        {"name": "L5-core",
         "packages": ["eges_tpu_torch.core"]},
        {"name": "L6-consensus",
         "packages": ["eges_tpu_torch.consensus", "eges_tpu_torch.net"]},
        {"name": "L7-node",
         "packages": ["eges_tpu_torch.ingress", "eges_tpu_torch.node",
                      "eges_tpu_torch.rpc", "eges_tpu_torch.bootnode"]},
        {"name": "L8-harness",
         "packages": ["eges_tpu_torch.sim", "eges_tpu_torch.harness",
                      "eges_tpu_torch.testing"]},
    ],
}


class ManifestError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Validated layer map with the prefix-match lookup checkers use."""

    layers: tuple[tuple[str, tuple[str, ...]], ...]
    roots: tuple[str, ...]
    source: str

    def layer_of(self, module: str) -> tuple[int, str] | None:
        """(index, name) of the owning layer, longest-prefix match;
        root packages match exactly (their ``__init__`` only)."""
        best: tuple[int, tuple[int, str]] | None = None
        for idx, (name, packages) in enumerate(self.layers):
            for pkg in packages:
                if module == pkg:
                    matched = len(pkg)
                elif (module.startswith(pkg + ".")
                        and pkg not in self.roots):
                    matched = len(pkg)
                else:
                    continue
                if best is None or matched > best[0]:
                    best = (matched, (idx, name))
        return best[1] if best else None

    def package_of(self, module: str) -> str | None:
        """The declared package prefix that owns ``module`` — the
        boundary private-reach is judged against."""
        best: str | None = None
        for _, packages in self.layers:
            for pkg in packages:
                if module != pkg and not (module.startswith(pkg + ".")
                                          and pkg not in self.roots):
                    continue
                if best is None or len(pkg) > len(best):
                    best = pkg
        return best

    def under_root(self, module: str) -> bool:
        return any(module == r or module.startswith(r + ".")
                   for r in self.roots)


def _validate(raw: dict, source: str) -> Manifest:
    layers = []
    seen: dict[str, str] = {}
    for entry in raw.get("layers", ()):
        name = entry.get("name")
        packages = tuple(entry.get("packages", ()))
        if not name or not packages:
            raise ManifestError(
                f"{source}: each layer needs a name and a non-empty "
                f"packages list (got {entry!r})")
        for pkg in packages:
            if pkg in seen:
                raise ManifestError(
                    f"{source}: package {pkg!r} declared in both "
                    f"{seen[pkg]!r} and {name!r}")
            seen[pkg] = name
        layers.append((name, packages))
    if not layers:
        raise ManifestError(f"{source}: manifest declares no layers")
    return Manifest(layers=tuple(layers),
                    roots=tuple(raw.get("roots", ())),
                    source=source)


# the repo this file ships in — the only root MANIFEST speaks for
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def load(root: str) -> Manifest | None:
    """The manifest governing a scan rooted at ``root``: an
    ``ARCHITECTURE.toml`` at the root wins; the :data:`MANIFEST`
    literal applies only to the repo it describes.  ``None`` (no
    architecture contract declared for this tree — synthetic fixture
    roots) keeps the layer rules silent rather than judging a foreign
    tree against this repo's map."""
    toml_path = os.path.join(root, "ARCHITECTURE.toml")
    if os.path.exists(toml_path):
        with open(toml_path, "r", encoding="utf-8") as fh:
            return _validate(parse_toml_subset(fh.read(), toml_path),
                             os.path.basename(toml_path))
    if os.path.abspath(root) == _REPO_ROOT:
        return _validate(MANIFEST,
                         "eges_tpu_torch/harness/analysis/layermap.py")
    return None


# -- strict TOML subset --------------------------------------------------
#
# Exactly what a manifest needs and nothing more: bare-key assignments
# whose values are double-quoted strings or single-line arrays of
# them, ``[[layer]]`` array-of-tables headers, comments, blank lines.
# Anything else is a loud ManifestError — a manifest that doesn't
# parse must never silently weaken the gate.

def _strip_comment(line: str) -> str:
    out, in_str = [], False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        elif ch == "#" and not in_str:
            break
        out.append(ch)
    return "".join(out).strip()


def _parse_value(text: str, where: str):
    text = text.strip()
    if text.startswith('"') and text.endswith('"') and len(text) >= 2:
        return text[1:-1]
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = []
        for part in inner.split(","):
            part = part.strip()
            if not part:
                continue
            if not (part.startswith('"') and part.endswith('"')):
                raise ManifestError(
                    f"{where}: array items must be quoted strings "
                    f"(got {part!r})")
            items.append(part[1:-1])
        return items
    raise ManifestError(
        f"{where}: unsupported value {text!r} — the manifest subset "
        "allows \"strings\" and single-line [\"arrays\"] only")


def parse_toml_subset(text: str, path: str) -> dict:
    raw: dict = {"layers": []}
    target: dict = raw
    for lineno, line in enumerate(text.splitlines(), 1):
        where = f"{path}:{lineno}"
        line = _strip_comment(line)
        if not line:
            continue
        if line == "[[layer]]":
            target = {}
            raw["layers"].append(target)
            continue
        if line.startswith("["):
            raise ManifestError(
                f"{where}: only [[layer]] tables are supported "
                f"(got {line!r})")
        key, eq, value = line.partition("=")
        if not eq:
            raise ManifestError(f"{where}: expected key = value")
        target[key.strip()] = _parse_value(value, where)
    return raw
