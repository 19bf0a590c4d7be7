"""Static-analysis core of the port's gate: source model, findings,
waivers, baseline.

A copy of the JAX repo's ``harness/analysis/core.py`` (same waiver
grammar, baseline format and matching, same report), over the port's
tree.  The framework is pure-AST and stdlib-only — it never imports the
code under analysis (no torch, no device), so it has no device of its
own and the whole pass takes about a second.  Checkers receive a
:class:`Project` (every parsed source file plus shared symbol-table
helpers) and return :class:`Finding` lists; the runner then applies the
two suppression layers:

* **inline waivers** — ``# analysis: allow-<rule>(<reason>)`` on the
  offending line (or alone on the line above) waives that rule there;
* **baseline** — ``eges_tpu_torch/harness/analysis/baseline.json``
  carries known-and-accepted findings, each with a one-line
  justification.  Matching is by (rule, path, symbol, message), never by
  line number, so unrelated edits don't churn the baseline.

A finding that is neither waived nor baselined is *unsuppressed* and
fails the gate (non-zero exit, ``chip_smoke.py`` phase ``analysis``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import time

# rule ids, grouped by the checkers that own them, in the reference's
# order (harness/analysis/core.py); the rules not listed here wait for
# the code they check (ROADMAP.md, queue A)
RULES = (
    "launch-purity",                                     # jit_purity
    "host-sync",                                         # host_sync
    "transfer-hygiene",                                  # transfer
    "dtype-promotion",                                   # dtypes
    "layer-violation", "import-cycle", "private-reach",  # layers
    "waiver-expired",                                    # core (runner)
)

# checker module -> the rule ids it owns, in run order.  ``--rules``
# slices run ONLY the owning checkers; ``waiver-expired`` is the
# runner's own and always runs.
CHECKERS = (
    ("jit_purity", ("launch-purity",)),
    ("host_sync", ("host-sync",)),
    ("transfer", ("transfer-hygiene",)),
    ("dtypes", ("dtype-promotion",)),
    ("layers", ("layer-violation", "import-cycle", "private-reach")),
)

_WAIVER_RE = re.compile(r"#\s*analysis:\s*(.+)$")
_ALLOW_RE = re.compile(r"allow-([a-z0-9-]+)(?:\(([^)]*)\))?")
_UNTIL_RE = re.compile(r"until=(\d{4}-\d{2}-\d{2})")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-relative, '/'-separated
    line: int
    symbol: str        # stable anchor: Class.attr / function / family
    message: str
    waived: bool = False
    baselined: bool = False
    # other files this finding spans (cycle members …): ``--diff``
    # keeps a finding when ANY of them changed, not just the anchor
    related_paths: tuple = ()

    def fingerprint(self) -> tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def render(self) -> str:
        tag = " [waived]" if self.waived else (
            " [baselined]" if self.baselined else "")
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"

    def as_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "waived": self.waived, "baselined": self.baselined,
                "related_paths": list(self.related_paths)}


class SourceFile:
    """One parsed module: text, AST, and per-line waiver map."""

    def __init__(self, abspath: str, relpath: str):
        self.abspath = abspath
        self.path = relpath.replace(os.sep, "/")
        with open(abspath, "r", encoding="utf-8") as fh:
            self.text = fh.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=relpath)
        # line -> {rule-token: reason}; a waiver comment alone on a line
        # also covers the next line (annotation-above style).  A reason
        # may carry an optional expiry: ``until=YYYY-MM-DD`` — past that
        # date the waiver stops suppressing and becomes a finding.
        self.waivers: dict[int, dict[str, str]] = {}
        self.waiver_until: dict[tuple[int, str], str] = {}
        # one entry per waiver comment (no next-line duplicate), for
        # expiry reporting: (comment line, token, until)
        self.waiver_expiries: list[tuple[int, str, str]] = []
        for i, line in enumerate(self.lines, 1):
            m = _WAIVER_RE.search(line)
            if not m:
                continue
            tokens = {tok: (reason or "")
                      for tok, reason in _ALLOW_RE.findall(m.group(1))}
            if not tokens:
                continue
            standalone = line.lstrip().startswith("#")
            self.waivers.setdefault(i, {}).update(tokens)
            if standalone:  # standalone comment line
                self.waivers.setdefault(i + 1, {}).update(tokens)
            for tok, reason in tokens.items():
                mu = _UNTIL_RE.search(reason)
                if not mu:
                    continue
                self.waiver_until[(i, tok)] = mu.group(1)
                if standalone:
                    self.waiver_until[(i + 1, tok)] = mu.group(1)
                self.waiver_expiries.append((i, tok, mu.group(1)))

    def waived(self, rule: str, line: int,
               today: str | None = None) -> bool:
        for tok in self.waivers.get(line, ()):
            if rule != tok and not rule.endswith("-" + tok):
                continue
            until = self.waiver_until.get((line, tok))
            if today is not None and until is not None and until < today:
                continue  # expired — no longer suppresses
            return True
        return False

    # -- annotation helpers (shared comment conventions) ----------------

    def line_comment(self, line: int) -> str:
        """The comment tail of a 1-based source line ('' if none)."""
        if 1 <= line <= len(self.lines):
            _, hash_, tail = self.lines[line - 1].partition("#")
            return tail if hash_ else ""
        return ""


def _walk_sources(root: str, paths: tuple[str, ...]):
    """Absolute paths of every ``.py`` file a scan covers, in walk
    order — shared by Project and the parse-once cache fingerprint."""
    for top in paths:
        top_abs = os.path.join(root, top)
        if os.path.isfile(top_abs) and top_abs.endswith(".py"):
            yield top_abs
            continue
        for dirpath, dirnames, filenames in os.walk(top_abs):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git",
                                        ".jax_cache")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


class Project:
    """All scanned sources plus cross-file lookups checkers share."""

    def __init__(self, root: str, paths: tuple[str, ...]):
        self.root = root
        self.files: list[SourceFile] = []
        self.errors: list[str] = []
        for abspath in _walk_sources(root, paths):
            self._add(abspath)

    def _add(self, abspath: str) -> None:
        rel = os.path.relpath(abspath, self.root)
        try:
            self.files.append(SourceFile(abspath, rel))
        except (SyntaxError, UnicodeDecodeError) as e:
            self.errors.append(f"{rel}: unparseable: {e}")


# -- parse-once project cache -------------------------------------------
#
# Repeated runs in one process (a rule-sliced run after a full one, the
# tests) share a single parsed Project through this memo instead of
# re-parsing the tree per run.  Keyed on the scan spec, validated against
# a (path, mtime_ns, size) fingerprint so an edited file invalidates
# the entry.

_PROJECT_CACHE: dict[tuple, tuple[tuple, "Project"]] = {}


def _tree_fingerprint(root: str, paths: tuple[str, ...]) -> tuple:
    fp = []
    for abspath in _walk_sources(root, paths):
        try:
            st = os.stat(abspath)
        except OSError:
            continue
        fp.append((abspath, st.st_mtime_ns, st.st_size))
    return tuple(fp)


def load_project(root: str, paths: tuple[str, ...]) -> "Project":
    """A parsed Project for (root, paths) — memoized on file mtimes, so
    repeated runs in one process parse the tree exactly once."""
    key = (os.path.abspath(root), tuple(paths))
    fingerprint = _tree_fingerprint(root, paths)
    hit = _PROJECT_CACHE.get(key)
    if hit is not None and hit[0] == fingerprint:
        return hit[1]
    project = Project(root, paths)
    _PROJECT_CACHE[key] = (fingerprint, project)
    return project


# -- baseline -----------------------------------------------------------

class BaselineError(Exception):
    pass


def load_baseline(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        entries = json.load(fh)
    for e in entries:
        missing = {"rule", "path", "symbol", "message",
                   "justification"} - set(e)
        if missing:
            raise BaselineError(
                f"baseline entry {e.get('symbol', '?')!r} missing "
                f"{sorted(missing)}")
        just = str(e["justification"]).strip()
        if not just or just.startswith("TODO"):
            raise BaselineError(
                f"baseline entry {e['symbol']!r} has an empty or TODO "
                "justification — every suppression must say why")
    return entries


def save_baseline(path: str, findings: list[Finding]) -> None:
    entries = [{"rule": f.rule, "path": f.path, "symbol": f.symbol,
                "message": f.message,
                "justification": "TODO: justify this suppression"}
               for f in findings]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(entries, fh, indent=2, sort_keys=True)
        fh.write("\n")


# -- runner -------------------------------------------------------------

DEFAULT_PATHS = ("eges_tpu_torch", "chip_smoke.py")
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


class Report:
    def __init__(self, findings: list[Finding], files: int,
                 elapsed_s: float, stale_baseline: list[dict],
                 errors: list[str],
                 expiring_waivers: list[dict] | None = None,
                 checker_seconds: dict[str, float] | None = None):
        self.findings = findings
        self.files = files
        self.elapsed_s = elapsed_s
        self.stale_baseline = stale_baseline
        self.errors = errors
        # waivers whose until= date falls within the next 30 days —
        # advance warning before they flip into waiver-expired findings
        self.expiring_waivers = expiring_waivers or []
        # wall time per checker module (plus "parse"): a gate that
        # grows slow names the checker that made it so
        self.checker_seconds = checker_seconds or {}

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.waived and not f.baselined]

    def findings_by_rule(self) -> dict[str, int]:
        out = {r: 0 for r in RULES}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def unsuppressed_by_rule(self) -> dict[str, int]:
        out = {r: 0 for r in RULES}
        for f in self.unsuppressed:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def summary_json(self) -> dict:
        return {
            "files": self.files,
            "elapsed_s": round(self.elapsed_s, 3),
            "findings": len(self.findings),
            "unsuppressed": len(self.unsuppressed),
            "waived": sum(1 for f in self.findings if f.waived),
            "baselined": sum(1 for f in self.findings if f.baselined),
            "stale_baseline": len(self.stale_baseline),
            "findings_by_rule": self.findings_by_rule(),
            "unsuppressed_by_rule": self.unsuppressed_by_rule(),
            "waivers_expiring_30d": self.expiring_waivers,
            "checker_seconds": {k: round(v, 3) for k, v
                                in sorted(self.checker_seconds.items())},
        }


def run(root: str, paths: tuple[str, ...] = DEFAULT_PATHS,
        rules: tuple[str, ...] | None = None,
        baseline_path: str | None = DEFAULT_BASELINE) -> Report:
    import importlib

    t0 = time.monotonic()
    project = load_project(root, paths)
    checker_seconds: dict[str, float] = {
        "parse": time.monotonic() - t0}
    # per-checker finding cache, keyed on the (memoized, immutable)
    # project: consecutive runs in one process run each checker at most
    # once.  Suppression flags are per-run state (a baselined finding in
    # one run must not look baselined to a --no-baseline run), so
    # cached findings are handed out as flag-reset copies.
    cache: dict[str, list[Finding]] = getattr(
        project, "_finding_cache", None) or {}
    project._finding_cache = cache
    findings: list[Finding] = []
    for name, owned in CHECKERS:
        # rule-sliced runs pay only for the owning checkers
        if rules is not None and not set(owned) & set(rules):
            continue
        if name not in cache:
            checker = importlib.import_module(
                "eges_tpu_torch.harness.analysis." + name)
            tc = time.monotonic()
            cache[name] = checker.check(project)
            checker_seconds[name] = time.monotonic() - tc
        else:
            checker_seconds[name] = 0.0  # served from the cache
        findings.extend(
            dataclasses.replace(f, waived=False, baselined=False)
            for f in cache[name])

    # waiver expiry: the clock is overridable so tests stay
    # deterministic; an expired waiver both stops suppressing and is a
    # finding of its own (a dead suppression is drift, not hygiene)
    today = os.environ.get("EGES_ANALYSIS_TODAY") or \
        time.strftime("%Y-%m-%d")
    horizon = _plus_days(today, 30)
    expiring: list[dict] = []
    for src in project.files:
        for line, tok, until in src.waiver_expiries:
            if until < today:
                findings.append(Finding(
                    rule="waiver-expired", path=src.path, line=line,
                    symbol=tok,
                    message=f"waiver allow-{tok} expired on {until} — "
                            "re-justify with a new until= date or fix "
                            "the finding it suppressed"))
            elif until <= horizon:
                expiring.append({"path": src.path, "line": line,
                                 "rule": tok, "until": until})
    expiring.sort(key=lambda e: (e["until"], e["path"], e["line"]))

    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    # layer 1: inline waivers
    by_path = {f.path: f for f in project.files}
    for f in findings:
        src = by_path.get(f.path)
        if src is not None and src.waived(f.rule, f.line, today):
            f.waived = True

    # layer 2: baseline (line-number-free match, each entry usable once
    # per occurrence — N identical findings need N baseline entries)
    stale: list[dict] = []
    if baseline_path:
        entries = load_baseline(baseline_path)
        for e in entries:
            # a baseline row for a deleted file is a config error, not a
            # clean pass: the suppression it carried may now be hiding a
            # reintroduction elsewhere, and silently ignoring it rots
            # the baseline — delete the entry (exit 2 until then)
            if not os.path.exists(os.path.join(root, e["path"])):
                raise BaselineError(
                    f"baseline entry {e['symbol']!r} points at "
                    f"{e['path']!r}, which no longer exists — remove "
                    f"the entry")
        budget: dict[tuple, int] = {}
        for e in entries:
            key = (e["rule"], e["path"], e["symbol"], e["message"])
            budget[key] = budget.get(key, 0) + 1
        for f in findings:
            if f.waived:
                continue
            if budget.get(f.fingerprint(), 0) > 0:
                budget[f.fingerprint()] -= 1
                f.baselined = True
        for e in entries:
            key = (e["rule"], e["path"], e["symbol"], e["message"])
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                stale.append(e)

    return Report(findings, len(project.files), time.monotonic() - t0,
                  stale, list(project.errors), expiring, checker_seconds)


def _plus_days(day: str, days: int) -> str:
    import datetime
    return (datetime.date.fromisoformat(day)
            + datetime.timedelta(days=days)).isoformat()
