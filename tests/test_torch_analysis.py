"""The port's static-analysis gate (``eges_tpu_torch/harness/analysis``)
and kernel #21.

* Each ported rule fires on its seeded fixture under
  ``tests/torch_analysis_fixtures/``, stays quiet on the clean twins, and
  honours an inline waiver; the exemptions of launch-purity are each
  shown load-bearing on a copy of its tree.
* The port's copied core, waiver grammar, baseline, manifest and layer
  rules are held to the JAX repo's ``harness.analysis`` on the
  reference's own fixture trees: the same findings, field for field.
* The CLI's exit codes, and the gate over the port's tree (no
  unsuppressed finding, no stale baseline, the launch census its only
  waiver).
* ``mul_scalar_f32`` (the plain version on the CPU) against the
  reference fixture's ``_impure_kernel`` run through
  ``pl.pallas_call(..., interpret=True)`` with the fixture's clock
  replaced by a fixed value: bit for bit.

All of it but the last reads source files only (a few seconds on one
core)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eges_tpu_torch.harness.analysis import core, run
from eges_tpu_torch.harness.analysis.core import BaselineError, save_baseline
from eges_tpu_torch.ops import kernels as K
from harness.analysis import core as ref_core
from harness.analysis import run as ref_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_analysis_fixtures")
REF_FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
LAYER_RULES = ("layer-violation", "import-cycle", "private-reach")


def _run_fixture(tree, root=FIXTURES, **kw):
    kw.setdefault("baseline_path", None)
    return run(os.path.join(root, tree), **kw)


def _render(rep):
    return [f.render() for f in rep.findings]


# -- launch-purity --------------------------------------------------------

def test_launch_purity_flags_seeded_clock_print_and_sync():
    rep = _run_fixture("jit", paths=("eges_tpu_torch",),
                       rules=("launch-purity",))
    got = {(os.path.basename(f.path), f.line, f.symbol)
           for f in rep.unsuppressed}
    assert got == {("impure_kernel.py", 11, "run"),
                   ("impure_kernel.py", 16, "noisy_sum"),
                   ("impure_kernel.py", 17, "noisy_sum")}, _render(rep)
    msgs = "\n".join(f.message for f in rep.unsuppressed)
    assert "`time.time()` host clock read" in msgs
    assert "`print`" in msgs and "`.item()` host sync" in msgs
    # every finding names the region function it was reached from
    assert all("inside the launch region (reached from " in f.message
               for f in rep.findings)
    # the stub's launch census is a finding, waived inline
    waived = [(f.path, f.symbol) for f in rep.findings if f.waived]
    assert waived == [("eges_tpu_torch/ops/kernels.py", "_launch")]


def test_launch_purity_exempts_casts_caches_plain_and_resolve():
    rep = _run_fixture("jit", paths=("eges_tpu_torch",),
                       rules=("launch-purity",))
    assert not [f for f in rep.findings
                if f.path.endswith("clean_kernel.py")
                or f.symbol == "mul_scalar_f32_plain"], _render(rep)


@pytest.mark.parametrize("old,new,want", [
    # each exemption is load-bearing: lift it and its body fires
    ("@functools.lru_cache(maxsize=1)\n", "", "_table"),
    ("def verify(self, x):", "def check(self, x):", "CleanVerifier.check"),
    ("int(x.shape[0])", "int(x.sum())", "kernel"),
])
def test_launch_purity_exemptions_are_load_bearing(tmp_path, old, new,
                                                   want):
    root = str(tmp_path / "jit")
    shutil.copytree(os.path.join(FIXTURES, "jit"), root)
    path = os.path.join(root, "eges_tpu_torch", "ops", "clean_kernel.py")
    src = open(path).read()
    assert old in src
    with open(path, "w") as fh:
        fh.write(src.replace(old, new))
    rep = run(root, paths=("eges_tpu_torch",), rules=("launch-purity",),
              baseline_path=None)
    assert want in {f.symbol for f in rep.unsuppressed
                    if f.path.endswith("clean_kernel.py")}, _render(rep)


def test_launch_purity_plain_exemption_and_seed(tmp_path):
    """The stub's plain version holds a ``.tolist()``: under another name
    it fires.  Without ``ops/kernels.py:_launch`` there is no launch
    region and nothing fires."""
    root = str(tmp_path / "jit")
    shutil.copytree(os.path.join(FIXTURES, "jit"), root)
    path = os.path.join(root, "eges_tpu_torch", "ops", "kernels.py")
    src = open(path).read()
    with open(path, "w") as fh:
        fh.write(src.replace("mul_scalar_f32_plain", "mul_scalar_f32_host"))
    rep = run(root, paths=("eges_tpu_torch",), rules=("launch-purity",),
              baseline_path=None)
    assert "mul_scalar_f32_host" in {f.symbol for f in rep.unsuppressed}
    with open(path, "w") as fh:
        fh.write(src.replace("_launch(", "_enqueue("))
    rep = run(root, paths=("eges_tpu_torch",), rules=("launch-purity",),
              baseline_path=None)
    assert rep.findings == []


_FACADE_TOML = """roots = ["eges_tpu_torch"]

[[layer]]
name = "L0-kernels"
packages = ["eges_tpu_torch", "eges_tpu_torch.ops"]

[[layer]]
name = "L2-facade"
packages = ["eges_tpu_torch.ops.front"]
"""


def test_launch_purity_region_ends_at_the_facade_entry(tmp_path):
    """A caller of a ``commit_*`` of a class in the manifest's facade
    layer (the scheduler's lane worker reads clocks and casts to order
    windows) is not in the launch region; the ``commit_*`` itself,
    which enqueues the kernels, is checked; a ``commit_*`` outside the
    facade layer, or with no manifest, passes the region on to its
    callers; and the caller fires once it calls the kernel directly."""
    root = str(tmp_path / "jit")
    shutil.copytree(os.path.join(FIXTURES, "jit"), root)
    ops = os.path.join(root, "eges_tpu_torch", "ops")
    front = os.path.join(ops, "front.py")
    with open(front, "w") as fh:
        fh.write("from eges_tpu_torch.ops.clean_kernel import kernel\n\n\n"
                 "class Lane:\n"
                 "    def commit_recover(self, x):\n"
                 "        return kernel(x)\n")
    toml = os.path.join(root, "ARCHITECTURE.toml")
    with open(toml, "w") as fh:
        fh.write(_FACADE_TOML)
    path = os.path.join(ops, "clean_kernel.py")
    src = open(path).read() + (
        "\n\nclass Pool:\n"
        "    def commit_window(self, x):\n"
        "        return kernel(x)\n\n\n"
        "def lane_loop(lane, x):\n"
        "    import time\n"
        "    t0 = time.monotonic()\n"
        "    lane.commit_recover(x)\n"
        "    return bool(x), t0\n")

    def flagged(text):
        with open(path, "w") as fh:
            fh.write(text)
        rep = run(root, paths=("eges_tpu_torch",),
                  rules=("launch-purity",), baseline_path=None)
        return {f.symbol for f in rep.unsuppressed
                if f.path.endswith(("clean_kernel.py", "front.py"))}

    assert flagged(src) == set()
    with open(front, "a") as fh:
        fh.write("\n    def commit_noisy(self, x):\n"
                 "        print(x)\n"
                 "        return kernel(x)\n")
    assert flagged(src) == {"Lane.commit_noisy"}
    # the same name outside the facade layer is no facade entry
    assert flagged(src.replace("lane.commit_recover(x)",
                               "lane.commit_window(x)")) == {
        "Lane.commit_noisy", "lane_loop"}
    assert flagged(src.replace("    lane.commit_recover(x)\n",
                               "    kernel(x)\n")) == {
        "Lane.commit_noisy", "lane_loop"}
    # no manifest, no facade layer: the region runs on to the caller
    os.remove(toml)
    assert flagged(src) == {"Lane.commit_noisy", "lane_loop"}


# -- host-sync ------------------------------------------------------------

def test_host_sync_flags_lock_and_midpipeline_blocking():
    rep = _run_fixture("hotsync", paths=("pkg",), rules=("host-sync",))
    msgs = {f.line: f.message for f in rep.unsuppressed}
    assert len(msgs) == 3, _render(rep)
    # a device wait under a lock fires even at a resolve boundary...
    assert "holding _staging_lock" in msgs[23]
    assert "D2H" in msgs[24]
    # ...and a bare mid-pipeline sync in a stage phase fires too
    assert "mid-pipeline" in msgs[30]
    # every report names the entry point the sink was reached from
    assert all("via WindowVerifier" in m for m in msgs.values())
    assert {f.line for f in rep.findings if f.waived} == {38}


def test_host_sync_exempts_gated_boundary_and_collect():
    rep = _run_fixture("hotsync", paths=("pkg",), rules=("host-sync",))
    assert not any("CleanVerifier" in f.symbol for f in rep.findings), (
        _render(rep))


# -- transfer-hygiene -----------------------------------------------------

def test_transfer_flags_loop_upload_host_commit_and_stage_reuse():
    rep = _run_fixture("transfer", paths=("pkg",),
                       rules=("transfer-hygiene",))
    msgs = "\n".join(f.message for f in rep.unsuppressed)
    assert len(rep.unsuppressed) == 3, _render(rep)
    assert ".to(<device>) inside a loop" in msgs
    assert "on a class that carries self.device" in msgs
    assert "single-buffer _staging_buf" in msgs
    assert {f.line for f in rep.findings if f.waived} == {35}


def test_transfer_exempts_pinned_double_buffer_and_gated_fallback():
    rep = _run_fixture("transfer", paths=("pkg",),
                       rules=("transfer-hygiene",))
    assert not any("CleanDeviceLane" in f.symbol for f in rep.findings), (
        _render(rep))


# -- dtype-promotion ------------------------------------------------------

def test_dtype_flags_literals_ctors_and_64bit_floats():
    rep = _run_fixture("dtypes", paths=("eges_tpu_torch",),
                       rules=("dtype-promotion",))
    by_line = {f.line: f.message for f in rep.unsuppressed}
    assert len(by_line) == 4, _render(rep)
    assert "of a python literal without dtype" in by_line[6]
    assert "without an explicit dtype" in by_line[7]
    assert "dtype=float requests torch.float64" in by_line[8]
    assert "torch.float64 in device code" in by_line[12]


def test_dtype_exempts_typed_twins_int64_carrier_and_host_numpy():
    rep = _run_fixture("dtypes", paths=("eges_tpu_torch",),
                       rules=("dtype-promotion",))
    assert {f.line for f in rep.findings} == {6, 7, 8, 12, 21}, _render(rep)
    assert {f.line for f in rep.findings if f.waived} == {21}


# -- the same findings as the JAX repo's gate -------------------------------

def _fields(rep):
    return sorted((f.rule, f.path, f.line, f.symbol, f.message, f.waived,
                   f.baselined, tuple(f.related_paths)) for f in rep.findings)


@pytest.mark.parametrize("tree", ["layers", "cycle", "private"])
def test_layer_rules_match_the_reference(tree):
    """The reference's seeded layer, cycle and private-reach trees: every
    finding of the three ported rules, waived ones included, and the
    errors, field for field."""
    root = os.path.join(REF_FIXTURES, tree)
    mine = run(root, paths=("pkg",), rules=LAYER_RULES, baseline_path=None)
    ref = ref_run(root, paths=("pkg",), rules=LAYER_RULES,
                  baseline_path=None)
    assert mine.unsuppressed and _fields(mine) == _fields(ref)
    assert mine.errors == ref.errors == []


def test_manifest_errors_match_the_reference(tmp_path):
    # a module under a declared root that matches no layer package
    root = tmp_path / "tree"
    (root / "pkg").mkdir(parents=True)
    (root / "ARCHITECTURE.toml").write_text(
        'roots = ["pkg"]\n\n[[layer]]\nname = "only"\n'
        'packages = ["pkg"]\n')
    (root / "pkg" / "__init__.py").write_text("")
    (root / "pkg" / "stray.py").write_text("X = 1\n")
    # an unparseable manifest
    bad = tmp_path / "tree2"
    (bad / "pkg").mkdir(parents=True)
    (bad / "pkg" / "__init__.py").write_text("")
    (bad / "ARCHITECTURE.toml").write_text("layers = {bogus}\n")
    for tree, want in ((root, "matches no layer package"),
                       (bad, "architecture manifest")):
        mine = run(str(tree), paths=("pkg",), rules=LAYER_RULES,
                   baseline_path=None)
        ref = ref_run(str(tree), paths=("pkg",), rules=LAYER_RULES,
                      baseline_path=None)
        assert any(want in e for e in mine.errors), mine.errors
        assert mine.errors == ref.errors


@pytest.mark.parametrize("tree", ["waivers", "expiry"])
def test_waiver_grammar_matches_the_reference(tree):
    """Every waiver comment of the reference's waiver and expiry trees
    parses to the same tables, and suppresses the same (rule, line)
    pairs on each side of every date it names."""
    top = os.path.join(REF_FIXTURES, tree)
    for dirpath, _, names in os.walk(top):
        for name in sorted(n for n in names if n.endswith(".py")):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, top)
            mine, ref = core.SourceFile(path, rel), ref_core.SourceFile(path,
                                                                        rel)
            assert mine.waivers and mine.waivers == ref.waivers
            assert mine.waiver_until == ref.waiver_until
            assert mine.waiver_expiries == ref.waiver_expiries
            rules = {t for ws in ref.waivers.values() for t in ws} | {
                "swallow", "unbounded-queue", "launch-purity"}
            for today in ("2000-01-01", "2098-12-20", "2099-01-11", None):
                for line in range(1, len(ref.lines) + 2):
                    for rule in rules:
                        assert mine.waived(rule, line, today) == \
                            ref.waived(rule, line, today), (rel, line, rule)


@pytest.mark.parametrize("today", ["2000-01-01", "2098-12-20"])
def test_waiver_expiry_matches_the_reference(monkeypatch, today):
    monkeypatch.setenv("EGES_ANALYSIS_TODAY", today)
    root = os.path.join(REF_FIXTURES, "expiry")
    mine = run(root, paths=("pkg",), rules=("waiver-expired",),
               baseline_path=None)
    ref = ref_run(root, paths=("pkg",), rules=("waiver-expired",),
                  baseline_path=None)
    assert _fields(mine) == _fields(ref)
    assert mine.expiring_waivers == ref.expiring_waivers
    if today == "2098-12-20":
        assert [(f.rule, f.line) for f in mine.unsuppressed] == [
            ("waiver-expired", 13)]
        assert [w["line"] for w in mine.expiring_waivers] == [27]


# -- baseline and the report ------------------------------------------------

def test_baseline_budget_staleness_and_justification(tmp_path):
    root = os.path.join(FIXTURES, "dtypes")
    kw = {"paths": ("eges_tpu_torch",), "rules": ("dtype-promotion",)}
    rep = run(root, baseline_path=None, **kw)
    assert len(rep.unsuppressed) == 4

    # a generated baseline absorbs the findings but demands justification
    bl = str(tmp_path / "baseline.json")
    save_baseline(bl, rep.unsuppressed)
    with pytest.raises(BaselineError, match="justification"):
        run(root, baseline_path=bl, **kw)

    entries = json.load(open(bl))
    for e in entries:
        e["justification"] = "fixture: intentional"
    extra = dict(entries[0], justification="stale on purpose")
    json.dump(entries + [extra], open(bl, "w"))
    rep2 = run(root, baseline_path=bl, **kw)
    assert rep2.unsuppressed == []
    assert sum(1 for f in rep2.findings if f.baselined) == 4
    # one finding cannot consume two entries: the duplicate is stale
    assert [e["symbol"] for e in rep2.stale_baseline] == [extra["symbol"]]

    # an entry whose file no longer exists is a config error
    gone = dict(entries[0], path="eges_tpu_torch/ops/gone.py",
                justification="points at a deleted file")
    json.dump(entries + [gone], open(bl, "w"))
    with pytest.raises(BaselineError, match="no longer exists"):
        run(root, baseline_path=bl, **kw)


def test_report_checker_seconds_and_project_memoization():
    root = os.path.join(FIXTURES, "hotsync")
    rep = run(root, paths=("pkg",), baseline_path=None)
    assert set(rep.checker_seconds) == {"parse", "jit_purity", "host_sync",
                                        "transfer", "dtypes", "layers"}
    assert set(rep.summary_json()["findings_by_rule"]) == set(core.RULES)
    assert core.load_project(root, ("pkg",)) is core.load_project(
        root, ("pkg",))


# -- the CLI ----------------------------------------------------------------

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "eges_tpu_torch.harness.analysis", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_cli_exit_codes(tmp_path):
    proc = _cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout)
    assert out["summary"]["unsuppressed"] == 0
    # the launch census (kernels.py) and the node service's profiler
    # header from the harness, the reference's own waiver
    assert out["summary"]["waived"] == 2
    assert out["summary"]["findings_by_rule"]["launch-purity"] == 1
    assert out["summary"]["findings_by_rule"]["layer-violation"] == 1
    for root, paths in ((os.path.join(FIXTURES, "jit"), "eges_tpu_torch"),
                        (os.path.join(FIXTURES, "hotsync"), "pkg"),
                        (os.path.join(FIXTURES, "transfer"), "pkg"),
                        (os.path.join(FIXTURES, "dtypes"), "eges_tpu_torch"),
                        (os.path.join(REF_FIXTURES, "layers"), "pkg"),
                        (os.path.join(REF_FIXTURES, "cycle"), "pkg"),
                        (os.path.join(REF_FIXTURES, "private"), "pkg")):
        proc = _cli("--root", root, "--no-baseline", paths)
        assert proc.returncode == 1, (root, proc.stdout + proc.stderr)
    # a rule slice runs only its checker
    proc = _cli("--root", os.path.join(FIXTURES, "dtypes"), "--no-baseline",
                "--rules", "host-sync", "eges_tpu_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    bad = tmp_path / "tree"
    (bad / "pkg").mkdir(parents=True)
    (bad / "pkg" / "__init__.py").write_text("")
    (bad / "ARCHITECTURE.toml").write_text("layers = {bogus}\n")
    proc = _cli("--root", str(bad), "--no-baseline", "pkg")
    assert proc.returncode == 2, proc.stdout + proc.stderr


# -- the gate over the port's tree ----------------------------------------

def test_port_tree_has_zero_unsuppressed_findings():
    rep = run(REPO)
    assert rep.errors == [], rep.errors
    assert rep.unsuppressed == [], "\n".join(
        f.render() for f in rep.unsuppressed)
    assert rep.stale_baseline == []
    assert json.load(open(core.DEFAULT_BASELINE)) == []
    # the launch census and the node service's profiler header (the
    # reference's own waiver, eges_tpu/node/service.py) are the two
    # suppressions
    assert sorted((f.rule, f.path, f.symbol) for f in rep.findings) == [
        ("launch-purity", "eges_tpu_torch/ops/kernels.py", "_launch"),
        ("layer-violation", "eges_tpu_torch/node/service.py",
         "eges_tpu_torch.node.service -> eges_tpu_torch.harness.profutil")]
    assert all(f.waived for f in rep.findings)
    assert rep.elapsed_s < 10.0


# -- kernel #21 against the JAX package --------------------------------------

def test_mul_scalar_matches_the_impure_fixture_kernel(monkeypatch):
    """The reference fixture's ``_impure_kernel`` (``o = x * time.time()``)
    with its clock fixed, against ``mul_scalar_f32`` on the CPU (its plain
    version): the scalar is rounded to float32 once, as JAX does to a
    Python float beside a float32 array, so the products agree bit for
    bit (tolerance 0)."""
    spec = importlib.util.spec_from_file_location(
        "impure_kernel",
        os.path.join(REF_FIXTURES, "jit", "eges_tpu", "ops",
                     "impure_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t = 1760700000.123456
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: t))
    x = np.random.default_rng(21).standard_normal((8, 128), dtype=np.float32)
    x[0, :5] = (0.0, -0.0, 3e38, -1e-30, 2.0**24)
    want = pl.pallas_call(
        mod._impure_kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))(
            jnp.asarray(x))
    got = K.mul_scalar_f32(torch.from_numpy(x), t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert np.isinf(got.numpy()[0, 2])
    assert got.numpy()[0, 1:2].view(np.uint32)[0] == 1 << 31
    with pytest.raises(TypeError):
        K.mul_scalar_f32(torch.from_numpy(x).double(), t)
