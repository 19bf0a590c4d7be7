"""eges_tpu_torch stands alone: importing any of its modules pulls in
neither ``jax``, nor any module of the JAX package ``eges_tpu``, nor the
JAX repo's top-level ``harness``; no source of the port (its own
``harness`` subpackage included) or of chip_smoke.py imports them; and
the entry points, the harness's among them, default to the card and
raise where there is none."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "eges_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_the_port_loads_no_jax_and_no_eges_tpu():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    mods = json.loads(out.splitlines()[-1])
    assert "eges_tpu_torch.crypto.verifier" in mods
    assert "eges_tpu_torch.harness.profile_floor" in mods
    for root in ("jax", "eges_tpu", "harness"):
        assert not [m for m in mods if m == root or m.startswith(root + ".")]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_source_imports_no_jax_and_no_eges_tpu(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "eges_tpu", "harness"), (
                path, name)


def test_the_walk_covers_the_harness_subpackage():
    harness = {m for m in _modules()
               if m.startswith("eges_tpu_torch.harness")}
    assert harness == {
        "eges_tpu_torch.harness", *(f"eges_tpu_torch.harness.{n}" for n in (
            "profutil", "profile_mulchain", "profile_mul8b", "profile_floor",
            "profile_kernels2", "profile_stages", "measure_recover",
            "hlo_census", "cluster", "txn_client")),
        "eges_tpu_torch.harness.analysis", *(
            f"eges_tpu_torch.harness.analysis.{n}" for n in (
                "__main__", "core", "layermap", "layers", "hotpath",
                "jit_purity", "host_sync", "transfer", "dtypes"))}


def test_entry_points_default_to_the_card(tmp_path):
    """Every entry point that runs on a device takes the card unless asked
    for the CPU: the kernels' callers, the harness's mains, the node
    (``python -m eges_tpu_torch.node``: its default verifier mode) and
    the cluster harness's torch nodes and kernel-store warm.  The
    static-analysis gate (``eges_tpu_torch.harness.analysis``) and the
    bootnode stand outside this rule: they have no device, and run
    without loading torch at all (``test_the_analysis_gate_has_no_device``,
    ``test_the_bootnode_has_no_device``)."""
    from eges_tpu_torch import resolve_device
    from eges_tpu_torch.crypto.verifier import BatchVerifier, default_verifier
    from eges_tpu_torch.harness import (hlo_census, measure_recover,
                                        profile_floor, profile_kernels2,
                                        profile_mul8b, profile_mulchain,
                                        profile_stages, profutil)

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert BatchVerifier().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchVerifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        default_verifier()
    # the node: the default verifier mode is the torch verifier on the card
    from eges_tpu_torch.harness import cluster
    from eges_tpu_torch.node import __main__ as node_main

    gen = tmp_path / "genesis.json"
    cluster.write_genesis(str(gen), 3)
    argv = ["--datadir", str(tmp_path / "d"), "--genesis", str(gen),
            "--keyhex", cluster.node_key(0).hex()]
    for extra in ([], ["--verifier", "torch"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            node_main.main(argv + extra)
    # the cluster harness: a torch node asks for no other device, and the
    # store warm (a child process) fails without a card
    cmd = cluster._node_cmd(0, 3, str(tmp_path), str(gen),
                            cluster.parse_hosts("", 3), txn_per_block=10,
                            txn_size=100, block_timeout=5.0, mine=True,
                            extra_args=["--verifier", "torch"])
    assert "--verifierDevice" not in cmd
    assert cmd[cmd.index("-m") + 1] == "eges_tpu_torch.node"
    with pytest.raises(subprocess.CalledProcessError) as err:
        cluster.warm_kernel_store(timeout_s=120)
    assert "CUDA" in err.value.stderr
    for main in (profile_mulchain.main, profile_mul8b.main,
                 profile_floor.main, profile_kernels2.main,
                 profile_stages.main, measure_recover.main, hlo_census.main,
                 lambda: profile_floor.child("nop"),
                 lambda: profutil.timeit(lambda: None),
                 lambda: profutil.cold_event_ms([(lambda: None, ())])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()


def test_the_analysis_gate_has_no_device():
    """The analyser reads source files and never imports them: run as a
    program on the tree, it loads no torch (the package root imports it
    only when a device is resolved), no jax and no ``harness``."""
    code = ("import json, sys\n"
            "from eges_tpu_torch.harness.analysis import run\n"
            "rep = run(sys.argv[1])\n"
            "print(json.dumps([len(rep.unsuppressed),\n"
            "                  sorted(sys.modules)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    unsuppressed, mods = json.loads(out.splitlines()[-1])
    assert unsuppressed == 0
    for root in ("torch", "numpy", "jax", "eges_tpu", "harness"):
        assert not [m for m in mods if m == root or m.startswith(root + ".")]


def test_the_bootnode_has_no_device():
    """The discovery bootnode (``python -m eges_tpu_torch.bootnode``)
    serves UDP and has no device: its module loads no torch, no jax and
    nothing of the reference."""
    code = ("import json, sys\n"
            "import eges_tpu_torch.bootnode.__main__ as m\n"
            "assert callable(m.main)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    mods = json.loads(out.splitlines()[-1])
    assert "eges_tpu_torch.net.discovery" in mods
    for root in ("torch", "jax", "eges_tpu", "harness"):
        assert not [m for m in mods if m == root or m.startswith(root + ".")]
