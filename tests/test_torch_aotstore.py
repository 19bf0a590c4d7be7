"""The port's artifact store (``eges_tpu_torch/crypto/aotstore.py``) and
``BatchVerifier.aot_prewarm``'s load-versus-build split.

The store cases are those of ``tests/test_aotstore.py`` that do not
reach JAX, on the port's key (torch and CUDA versions, sm capability,
``ops/build.py``'s source hash).  The prewarm cases run a verifier on
the CPU with a stub build (a few bytes standing in for the library
nvcc makes, written by the stub where ``ops/build.py`` puts it, and
counted), so the identical store machinery — the build directory's
hit, save, integrity check, load into a new checkout — runs in
milliseconds; the card's own build and load run in ``chip_smoke.py``
phase ``node``."""

import os

import pytest

from eges_tpu_torch.crypto.aotstore import (LIBRARY, AotStore,
                                            code_fingerprint, default_store,
                                            load_or_build, runtime_versions)
from eges_tpu_torch.crypto.verifier import BatchVerifier
from eges_tpu_torch.ops import build
from eges_tpu_torch.utils.metrics import DEFAULT as metrics

VERSIONS = {"torch": "2.0.0", "cuda": "12.8", "sm": "9.0"}


# -- store-level ----------------------------------------------------------

def test_store_roundtrip(tmp_path):
    st = AotStore(str(tmp_path), versions=VERSIONS)
    payload = b"\x7fELF-library-bytes\xff" * 97
    path = st.save(LIBRARY, "cuda:NVIDIA H100", payload)
    assert os.path.exists(path)
    assert st.load(LIBRARY, "cuda:NVIDIA H100") == payload
    assert st.entries() == [os.path.basename(path)]
    # a different key is a plain miss, not an error
    before = metrics.counter("verifier.aot_load_errors").value
    assert st.load(LIBRARY, "cuda:NVIDIA A100") is None
    assert st.load("other", "cuda:NVIDIA H100") is None
    assert metrics.counter("verifier.aot_load_errors").value == before


@pytest.mark.parametrize("damage", ["flip", "truncate", "magic"])
def test_store_rejects_corruption(tmp_path, damage):
    st = AotStore(str(tmp_path), versions=VERSIONS)
    path = st.save(LIBRARY, "cuda:x", b"payload" * 50)
    blob = bytearray(open(path, "rb").read())
    if damage == "flip":
        blob[-3] ^= 0x40  # a payload byte behind the digest
    elif damage == "truncate":
        blob = blob[:-10]  # a torn write
    else:
        blob[0] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
    before = metrics.counter("verifier.aot_load_errors").value
    assert st.load(LIBRARY, "cuda:x") is None
    assert metrics.counter("verifier.aot_load_errors").value == before + 1


@pytest.mark.parametrize("key,value", [("torch", "2.0.1"), ("cuda", "12.9"),
                                       ("sm", "8.0")])
def test_store_rejects_version_and_code_rev_mismatch(tmp_path, key, value):
    writer = AotStore(str(tmp_path), fingerprint="a" * 16, versions=VERSIONS)
    writer.save(LIBRARY, "cuda:x", b"x" * 64)
    # same versions, different code rev -> rejected
    assert AotStore(str(tmp_path), fingerprint="b" * 16,
                    versions=VERSIONS).load(LIBRARY, "cuda:x") is None
    # same code rev, another torch / CUDA / sm capability -> rejected
    assert AotStore(str(tmp_path), fingerprint="a" * 16,
                    versions=dict(VERSIONS, **{key: value})
                    ).load(LIBRARY, "cuda:x") is None
    # exact match -> loads
    assert AotStore(str(tmp_path), fingerprint="a" * 16,
                    versions=VERSIONS).load(LIBRARY, "cuda:x") is not None


def test_default_store_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("EGES_AOT_DISABLE", "1")
    assert default_store() is None
    monkeypatch.delenv("EGES_AOT_DISABLE")
    monkeypatch.delenv("EGES_AOT_DIR", raising=False)
    st = default_store()
    assert st.root == os.path.join(str(build.BUILD_DIR.parent), "aot")
    monkeypatch.setenv("EGES_AOT_DIR", str(tmp_path / "arts"))
    st = default_store()
    assert st is not None and st.root == str(tmp_path / "arts")
    # the code rev is the build's own source hash: an edited kernel
    # source or flag names another library and invalidates the artifact
    assert st.fingerprint == code_fingerprint() == build.source_hash()
    assert st.versions == runtime_versions()
    assert set(st.versions) == {"torch", "cuda", "sm"}


def test_load_or_build_splits_and_raises(tmp_path):
    """The three sources of the library, on a stub of ``ops/build.py``'s
    ``build()`` (the library at its target; ``built`` when nvcc ran)."""
    st = AotStore(str(tmp_path / "store"), versions=VERSIONS)
    target = tmp_path / "lib" / "libeges.so"
    calls = []

    def stub_build():
        calls.append(1)
        built = not target.exists()
        target.parent.mkdir(exist_ok=True)
        target.write_bytes(b"library-v1")
        return {"path": str(target), "built": built}

    def mode_path():
        mode, _, path = load_or_build(st, "cuda:x", stub_build, str(target))
        return mode, path

    # an empty build directory and store: nvcc, and the store keeps it
    assert mode_path() == ("compile", str(target)) and calls == [1]
    assert st.load(LIBRARY, "cuda:x") == b"library-v1"
    # the build directory holds it: neither a load nor a build
    assert mode_path() == ("build_dir", str(target)) and calls == [1]
    # a new checkout (its build directory empty): the store's copy
    target.unlink()
    assert mode_path() == ("load", str(target)) and calls == [1]
    assert target.read_bytes() == b"library-v1"
    # a build-directory hit fills an empty store
    fresh = AotStore(str(tmp_path / "fresh"), versions=VERSIONS)
    assert load_or_build(fresh, "cuda:x", stub_build,
                         str(target))[0] == "build_dir"
    assert fresh.load(LIBRARY, "cuda:x") == b"library-v1"
    # no store: a new checkout builds
    target.unlink()
    assert load_or_build(None, "cuda:x", stub_build, str(target))[0] == \
        "compile"
    # a build that finds the library another process made meanwhile
    target.unlink()
    assert load_or_build(None, "cuda:x", lambda: {
        "path": str(target), "built": False}, str(target))[0] == "build_dir"

    # a failing build raises and banks nothing
    def broken():
        raise RuntimeError("nvcc failed")

    empty = AotStore(str(tmp_path / "empty"), versions=VERSIONS)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        load_or_build(empty, "cuda:x", broken, str(target))
    assert empty.entries() == []


# -- prewarm: build/save, load, once per verifier, fall-through -----------

class StubVerifier(BatchVerifier):
    """A CPU verifier in the checkout ``root`` whose library is a stub:
    ``_build_library`` writes a few bytes (counting its calls) where
    nvcc's output goes, the library is "opened" by reading them back,
    and a bucket's warm is only recorded."""

    def __init__(self, root, **kw):
        super().__init__(device="cpu", **kw)
        self.root = root
        self.builds = 0
        self.opened = []
        self.warmed = []

    def _library_needed(self):
        return True

    def _build_library(self):
        self.builds += 1
        target = self._library_target()
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "wb") as fh:
            fh.write(b"stub-library:" + build.source_hash().encode())
        return {"path": target, "built": True}

    def _library_target(self):
        return os.path.join(self.root, "lib", "libeges.so")

    def _open_library(self):
        with open(self._library_target(), "rb") as fh:
            self.opened.append(fh.read())

    def _warm_bucket(self, b):
        self.warmed.append(b)
        return True


def test_aot_prewarm_builds_then_loads(tmp_path):
    store = AotStore(str(tmp_path / "store"))
    v1 = StubVerifier(str(tmp_path / "a"))
    info1 = v1.aot_prewarm(buckets=(16,), store=store)
    assert info1["aot_compiles"] == 1 and info1["aot_loads"] == 0
    assert info1["library"] == "compile"
    assert info1["device_kind"] == "cpu:cpu" and info1["buckets"] == [16]
    assert store.entries(), "the build must bank the artifact"
    assert v1.builds == 1 and v1.warmed == [16]

    # a process in a new checkout: loads from the store, no build
    v2 = StubVerifier(str(tmp_path / "b"))
    info2 = v2.aot_prewarm(buckets=(16, 15, 33), store=store)
    assert info2["aot_loads"] == 1 and info2["aot_compiles"] == 0
    assert info2["library"] == "load" and info2["buckets"] == [16, 64]
    assert v2.builds == 0 and v2.opened == v1.opened
    assert v2.aot_stats()["aot_loads"] == 1
    assert v2.aot_stats()["aot_compiles"] == 0
    assert v2.warmed == [16, 64]
    # the library is this verifier's once: a second prewarm warms only
    again = v2.aot_prewarm(buckets=(16,), store=store)
    assert again["aot_loads"] == 0 and again["aot_compiles"] == 0
    assert again["library"] is None and v2.aot_stats()["aot_loads"] == 1

    # a process restarted in the first checkout: its build directory's
    # library, neither a load nor a build
    v3 = StubVerifier(str(tmp_path / "a"))
    info3 = v3.aot_prewarm(buckets=(16,), store=store)
    assert info3["library"] == "build_dir" and v3.builds == 0
    assert info3["aot_loads"] == info3["aot_compiles"] == 0
    assert v3.opened == v1.opened


def test_prewarm_warms_without_the_store(tmp_path):
    """``prewarm`` runs the padded buckets (in the background by
    default) and leaves the library to ``ops/build.py``: no store, no
    build, no load."""
    v = StubVerifier(str(tmp_path))
    v.prewarm(buckets=(10, 16, 40)).join()
    assert v.warmed == [16, 64]
    assert v.prewarm(buckets=(1,), background=False) is None
    assert v.warmed == [16, 64, 16]
    assert v.builds == 0 and v.opened == []
    assert v.aot_stats()["aot_loads"] == v.aot_stats()["aot_compiles"] == 0


def test_corrupted_artifact_falls_through_to_build(tmp_path):
    store = AotStore(str(tmp_path / "store"))
    StubVerifier(str(tmp_path / "a")).aot_prewarm(buckets=(16,),
                                                  store=store)
    path = store.path_for(LIBRARY, "cpu:cpu")
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
    v2 = StubVerifier(str(tmp_path / "b"))
    info = v2.aot_prewarm(buckets=(16,), store=store)
    # degrade (build), never crash
    assert info["aot_loads"] == 0 and info["aot_compiles"] == 1
    assert v2.builds == 1
    # the build re-banked a GOOD artifact
    v3 = StubVerifier(str(tmp_path / "c"))
    assert v3.aot_prewarm(buckets=(16,), store=store)["aot_loads"] == 1


def test_a_failing_build_fails_the_prewarm(tmp_path):
    class Broken(StubVerifier):
        def _build_library(self):
            raise RuntimeError("nvcc failed")

    v = Broken(str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        v.aot_prewarm(buckets=(16,), store=AotStore(str(tmp_path / "s")))
    assert v.warmed == [] and v.aot_stats()["aot_compiles"] == 0


def test_cluster_restart_prewarms_from_store(tmp_path, monkeypatch):
    """The sim's restart path warms the port's facade through the store,
    as the reference's does: a banked library loads, nothing builds,
    and the rejoin lands in the journal."""
    monkeypatch.setenv("EGES_AOT_DIR", str(tmp_path / "arts"))
    StubVerifier(str(tmp_path / "a")).aot_prewarm(buckets=(16,))

    from eges_tpu_torch.sim.cluster import SimCluster

    v = StubVerifier(str(tmp_path / "b"))
    c = SimCluster(3, signed=False, verifier=v)
    c.start()
    c.run(2.0)
    c.crash(0)
    c.restart(0)
    st = c.verifier._verifier.aot_stats()
    assert st["aot_loads"] == 1 and st["aot_compiles"] == 0
    assert v.builds == 0
    evs = [e for e in c.nodes[0].node.journal.events()
           if e.get("type") == "verifier_aot_load"]
    assert evs and evs[-1]["aot_loads"] == 1 and evs[-1]["restart"]
    for sn in c.live_nodes():
        sn.node.stop()
    c.verifier.close()


def test_cpu_prewarm_runs_the_bucket_once():
    """On the CPU the warm is one plain recovery of 16 zero rows (no
    library to load or build); the bucket then counts as run, so its
    next batch records a compile-cache hit and a second warm is a
    no-op."""
    v = BatchVerifier(device="cpu")
    info = v.aot_prewarm(buckets=(10,), store=None)
    assert info["aot_loads"] == info["aot_compiles"] == 0
    assert info["buckets"] == [16] and 16 in v._compiled_buckets
    assert info["library"] is None
    assert v._warm_bucket(16) is False
