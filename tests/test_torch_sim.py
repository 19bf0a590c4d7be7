"""The port's simulated Geec cluster (``eges_tpu_torch/sim/cluster.py``
and the consensus, core, ingress and sim copies it runs) held against
the reference's (``eges_tpu/sim/cluster.py``).

The repo's determinism rule is that same-seed sims give byte-identical
journal dumps (``harness/chaos.py`` ``canonical_dump``: sorted nodes,
sorted keys, wall-clock fields stripped).  Every host-verifier scenario
here runs once through each package and compares those dumps byte for
byte, with the heights and the block hash at every height: one check
that holds every copied module against its reference at once.  The
PoW engine mines the reference's block hashes, and the port's device
verifier (``BatchVerifier(device="cpu")``, the plain kernels) in the
loop of a small sim gives the chain its native twin gives.  Tolerance
is 0 everywhere.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import types

import pytest

from harness.chaos import canonical_dump

def _pkg(root: str) -> types.SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("cluster", "sim.cluster"), ("vh", "crypto.verify_host"),
        ("secp", "crypto.secp256k1"), ("types", "core.types"),
        ("messages", "consensus.messages"), ("chain", "core.chain"),
        ("engine", "consensus.engine"))}
    return types.SimpleNamespace(root=root, **mods)


def _stop(c) -> None:
    for sn in c.live_nodes():
        sn.node.stop()
    if c.verifier is not None:
        c.verifier.close()


def _hashes(c) -> list[list]:
    return [[sn.chain.store.get_hash_by_number(h)
             for h in range(sn.chain.height() + 1)] for sn in c.nodes]


def _outcome(c) -> tuple:
    return canonical_dump(c.journals()), c.heights(), _hashes(c)


# -- host verifiers: verifier=None and each package's native verifier --

def _signed_sim(root: str, verifier_of) -> tuple:
    """Behind a scheduler, windows flush on kicks only (the chaos
    harness's setting): the default 2 ms wall-clock deadline makes the
    flush events differ between two same-seed runs of either package."""
    p = _pkg(root)
    verifier = verifier_of()
    kw = {} if verifier is None else {
        "sched_config": importlib.import_module(
            f"{root}.crypto.scheduler").SchedulerConfig(window_ms=10_000.0)}
    c = p.cluster.SimCluster(4, seed=3, txn_per_block=2, signed=True,
                             verifier=verifier, **kw)
    c.start()
    c.run(120, stop_condition=lambda: c.min_height() >= 5)
    _stop(c)
    return _outcome(c)


@functools.lru_cache(maxsize=None)
def _reference_signed(kind: str) -> tuple:
    ref = _pkg("eges_tpu")
    return _signed_sim("eges_tpu", {
        "none": lambda: None, "native": ref.vh.NativeBatchVerifier}[kind])


@pytest.mark.parametrize("verifier", ["none", "native-ref", "native-port"])
def test_signed_sim_equals_the_reference(verifier):
    """A same-seed 4-node signed sim to height 5 through the port gives
    the reference's canonical dump, heights and block hashes, with host
    crypto (``verifier=None``) and behind the port's scheduler over
    either package's ``NativeBatchVerifier``."""
    owner = {"none": None, "native-ref": "eges_tpu",
             "native-port": "eges_tpu_torch"}[verifier]
    make = (lambda: None) if owner is None else \
        _pkg(owner).vh.NativeBatchVerifier
    dump, heights, hashes = _signed_sim("eges_tpu_torch", make)
    want = _reference_signed("none" if owner is None else "native")
    assert min(heights) >= 5
    assert heights == want[1]
    assert hashes == want[2]
    assert dump == want[0]


# -- columnar ingress: tests/test_columnar_ingest.py's gossip flood --------

PRIV_A = bytes(range(1, 33))
PRIV_B = bytes(range(2, 34))


def _mixed_stream(p, n: int) -> list:
    """tests/test_columnar_ingest.py's stream in package ``p``'s types:
    signed (legacy and EIP-155), unsigned and invalid-signature rows,
    with nonce collisions driving price-bump replacements."""
    out = []
    for i in range(n):
        t = p.types.Transaction(nonce=i % 9, gas_price=1 + i,
                                gas_limit=21000,
                                to=bytes(20) if i % 7 else None, value=i,
                                payload=b"x" * (i % 11))
        if i % 6 == 5:
            out.append(dataclasses.replace(t, v=27, r=0, s=1))  # invalid
        elif i % 6 == 4:
            out.append(t.signed(PRIV_B, chain_id=77))
        elif i % 6 == 3:
            out.append(t)  # unsigned: rejected
        else:
            out.append(t.signed(PRIV_A))
    return out


@functools.lru_cache(maxsize=None)
def _gossip_flood(root: str, use_columnar: bool) -> tuple:
    """4-node txpool sim with a flooder peer bursting the mixed stream
    (and a duplicate tail) as gossip windows of 12."""
    p = _pkg(root)
    alloc = {p.secp.pubkey_to_address(p.secp.privkey_to_pubkey(k)): 10 ** 18
             for k in (PRIV_A, PRIV_B)}
    c = p.cluster.SimCluster(4, seed=0, txn_per_block=4, txpool=True,
                             columnar=use_columnar, alloc=alloc)
    c.net.join("flooder", "10.0.0.99", 9999, lambda d: None, lambda d: None)
    stream = _mixed_stream(p, 30)
    stream += stream[:5]
    fired = [False]
    M = p.messages

    def burst():
        fired[0] = True
        for w in range(0, len(stream), 12):
            c.net.deliver_gossip("flooder", M.pack_gossip(
                M.GOSSIP_TXNS, M.TxnsMsg(txns=tuple(stream[w:w + 12]))))

    c.clock.call_later(0.01, burst)
    c.start()
    c.run(600.0, stop_condition=lambda: fired[0] and c.min_height() >= 6)
    _stop(c)
    stats = {sn.name: dict(sn.node.txpool.stats) for sn in c.nodes}
    return (*_outcome(c), stats)


@pytest.mark.parametrize("use_columnar", [True, False],
                         ids=["columnar", "legacy"])
def test_gossip_flood_equals_the_reference(use_columnar):
    dump, heights, hashes, stats = _gossip_flood("eges_tpu_torch",
                                                 use_columnar)
    want = _gossip_flood("eges_tpu", use_columnar)
    assert min(heights) >= 6
    # non-vacuous: the flood admitted and rejected on some node
    assert any(s["admitted"] for s in stats.values())
    assert any(s["rejected"] for s in stats.values())
    assert (heights, hashes, stats) == want[1:]
    assert dump == want[0]
    # and the port's two ingest pipelines agree with each other
    other = _gossip_flood("eges_tpu_torch", not use_columnar)
    assert dump == other[0] and stats == other[3]


# -- crash and rejoin: restart from a checkpoint, fast-synced joiner -------

def _checkpointed_restart(root: str) -> tuple:
    p = _pkg(root)
    c = p.cluster.SimCluster(4, seed=3, txn_per_block=2, checkpoint_every=4)
    c.start()
    c.run(900, stop_condition=lambda: c.min_height() >= 12)
    c.crash(1)
    c.run(240, stop_condition=lambda: min(
        sn.chain.height() for sn in c.live_nodes()) >= 16)
    c.restart(1)
    c.run(240, stop_condition=lambda: c.min_height() >= 18)
    _stop(c)
    return _outcome(c)


def _late_joiner(root: str) -> tuple:
    p = _pkg(root)
    c = p.cluster.SimCluster(4, n_bootstrap=3, txn_per_block=2, seed=11,
                             reg_timeout_s=5.0, defer={3}, fast_sync={3})
    joiner = c.nodes[3]
    joiner.node.FASTSYNC_MIN_GAP = 16    # sim chains are short
    c.start()
    c.run(900, stop_condition=lambda: min(
        sn.chain.height() for sn in c.nodes[:3]) >= 60)
    c.start_deferred(3)
    c.run(900, stop_condition=lambda: (
        joiner.node._fs_done
        and joiner.chain.height() >= c.nodes[0].chain.height() - 4))
    assert joiner.node._fs_done
    # fast sync happened: the joiner never downloaded the early chain
    assert joiner.chain.get_block_by_number(1) is None
    _stop(c)
    return _outcome(c)


@pytest.mark.parametrize("scenario", [_checkpointed_restart, _late_joiner],
                         ids=["checkpointed_restart", "fast_sync_joiner"])
def test_crash_and_rejoin_equal_the_reference(scenario):
    dump, heights, hashes = scenario("eges_tpu_torch")
    want = scenario("eges_tpu")
    assert (heights, hashes) == want[1:]
    assert dump == want[0]
    rst = [ln for ln in dump.splitlines() if b'"statesync_' in ln]
    assert rst, "no statesync event in the journals"


# -- the PoW engine: the sweep through the port's keccak256_fixed ----------

def test_pow_mines_the_reference_blocks():
    ref, port = _pkg("eges_tpu"), _pkg("eges_tpu_torch")
    hashes = []
    for p, eng in ((ref, ref.engine.PowEngine(sweep_batch=128)),
                   (port, port.engine.PowEngine(sweep_batch=128,
                                                device="cpu"))):
        chain = p.chain.BlockChain(genesis=p.chain.make_genesis(),
                                   engine=eng)
        hashes.append([eng.mine_next(chain).hash for _ in range(3)])
        assert chain.height() == 3 and eng.use_device
    assert hashes[0] == hashes[1]


@pytest.mark.parametrize("difficulty,start", [
    (16, 5), (64, (1 << 64) - 60), (100, (1 << 63) - 3), (4096, 77)])
def test_one_sweep_gives_the_reference_nonce(difficulty, start):
    """One ``_sweep_device`` call on identical inputs (across the int64
    sign and the 2**64 wrap of the nonce) returns the reference's
    nonce, or None where the reference finds none."""
    ref = _pkg("eges_tpu").engine.PowEngine(sweep_batch=128)
    port = _pkg("eges_tpu_torch").engine.PowEngine(sweep_batch=128,
                                                   device="cpu")
    sh = bytes(range(32))
    target = (1 << 256) // difficulty
    assert port._sweep_device(sh, start, target) == \
        ref._sweep_device(sh, start, target)


def test_a_failing_sweep_raises_out_of_seal(monkeypatch):
    """No hidden fallback: a device sweep that raises makes ``seal``
    raise, and the engine stays on the device."""
    from eges_tpu_torch.ops import keccak

    p = _pkg("eges_tpu_torch")
    eng = p.engine.PowEngine(sweep_batch=128, device="cpu")
    chain = p.chain.BlockChain(genesis=p.chain.make_genesis(), engine=eng)

    def broken(data):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(keccak, "keccak256_fixed", broken)
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        eng.mine_next(chain)
    assert eng.use_device and chain.height() == 0


def test_pow_host_loop_and_entry_points():
    """``use_device=False`` keeps the reference's host loop and needs no
    device; a device engine defaults to the card, which raises where
    there is none."""
    import torch

    ref, port = _pkg("eges_tpu"), _pkg("eges_tpu_torch")
    blocks = []
    for p, eng in ((ref, ref.engine.PowEngine(sweep_batch=64,
                                              use_device=False)),
                   (port, port.engine.PowEngine(sweep_batch=64,
                                                use_device=False))):
        chain = p.chain.BlockChain(genesis=p.chain.make_genesis(),
                                   engine=eng)
        blocks.append(eng.mine_next(chain).hash)
    assert blocks[0] == blocks[1]
    assert eng.device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.engine.PowEngine()


# -- the port's device verifier in the loop --------------------------------

SENDERS = [bytes([i + 1]) * 32 for i in range(3)]


def _verifier_sim(make_verifier) -> tuple:
    """3 nodes, unsigned votes, one gossip burst of 30 signed transfers
    from 3 funded senders: every row reaches the shared scheduler once
    (the first pool's window), the other pools and the block validators
    hit its cache."""
    p = _pkg("eges_tpu_torch")
    alloc = {p.secp.pubkey_to_address(p.secp.privkey_to_pubkey(k)): 10 ** 18
             for k in SENDERS}
    c = p.cluster.SimCluster(3, seed=1, txn_per_block=10, txpool=True,
                             signed=False, alloc=alloc,
                             verifier=make_verifier())
    c.net.join("flooder", "10.0.0.99", 9999, lambda d: None, lambda d: None)
    txs = tuple(p.types.Transaction(
        nonce=i // 3, gas_price=1, gas_limit=21000, to=b"\x09" * 20,
        value=i + 1).signed(SENDERS[i % 3]) for i in range(30))
    fired = [False]
    M = p.messages

    def burst():
        fired[0] = True
        c.net.deliver_gossip("flooder", M.pack_gossip(
            M.GOSSIP_TXNS, M.TxnsMsg(txns=txs)))

    c.clock.call_later(0.01, burst)
    c.start()
    c.run(600.0, stop_condition=lambda: fired[0] and c.min_height() >= 5)
    for sn in c.nodes:
        sn.node.stop()
    st = c.verifier.stats()
    c.verifier.close()
    included = [[len(sn.chain.get_block_by_number(h).transactions)
                 for h in range(1, 6)] for sn in c.nodes]
    return (c.heights(), _hashes(c),
            {sn.name: dict(sn.node.txpool.stats) for sn in c.nodes},
            included), st


def test_device_verifier_sim_equals_its_native_twin():
    """The port's ``BatchVerifier(device="cpu")`` behind ``scheduler_for``
    gives the chain, the included transactions and the txpool stats of
    the same sim over the port's ``NativeBatchVerifier``.  At most 4
    device windows: each is a plain recovery on the CPU, 5-7 s whatever
    its rows, so the sim is sized to send its 30 rows in one."""
    from eges_tpu_torch.crypto.verifier import BatchVerifier
    from eges_tpu_torch.crypto.verify_host import NativeBatchVerifier

    native, nst = _verifier_sim(NativeBatchVerifier)
    device, dst = _verifier_sim(lambda: BatchVerifier(device="cpu"))
    assert device == native
    assert all(sum(n) == 30 for n in native[3])
    assert 1 <= dst["pipeline_windows"] == dst["batches"] <= 4
    assert dst["rows"] == nst["rows"] == 30
    assert dst["host_diverted"] == 0 and dst["device_errors"] == 0
    assert dst["cache_hits"] == nst["cache_hits"] > 0


def test_the_port_dump_is_the_reference_dump():
    """``testing.canonical_dump`` (the port's copy for ``chip_smoke.py``,
    which may not import the reference's harness) writes the bytes of
    ``harness.chaos.canonical_dump`` on a transfer-flood sim's journals;
    ``drop`` leaves out exactly the verifier-only events."""
    from harness import chaos

    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.crypto.verify_host import NativeBatchVerifier

    assert tt.VOLATILE_KEYS == chaos.VOLATILE_KEYS
    txs, alloc = tt.sim_transfers(24, 4, seed=2)
    c = tt.flood_sim(NativeBatchVerifier(), txs, alloc, nodes=3, window=8,
                     seed=2, height=3, txn_per_block=10, signed=False)
    c.verifier.close()
    journals = c.journals()
    assert tt.canonical_dump(journals) == chaos.canonical_dump(journals)
    out = tt.sim_outcome(c, txs, tt.verifier_only)
    assert None not in sum(out["included"], [])
    kept = out["dump"].splitlines()
    every = tt.canonical_dump(journals).decode().splitlines()
    gone = [ln for ln in every if ln not in kept]
    assert gone and all('"verifier_flush"' in ln or '"verify_window"' in ln
                        for ln in gone)


@pytest.mark.parametrize("gossip", [False, True], ids=["direct", "gossip"])
def test_flood_sim_delivers_every_transfer(gossip):
    """``testing.flood_sim``'s two deliveries: windows that every pool
    admits before the first block (the transfers land in block 1, and
    no transfer crosses the network), or windows that the flooder
    gossips and every node relays (each node sends each transfer it
    admitted to every peer once: nodes x transfers x (nodes - 1)
    deliveries besides the flooder's)."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.crypto.verify_host import NativeBatchVerifier

    txs, alloc = tt.sim_transfers(24, 4, seed=2)
    c = tt.flood_sim(NativeBatchVerifier(), txs, alloc, nodes=3, window=8,
                     seed=2, txn_per_block=30, signed=False, gossip=gossip,
                     start_s=0.01 if gossip else 0.0)
    c.verifier.close()
    out = tt.sim_outcome(c, txs)
    assert all(p["admitted"] == 24 and p["rejected"] == 0
               for p in out["pool"])
    landed = {h for inc in out["included"] for h in inc}
    relays = 3 * 24 * 2
    if gossip:
        assert landed == {2} and out["net"]["gossip"] >= relays + 3 * 3
    else:
        assert landed == {1} and out["net"]["gossip"] < relays


def test_the_host_copies_load_no_torch():
    """Consensus, chain, state, EVM, ingress and the sim stay plain
    Python, as in the reference: importing them loads no torch (the PoW
    sweep and the card's verifier import it when they run)."""
    import json
    import os
    import subprocess
    import sys

    mods = ["eges_tpu_torch.sim.cluster", "eges_tpu_torch.core.engine",
            "eges_tpu_torch.core.evm", "eges_tpu_torch.core.statesync",
            "eges_tpu_torch.core.bloomindex", "eges_tpu_torch.crypto.bn254",
            "eges_tpu_torch.consensus.engine",
            "eges_tpu_torch.ingress.columnar",
            "eges_tpu_torch.utils.timeseries", "eges_tpu_torch.utils.limits"]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = json.loads(out.splitlines()[-1])
    for root_mod in ("torch", "jax", "eges_tpu"):
        assert not [m for m in loaded
                    if m == root_mod or m.startswith(root_mod + ".")]
