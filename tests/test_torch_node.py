"""The port's node service (``eges_tpu_torch/node/``) and its cluster
harness (``eges_tpu_torch/harness/cluster.py``) on the CPU.

A 3-node chain runs in one process over real localhost sockets: node 0
in the ``"torch"`` verifier mode on the CPU (``verifier_device="cpu"``:
the plain versions of the kernels, one 5-7 s plain recovery a window),
the other two on the native verifier, so the transfer node 0 admits
costs it exactly one plain window and comes back with the right
``from``.  The modes (``"jax"`` refused, the default needing a card),
the C8 gauge, the CLI, and a 3-process native cluster started by the
harness (``python -m eges_tpu_torch.node``) to height 2 complete it."""

import asyncio
import json
import os
import socket
import time

import pytest
import torch

from eges_tpu_torch.consensus.config import NodeConfig
from eges_tpu_torch.core.types import Transaction
from eges_tpu_torch.crypto import secp256k1 as secp
from eges_tpu_torch.harness import cluster as hc
from eges_tpu_torch.node import __main__ as node_main
from eges_tpu_torch.node.service import NodeService, ServiceConfig
from eges_tpu_torch.utils.metrics import DEFAULT as metrics


def _free_ports(n: int) -> list[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _genesis(path, cports, signed_votes=True) -> str:
    boot = [{"account": secp.pubkey_to_address(secp.privkey_to_pubkey(
        hc.node_key(i))).hex(), "ip": "127.0.0.1", "port": str(p)}
        for i, p in enumerate(cports)]
    doc = {"config": {"chainId": 930412, "thw": {
        "bootstrap": boot, "reg_per_blk": 10, "registration_timeout": 10,
        "validate_timeout": 500, "election_timeout": 100,
        "backoff_time": 0, "signed_votes": signed_votes}},
        "timestamp": "0x0", "extraData": "geec-tpu-torch-test"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


def _config(tmp_path, gen, i, gports, cports, **kw) -> ServiceConfig:
    return ServiceConfig(
        datadir=str(tmp_path / f"node{i}"), genesis_path=gen,
        key_hex=hc.node_key(i).hex(), gossip_port=gports[i],
        peers=tuple(("127.0.0.1", p) for p in gports),
        node=NodeConfig(consensus_port=cports[i], total_nodes=len(cports),
                        txn_per_block=10, block_timeout_s=5.0),
        verbosity=1, **kw)


# -- the modes and the C8 gauge -------------------------------------------

def test_jax_mode_is_refused(tmp_path):
    gen = _genesis(tmp_path / "g.json", [18100])
    with pytest.raises(ValueError, match="'torch'"):
        NodeService(_config(tmp_path, gen, 0, [16190], [18100],
                            verifier_mode="jax"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card: the default mode takes the card")
def test_the_default_mode_needs_a_card(tmp_path):
    gen = _genesis(tmp_path / "g.json", [18100])
    for mode in ("", "torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            NodeService(_config(tmp_path, gen, 0, [16190], [18100],
                                verifier_mode=mode))


def test_torch_mode_names_its_device(tmp_path):
    """C8: the verifier the ``"torch"`` mode makes sets the
    ``verifier.device_name`` gauge that ``thw_metrics`` carries."""
    gen = _genesis(tmp_path / "g.json", [18100])

    async def run():
        svc = NodeService(_config(tmp_path, gen, 0, [16190], [18100],
                                  verifier_mode="torch",
                                  verifier_device="cpu"))
        assert svc._verifier_mode == "torch"
        assert svc._raw_verifier.device.type == "cpu"
        return svc

    asyncio.run(run())
    assert metrics.snapshot()["verifier.device_name"] == "cpu"


def test_cli_parses_the_port_flags():
    args = node_main.build_parser().parse_args(
        ["--datadir", "d", "--genesis", "g", "--keyhex", "00" * 32,
         "--verifier", "torch", "--verifierDevice", "cpu",
         "--no-deviceVerify"])
    assert (args.verifier, args.verifierDevice, args.deviceVerify) == \
        ("torch", "cpu", False)
    dflt = node_main.build_parser().parse_args(
        ["--datadir", "d", "--genesis", "g", "--keyhex", "00" * 32])
    assert (dflt.verifier, dflt.verifierDevice, dflt.deviceVerify) == \
        ("", "cuda", True)
    for bad in ("jax", "tpu"):
        with pytest.raises(SystemExit):
            node_main.build_parser().parse_args(
                ["--datadir", "d", "--genesis", "g", "--keyhex", "00",
                 "--verifier", bad])
    with pytest.raises(SystemExit):
        node_main.build_parser().parse_args(
            ["--datadir", "d", "--genesis", "g", "--keyhex", "00",
             "--tpuVerify"])


# -- a transfer through a torch-mode node on the CPU ----------------------

def test_torch_node_on_the_cpu_mines_a_transfer(tmp_path):
    """Node 0 (``"torch"``, CPU) admits a signed transfer through its
    scheduler in one plain window and the 3-node chain mines it: every
    node's receipt says status 1 and the host model's sender.  Votes go
    unsigned (genesis ``signed_votes: false``) so each vote check is no
    plain window of its own."""
    gports, cports = _free_ports(3), _free_ports(3)
    gen = _genesis(tmp_path / "g.json", cports, signed_votes=False)
    sender = hc.node_key(7)
    frm = secp.pubkey_to_address(secp.privkey_to_pubkey(sender))
    t = Transaction(nonce=0, gas_price=0, gas_limit=21000, to=b"\x09" * 20,
                    value=0).signed(sender)

    async def run():
        svcs = [NodeService(_config(
            tmp_path, gen, i, gports, cports, rpc_port=0,
            verifier_mode="torch" if i == 0 else "native",
            verifier_device="cpu")) for i in range(3)]
        for s in svcs:
            await s.start()
        try:
            t0 = time.monotonic()
            svcs[0].txpool.add_locals([t])
            while time.monotonic() - t0 < 90:
                await asyncio.sleep(0.2)
                if all(s.chain.lookup_txn(t.hash) for s in svcs):
                    break
            found = [s.chain.lookup_txn(t.hash) for s in svcs]
            assert all(found), [s.chain.height() for s in svcs]
            for blk, idx, receipt in found:
                assert receipt.status == 1
                assert blk.hash == found[0][0].hash
            st = svcs[0].chain.verifier.stats()
            # the recovered sender is the host model's: its nonce moved
            # on every node (the RPC has no "from"; the state does)
            nonces = [s.chain.state_at(s.chain.head().hash).nonce(frm)
                      for s in svcs]
            return st, nonces, [s.chain.height() for s in svcs]
        finally:
            for s in svcs:
                s.close()

    st, nonces, heights = asyncio.run(run())
    assert min(heights) >= 1 and nonces == [1, 1, 1]
    # one plain window on node 0, no host row, no error
    assert st["pipeline_windows"] == st["batches"] == 1
    assert st["rows"] == 1 and st["host_diverted"] == 0
    assert st["device_errors"] == 0 and st["cache_hits"] >= 1


# -- the harness: three node processes on the native verifier -------------

def test_cluster_ports_are_a_deployment_setting(tmp_path):
    """The port bases reach every node's command line and the genesis,
    are kept in ``cluster.json``, and default to the reference's; free
    bases leave no port of the run in use and no two planes sharing a
    port."""
    assert hc.Ports() == hc.Ports(6190, 8100, 10000, 9100, 30301)
    assert hc.ports_of({}) == hc.Ports()
    p = hc.Ports.free(3)
    every = [b + i for b in (p.gossip, p.consensus, p.txn, p.rpc)
             for i in range(3)] + [p.boot]
    assert len(set(every)) == 13 and all(hc._port_free(q) for q in every)
    gen = tmp_path / "genesis.json"
    hc.write_genesis(str(gen), 3, ports=p)
    boot = json.loads(gen.read_text())["config"]["thw"]["bootstrap"]
    assert [int(b["port"]) for b in boot] == [p.consensus + i
                                              for i in range(3)]
    cmd = hc._node_cmd(2, 3, str(tmp_path), str(gen), hc.parse_hosts("", 3),
                       txn_per_block=10, txn_size=100, block_timeout=5.0,
                       mine=True, ports=p)
    flag = {cmd[k]: cmd[k + 1] for k in range(len(cmd) - 1)
            if cmd[k].startswith("--")}
    assert (flag["--consensusPort"], flag["--gossipPort"],
            flag["--geecTxnPort"], flag["--rpcPort"]) == (
        str(p.consensus + 2), str(p.gossip + 2), str(p.txn + 2),
        str(p.rpc + 2))
    assert flag["--peers"] == ",".join(f"127.0.0.1:{p.gossip + j}"
                                       for j in range(3))


def test_native_cluster_of_three_processes_mines(tmp_path):
    """``harness/cluster.py`` starts three ``python -m
    eges_tpu_torch.node`` processes (native verifier, real sockets,
    RPC on) on free port bases; every node reaches height 2 and answers
    over RPC on its own port."""
    d = str(tmp_path / "c")
    ports = hc.Ports.free(3)
    pids = hc.start_cluster(d, 3, txn_per_block=10, block_timeout=5.0,
                            ports=ports)
    try:
        assert len(pids) == 3
        t0 = time.monotonic()
        hs = []
        while time.monotonic() - t0 < 60:
            time.sleep(0.5)
            hs = hc.node_heights(d)
            if len(hs) == 3 and min(hs) >= 2:
                break
        assert len(hs) == 3 and min(hs) >= 2, hs
        for i in range(3):
            h = int(hc._rpc_once("eth_blockNumber", [], ports.rpc + i), 16)
            assert h >= 2
        meta = hc.load_meta(d)
        assert meta["torch_nodes"] == [] and meta["pids"] == pids
        assert hc.ports_of(meta) == ports
    finally:
        hc.kill_cluster(d)
        for pid in pids:
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
