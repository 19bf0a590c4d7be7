"""The port's JSON-RPC server (``eges_tpu_torch/rpc/server.py``) against
the reference's: the same seeded chain built through each package
answers every method that is not volatile with equal JSON from
``RpcServer.dispatch`` — the eth namespace and ``debug_traceTransaction``
with each tracer on a chain with a contract, and the eth and thw
namespaces on a same-seed signed 3-node sim with txpools (host crypto:
the sims are byte-equal, ``tests/test_torch_sim.py``).  Errors compare
by code and message.  Tolerance 0."""

from __future__ import annotations

import importlib
import json
import types

from eges_tpu_torch import testing as tt

ETH = 10 ** 18
PRIV = bytes([7]) * 32
# tests/test_rpc_evm_api.py's contract: a counter at slot 0 with a LOG1
# (topic 7) on each call
RUNTIME = bytes.fromhex(
    "600054600101806000556000526007602060" + "00a1" + "602060" + "00f3")
INIT = (bytes([0x60, len(RUNTIME), 0x60, 0x0C, 0x60, 0x00, 0x39,
               0x60, len(RUNTIME), 0x60, 0x00, 0xF3]) + RUNTIME)


def _pkg(root: str) -> types.SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("chain", "core.chain"), ("state", "core.state"),
        ("types", "core.types"), ("secp", "crypto.secp256k1"),
        ("rpc", "rpc.server"), ("cluster", "sim.cluster"),
        ("messages", "consensus.messages"))}
    return types.SimpleNamespace(root=root, **mods)


def _answers(rpc, calls) -> list:
    out = []
    for method, params in calls:
        try:
            got = rpc.dispatch(method, params)
        except Exception as e:  # an RpcError of either package
            got = {"error": [getattr(e, "code", type(e).__name__), str(e)]}
        out.append(json.loads(json.dumps(got, sort_keys=True)))
    return out


# -- a chain with a contract: eth reads, calls, logs, traces ---------------

def _contract_chain(root: str):
    p = _pkg(root)
    addr = p.secp.pubkey_to_address(p.secp.privkey_to_pubkey(PRIV))
    chain = p.chain.BlockChain(
        genesis=p.chain.make_genesis(alloc={addr: 10 * ETH}),
        alloc={addr: 10 * ETH})
    caddr = p.state.contract_address(addr, 0)

    def signed(nonce, to, payload=b""):
        return p.types.Transaction(nonce=nonce, gas_price=2,
                                   gas_limit=500_000, to=to, value=0,
                                   payload=payload).signed(PRIV)

    txs = [signed(0, None, INIT), signed(1, caddr), signed(2, caddr),
           signed(3, None, b"\xfe")]            # a failing create
    kept, root_, rroot, gas, bloom = chain.execute_preview(
        txs, coinbase=bytes(20))
    head = chain.head()
    blk = p.types.new_block(p.types.Header(
        parent_hash=head.hash, number=1, time=head.header.time + 1,
        root=root_, receipt_hash=rroot, gas_used=gas, bloom=bloom),
        txs=kept)
    assert chain.offer(blk), chain.last_error
    return p, chain, addr, caddr, blk


def _contract_calls(addr, caddr, blk) -> list:
    a, c = "0x" + addr.hex(), "0x" + caddr.hex()
    hs = ["0x" + t.hash.hex() for t in blk.transactions]
    topic7 = "0x" + (7).to_bytes(32, "big").hex()
    calls = [
        ("eth_blockNumber", []), ("eth_chainId", []), ("net_version", []),
        ("web3_clientVersion", []), ("eth_gasPrice", []),
        ("eth_getBlockByNumber", ["0x0", False]),
        ("eth_getBlockByNumber", ["0x1", True]),
        ("eth_getBlockByNumber", ["latest", False]),
        ("eth_getBlockByNumber", ["0x9", False]),
        ("eth_getBlockByHash", ["0x" + blk.hash.hex(), True]),
        ("eth_getBalance", [a, "latest"]), ("eth_getBalance", [c]),
        ("eth_getTransactionCount", [a, "latest"]),
        ("eth_getCode", [c]), ("eth_getStorageAt", [c, "0x0"]),
        ("eth_call", [{"from": a, "to": c}]),
        ("eth_estimateGas", [{"from": a, "to": c}]),
        ("eth_getLogs", [{"fromBlock": "0x0", "toBlock": "0x1"}]),
        ("eth_getLogs", [{"fromBlock": "0x0", "topics": [topic7]}]),
        ("eth_getLogs", [{"address": "0x" + bytes(20).hex()}]),
        ("eth_getTransactionByHash", ["0x" + bytes(32).hex()]),
        ("thw_status", []), ("thw_flight", []), ("no_such_method", []),
    ]
    for h in hs:
        calls += [("eth_getTransactionReceipt", [h]),
                  ("eth_getTransactionByHash", [h]),
                  ("debug_traceTransaction", [h]),
                  ("debug_traceTransaction", [h, {"disableStack": True}])]
        for tracer in ("callTracer", "prestateTracer", "4byteTracer",
                       "nope"):
            calls.append(("debug_traceTransaction", [h, {"tracer": tracer}]))
    return calls


def test_contract_chain_answers_equal_the_reference():
    answers = []
    for root in ("eges_tpu", "eges_tpu_torch"):
        p, chain, addr, caddr, blk = _contract_chain(root)
        rpc = p.rpc.RpcServer(chain)
        answers.append(_answers(rpc, _contract_calls(addr, caddr, blk)))
    ref, port = answers
    # non-vacuous: a deploy, two logging calls and a failed create
    receipts = [a for a in ref if isinstance(a, dict) and "logs" in a]
    assert [r["status"] for r in receipts] == ["0x1", "0x1", "0x1", "0x0"]
    assert any(isinstance(a, dict) and a.get("structLogs") for a in ref)
    for i, (want, got) in enumerate(zip(ref, port)):
        assert got == want, i


# -- a same-seed signed sim: eth and thw on a live node --------------------

SENDERS = [bytes([i + 1]) * 32 for i in range(3)]
# keys of thw_health and the journal that read the wall clock or the
# process (profiler, device ledger)
HEALTH_VOLATILE = {"profiler", "devstats", "lastCommitAge", "stalled"}


def _sim_answers(root: str) -> list:
    p = _pkg(root)
    alloc = {p.secp.pubkey_to_address(p.secp.privkey_to_pubkey(k)): ETH
             for k in SENDERS}
    c = p.cluster.SimCluster(3, seed=5, txn_per_block=4, txpool=True,
                             signed=True, alloc=alloc)
    c.net.join("flooder", "10.0.0.99", 9999, lambda d: None, lambda d: None)
    txs = tuple(p.types.Transaction(
        nonce=i // 3, gas_price=1, gas_limit=21000, to=b"\x09" * 20,
        value=i + 1).signed(SENDERS[i % 3]) for i in range(9))
    M = p.messages
    c.clock.call_later(0.01, lambda: c.net.deliver_gossip(
        "flooder", M.pack_gossip(M.GOSSIP_TXNS, M.TxnsMsg(txns=txs))))
    c.start()
    c.run(120, stop_condition=lambda: c.min_height() >= 4)
    for sn in c.nodes:
        sn.node.stop()
    sn = c.nodes[0]
    rpc = p.rpc.RpcServer(sn.chain, node=sn.node, txpool=sn.node.txpool)
    calls = [("eth_blockNumber", []), ("thw_status", []),
             ("thw_membership", []), ("thw_pendingGeecTxns", []),
             ("thw_ledger", []), ("thw_flight", [])]
    calls += [("eth_getBalance", ["0x" + a.hex()]) for a in alloc]
    calls += [("eth_getTransactionCount", ["0x" + a.hex()]) for a in alloc]
    for h in range(4):
        calls.append(("eth_getBlockByNumber", [hex(h), True]))
    calls += [("eth_getTransactionReceipt", ["0x" + t.hash.hex()])
              for t in txs]
    out = _answers(rpc, calls)
    health = rpc.dispatch("thw_health", [])
    out.append(json.loads(json.dumps(
        {k: v for k, v in health.items() if k not in HEALTH_VOLATILE},
        sort_keys=True)))
    journal = rpc.dispatch("thw_journal", [{"limit": 4096}])
    out.append(tt.canonical_dump({"n0": journal}).decode())
    return out


def test_sim_node_answers_equal_the_reference():
    ref = _sim_answers("eges_tpu")
    port = _sim_answers("eges_tpu_torch")
    # non-vacuous: the transfers were mined with status 0x1
    receipts = [a for a in ref if isinstance(a, dict) and "status" in a]
    assert len(receipts) == 9 and {r["status"] for r in receipts} == {"0x1"}
    for i, (want, got) in enumerate(zip(ref, port)):
        assert got == want, i
    assert len(ref) == len(port)
