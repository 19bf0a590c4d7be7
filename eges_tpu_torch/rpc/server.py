"""JSON-RPC server: the user-facing API layer.

The port's copy of ``eges_tpu/rpc/server.py``: ``thw_metrics``'s
``verifier.device_share`` counts the port's facade rows (the CUDA
kernels) over all rows, and ``thw_metrics`` also carries the
scheduler's stats (``verifier.scheduler``) and the process's kernel
launch counts (``kernels.launches``); ``thw_device_trace`` arms the
port's ``torch.profiler`` armer (``utils/devstats.py``).

Covers the capability role of the reference's ``rpc/`` + ``internal/
ethapi`` stack (ref: rpc/server.go, internal/ethapi/api.go:489+) for
the Geec path, plus the ``thw`` namespace the engine registers
(ref: consensus/geec/geec.go:450-457).  JSON-RPC 2.0 over HTTP on
asyncio streams — no external web framework, single event loop shared
with the consensus node.

Transports: HTTP (keep-alive, batch requests) and a geth.ipc-style
unix socket (newline-delimited JSON).

Methods:
  eth_blockNumber, eth_getBlockByNumber, eth_getBlockByHash,
  eth_getBalance, eth_getTransactionCount, eth_getTransactionReceipt,
  eth_getCode, eth_getStorageAt, eth_call, eth_estimateGas,
  eth_gasPrice, eth_getLogs, eth_newFilter, eth_newBlockFilter,
  eth_getFilterChanges, eth_uninstallFilter, eth_sendRawTransaction,
  net_version, web3_clientVersion,
  thw_register, thw_membership, thw_status, thw_pendingGeecTxns,
  thw_metrics, thw_traces, thw_health, thw_journal, thw_ledger,
  debug_startProfile, debug_stopProfile, debug_stacks, debug_stats

Plain HTTP ``GET /metrics`` on the same port serves the whole metrics
registry in Prometheus text exposition format (the pull-based analogue
of the reference's influxdb push exporters behind ``--metrics``).
"""

from __future__ import annotations

import asyncio
import json

from eges_tpu_torch.core import rlp
from eges_tpu_torch.core.types import Block, Transaction
from eges_tpu_torch.utils.limits import clamp_rpc_limit

# Closed vocabulary of dispatched JSON-RPC methods.  The static-analysis
# vocabulary rule checks this both ways against the ``method == "..."``
# dispatch comparisons below: an unregistered dispatch literal and a
# registered method with no dispatch site both fail the gate.  The
# ``debug_*`` namespace goes through a prefix dispatcher and is exempt.
RPC_METHODS = frozenset({
    "eth_blockNumber", "eth_call", "eth_chainId", "eth_estimateGas",
    "eth_gasPrice", "eth_getBalance", "eth_getBlockByHash",
    "eth_getBlockByNumber", "eth_getCode", "eth_getFilterChanges",
    "eth_getLogs", "eth_getStorageAt", "eth_getTransactionByHash",
    "eth_getTransactionCount", "eth_getTransactionReceipt",
    "eth_newBlockFilter", "eth_newFilter", "eth_sendRawTransaction",
    "eth_subscribe", "eth_uninstallFilter", "eth_unsubscribe",
    "net_version", "thw_device_trace", "thw_devices", "thw_flight",
    "thw_health", "thw_journal", "thw_ledger", "thw_membership",
    "thw_metrics", "thw_pendingGeecTxns", "thw_profile",
    "thw_register", "thw_status", "thw_traces", "web3_clientVersion",
})


def _hex(n: int) -> str:
    return hex(n)


def _profiler_stats() -> dict:
    """The process-wide sampling profiler's health block (hz, samples,
    dropped, overhead estimate) — all zeros/False when disabled."""
    from eges_tpu_torch.utils import profiler as profiler_mod
    return profiler_mod.DEFAULT.stats()


def _devstats_stats() -> dict:
    """The device-efficiency ledger's health block (window/row volume,
    cumulative goodput, trace armer state) — zeros until a scheduler
    window has been recorded."""
    from eges_tpu_torch.utils import devstats as devstats_mod
    return devstats_mod.DEFAULT.stats()


def _block_json(b: Block, full: bool) -> dict:
    h = b.header
    return {
        "number": _hex(h.number),
        "hash": "0x" + b.hash.hex(),
        "parentHash": "0x" + h.parent_hash.hex(),
        "stateRoot": "0x" + h.root.hex(),
        "transactionsRoot": "0x" + h.tx_hash.hex(),
        "receiptsRoot": "0x" + h.receipt_hash.hex(),
        "miner": "0x" + h.coinbase.hex(),
        "difficulty": _hex(h.difficulty),
        "gasLimit": _hex(h.gas_limit),
        "gasUsed": _hex(h.gas_used),
        "timestamp": _hex(h.time),
        "extraData": "0x" + h.extra.hex(),
        "trustRand": _hex(h.trust_rand),
        "registrations": [
            {"account": "0x" + r.account.hex(), "ip": r.ip, "port": r.port,
             "renew": r.renew} for r in h.regs],
        "geecTxnCount": len(b.geec_txns),
        "fakeTxnCount": len(b.fake_txns),
        "confirm": None if b.confirm is None else {
            "blockNumber": b.confirm.block_number,
            "hash": "0x" + b.confirm.hash.hex(),
            "confidence": b.confirm.confidence,
            "supporters": ["0x" + s.hex() for s in b.confirm.supporters],
            "emptyBlock": b.confirm.empty_block,
        },
        "transactions": (
            [_txn_json(t) for t in b.transactions] if full
            else ["0x" + t.hash.hex() for t in b.transactions]),
    }


def _txn_json(t: Transaction) -> dict:
    return {
        "hash": "0x" + t.hash.hex(),
        "nonce": _hex(t.nonce),
        "gasPrice": _hex(t.gas_price),
        "gas": _hex(t.gas_limit),
        "to": None if t.to is None else "0x" + t.to.hex(),
        "value": _hex(t.value),
        "input": "0x" + t.payload.hex(),
        "isGeec": t.is_geec,
        "v": _hex(t.v), "r": _hex(t.r), "s": _hex(t.s),
    }


class RpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class RpcServer:
    def __init__(self, chain, node=None, txpool=None, *,
                 bind_ip: str = "127.0.0.1", port: int = 8545,
                 chain_id: int = 930412):
        self.chain = chain
        self.node = node
        self.txpool = txpool
        self.bind_ip = bind_ip
        self.port = port
        self.chain_id = chain_id
        self._server = None
        self._filters: dict = {}
        self._filter_seq = 0
        self._ws_conns: list = []  # (writer, subscriptions) per WS conn
        chain.add_listener(self._on_block_for_ws)

    # -- method handlers --------------------------------------------------

    def _resolve_block(self, tag) -> Block | None:
        if tag in ("latest", "pending", None):
            return self.chain.head()
        if tag == "earliest":
            return self.chain.get_block_by_number(0)
        return self.chain.get_block_by_number(int(tag, 16))

    def _state_for(self, tag):
        blk = self._resolve_block(tag)
        if blk is None:
            raise RpcError(-32602, "unknown block")
        st = self.chain.state_at(blk.hash)
        if st is None:
            raise RpcError(-32000, "state pruned for that block")
        return st

    def _receipt_json(self, txn_hash: bytes):
        """O(1) via the chain's txn-hash index (the LevelDB lookup-entry
        role, ref: core/database_util.go GetTxLookupEntry)."""
        hit = self.chain.lookup_txn(txn_hash)
        if hit is None:
            return None
        blk, i, r = hit
        if r is None:
            return None
        receipts = self.chain.receipts_of(blk.hash)
        return {
            "transactionHash": "0x" + txn_hash.hex(),
            "blockNumber": _hex(blk.number),
            "blockHash": "0x" + blk.hash.hex(),
            "transactionIndex": _hex(i),
            "status": _hex(r.status),
            "cumulativeGasUsed": _hex(r.cumulative_gas_used),
            "gasUsed": _hex(
                r.cumulative_gas_used
                - (receipts[i - 1].cumulative_gas_used if i else 0)),
            "logs": [{"address": "0x" + a.hex(),
                      "topics": ["0x" + t.hex() for t in ts],
                      "data": "0x" + d.hex()}
                     for (a, ts, d) in getattr(r, "logs", ())],
        }

    def dispatch(self, method: str, params: list):  # ingress-entry:bounded
        if method == "eth_blockNumber":
            return _hex(self.chain.height())
        if method == "eth_getBlockByNumber":
            blk = self._resolve_block(params[0])
            full = bool(params[1]) if len(params) > 1 else False
            return None if blk is None else _block_json(blk, full)
        if method == "eth_getBlockByHash":
            blk = self.chain.get_block(bytes.fromhex(params[0][2:]))
            full = bool(params[1]) if len(params) > 1 else False
            return None if blk is None else _block_json(blk, full)
        if method == "eth_sendRawTransaction":
            if self.txpool is None:
                raise RpcError(-32000, "no transaction pool")
            raw = bytes.fromhex(params[0][2:])
            try:
                txn = Transaction.decode(raw)
            except rlp.RLPError as e:
                raise RpcError(-32602, f"invalid transaction RLP: {e}")
            if self.node is not None and self.node.txpool is self.txpool:
                # pool admission + gossip broadcast to peers
                # (ref: eth/handler.go:742-759 TxMsg fan-out)
                self.node.submit_txns([txn])
            else:
                self.txpool.add_remotes([txn])
                if self.node is not None:  # still broadcast to peers
                    self.node.broadcast_txns([txn])
            return "0x" + txn.hash.hex()
        if method == "eth_getBalance":
            st = self._state_for(params[1] if len(params) > 1 else "latest")
            return _hex(st.balance(bytes.fromhex(params[0][2:])))
        if method == "eth_getTransactionByHash":
            hit = self.chain.lookup_txn(bytes.fromhex(params[0][2:]))
            if hit is None:
                return None
            blk, i, _ = hit
            out = _txn_json(blk.transactions[i])
            out["blockNumber"] = _hex(blk.number)
            out["blockHash"] = "0x" + blk.hash.hex()
            out["transactionIndex"] = _hex(i)
            return out
        if method == "eth_chainId":
            return _hex(self.chain_id)
        if method == "eth_getTransactionCount":
            st = self._state_for(params[1] if len(params) > 1 else "latest")
            return _hex(st.nonce(bytes.fromhex(params[0][2:])))
        if method == "eth_getCode":
            st = self._state_for(params[1] if len(params) > 1 else "latest")
            return "0x" + st.code(bytes.fromhex(params[0][2:])).hex()
        if method == "eth_getStorageAt":
            st = self._state_for(params[2] if len(params) > 2 else "latest")
            v = st.storage_at(bytes.fromhex(params[0][2:]),
                              int(params[1], 16))
            return "0x" + v.to_bytes(32, "big").hex()
        if method == "eth_call":
            return self._eth_call(params[0],
                                  params[1] if len(params) > 1 else "latest")
        if method == "eth_estimateGas":
            return _hex(self._estimate_gas(
                params[0], params[1] if len(params) > 1 else "latest"))
        if method == "eth_gasPrice":
            return _hex(self._gas_price())
        if method == "eth_getLogs":
            return self._get_logs(params[0] if params else {})
        if method in ("eth_newFilter", "eth_newBlockFilter"):
            return self._new_filter(method,
                                    params[0] if params else {})
        if method == "eth_getFilterChanges":
            return self._filter_changes(params[0])
        if method == "eth_uninstallFilter":
            return self._filters.pop(params[0], None) is not None
        if method == "eth_getTransactionReceipt":
            return self._receipt_json(bytes.fromhex(params[0][2:]))
        if method == "net_version":
            return str(self.chain_id)
        if method == "web3_clientVersion":
            return "eges-tpu/0.1.0"
        if method == "thw_register":
            # (ref: consensus/geec/api.go Register)
            if self.node is None:
                raise RpcError(-32000, "no consensus node")
            self.node.request_registration()
            return True
        if method == "thw_membership":
            if self.node is None:
                raise RpcError(-32000, "no consensus node")
            return [{"account": "0x" + m.addr.hex(), "ip": m.ip,
                     "port": m.port, "ttl": m.ttl,
                     "joinedBlock": m.joined_block}
                    for m in self.node.membership.members()]
        if method == "thw_status":
            if self.node is None:
                raise RpcError(-32000, "no consensus node")
            return {
                "height": self.chain.height(),
                "workingBlock": self.node.wb.blk_num,
                "maxConfirmed": self.node.max_confirmed_block,
                "registered": self.node.registered,
                "members": len(self.node.membership),
                "pendingGeecTxns": len(self.node.pending_geec_txns),
                "badBlocks": self.chain.bad_blocks,
            }
        if method == "thw_pendingGeecTxns":
            if self.node is None:
                raise RpcError(-32000, "no consensus node")
            return len(self.node.pending_geec_txns)
        if method == "thw_metrics":
            # process-wide observability snapshot (ref: the reference's
            # metrics registry + --metrics flag, metrics/metrics.go:25)
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            out = metrics.snapshot()
            # on-device verify share (BASELINE.md north star: > 95% of
            # secp256k1 verifies on the device).  Three row classes:
            # device (the facade's CUDA batches), native (C++ host batch
            # — still host work), and per-call host
            # fallbacks.  device_share counts DEVICE rows only;
            # batched_share is the routing share either batch path hits.
            def _rows(key):
                v = out.get(key, {})
                return v.get("count", 0) if isinstance(v, dict) else v

            dev = _rows("verifier.rows")
            native = _rows("verifier.native_rows")
            host = out.get("verifier.host_rows", 0)
            total = dev + native + host
            out["verifier.device_share"] = (
                round(dev / total, 4) if total else None)
            out["verifier.batched_share"] = (
                round((dev + native) / total, 4) if total else None)
            if self.txpool is not None:
                out["txpool"] = dict(self.txpool.stats,
                                     pending=len(self.txpool))
            from eges_tpu_torch.utils import tracing
            out["tracing"] = tracing.DEFAULT.stats()
            # the port's evidence that a card node's windows ran the
            # kernels and none was answered on the host: the scheduler's
            # stats (windows, host_diverted) and this process's kernel
            # launch counts (ops/kernels.py; absent where no kernel
            # module is loaded, so a native node never imports torch)
            sched_stats = getattr(self.chain.verifier, "stats", None)
            if callable(sched_stats):
                out["verifier.scheduler"] = sched_stats()
            import sys
            kmod = sys.modules.get("eges_tpu_torch.ops.kernels")
            if kmod is not None:
                out["kernels.launches"] = {
                    k: v for k, v in dict(kmod.LAUNCHES).items() if v}
            return out
        if method == "thw_traces":
            # finished spans from the in-process ring buffer, NEWEST
            # FIRST; params: [] | [limit] | [{"limit": n,
            # "trace": "<32-hex id>"}].  ``limit`` is clamped to
            # [1, 4096] so a long-running node can never ship its whole
            # span ring in one JSON-RPC reply.
            from eges_tpu_torch.utils import tracing
            limit, trace = 256, None
            if params:
                p = params[0]
                if isinstance(p, dict):
                    limit = int(p.get("limit", limit))
                    trace = p.get("trace")
                else:
                    limit = int(p)
            limit = clamp_rpc_limit(limit)
            spans = tracing.DEFAULT.finished(limit=limit, trace=trace)
            spans.reverse()
            return spans
        if method == "thw_health":
            return self._health()
        if method == "thw_journal":
            # consensus event journal, chronological, with the same
            # bounded pagination thw_traces has; params: [] | [limit] |
            # [{"limit": n, "since_seq": seq}].  ``limit`` is clamped to
            # [1, 4096] (matching thw_traces) so a long-running node can
            # never ship its whole ring in one reply; ``since_seq`` is
            # the cursor for incremental polling (events with
            # seq >= since_seq).  ``since`` stays as a legacy alias.
            if self.node is None:
                raise RpcError(-32000, "no consensus node")
            limit, since = 1024, 0
            if params:
                p = params[0]
                if isinstance(p, dict):
                    limit = int(p.get("limit", limit))
                    since = int(p.get("since_seq", p.get("since", since)))
                else:
                    limit = int(p)
            limit = clamp_rpc_limit(limit)
            return self.node.journal.events(limit=limit, since=since)
        if method == "thw_ledger":
            # ingress provenance snapshots (eges_tpu_torch/utils/ledger.py),
            # NEWEST FIRST like thw_traces; params: [] | [limit] |
            # [{"limit": n, "since_seq": seq}].  ``limit`` is clamped
            # to [1, 4096]; ``since_seq`` is the incremental-polling
            # cursor thw_journal uses (events with seq >= since_seq).
            if self.node is None:
                raise RpcError(-32000, "no consensus node")
            limit, since = 256, 0
            if params:
                p = params[0]
                if isinstance(p, dict):
                    limit = int(p.get("limit", limit))
                    since = int(p.get("since_seq", since))
                else:
                    limit = int(p)
            limit = clamp_rpc_limit(limit)
            evs = [e for e in self.node.journal.events(since=since)
                   if e.get("type") == "ingress_ledger"]
            evs = evs[-limit:]
            evs.reverse()
            return evs
        if method == "thw_flight":
            # verifier window flight recorder (crypto/scheduler.py),
            # NEWEST FIRST like thw_traces; params: [] | [limit] |
            # [{"limit": n}].  Empty when the chain has no scheduler
            # (host-fallback verifier) or no window flew yet.
            limit = 256
            if params:
                p = params[0]
                if isinstance(p, dict):
                    limit = int(p.get("limit", limit))
                else:
                    limit = int(p)
            limit = clamp_rpc_limit(limit)
            recorder = getattr(self.chain, "verifier", None)
            flights = getattr(recorder, "flights", None)
            if not callable(flights):
                return []
            out = flights(limit=limit)
            out.reverse()
            return out
        if method == "thw_profile":
            # continuous-profiler report snapshots (utils/profiler.py):
            # per-phase/per-role sample deltas + top self-time rows,
            # NEWEST FIRST like thw_flight; params: [] | [limit] |
            # [{"limit": n}].  Empty when the plane is disabled
            # (EGES_PROFILE_HZ=0) or no snapshot interval elapsed yet.
            from eges_tpu_torch.utils import profiler as profiler_mod
            limit = 64
            if params:
                p = params[0]
                if isinstance(p, dict):
                    limit = int(p.get("limit", limit))
                else:
                    limit = int(p)
            limit = clamp_rpc_limit(limit)
            out = profiler_mod.DEFAULT.snapshots(limit=limit)
            out.reverse()
            return out
        if method == "thw_devices":
            # device-efficiency delta snapshots (utils/devstats.py):
            # per-device window/row/waste counts with per-bucket split,
            # NEWEST FIRST like thw_profile; params: [] | [limit] |
            # [{"limit": n}].  Empty until a scheduler window has been
            # recorded and a snapshot taken.
            from eges_tpu_torch.utils import devstats as devstats_mod
            limit = 64
            if params:
                p = params[0]
                if isinstance(p, dict):
                    limit = int(p.get("limit", limit))
                else:
                    limit = int(p)
            limit = clamp_rpc_limit(limit)
            out = devstats_mod.DEFAULT.snapshots(limit=limit)
            out.reverse()
            return out
        if method == "thw_device_trace":
            # arm an on-demand torch.profiler device trace spanning the
            # next N recorded windows (utils/devstats.py); the capture
            # lands as a versioned device_trace.NNN artifact next to
            # profile.folded.  params: [] | [windows] |
            # [{"windows": n, "dir": path, "disarm": true}]; the window
            # count clamps to [1, 4096] like every list limit.  Safe
            # without a card — the armer reports an error state instead
            # of tracing.
            from eges_tpu_torch.utils import devstats as devstats_mod
            armer = devstats_mod.DEFAULT.trace
            windows, outdir = 4, None
            if params:
                p = params[0]
                if isinstance(p, dict):
                    if p.get("disarm"):
                        return armer.disarm()
                    windows = int(p.get("windows", windows))
                    outdir = p.get("dir")
                else:
                    windows = int(p)
            windows = clamp_rpc_limit(windows)
            return armer.arm(windows, outdir=outdir)
        if method.startswith("debug_"):
            return self._debug(method, params)
        raise RpcError(-32601, f"method {method} not found")

    # -- node health (thw_health) -----------------------------------------

    def _health(self) -> dict:
        """One-call cluster-operator snapshot: chain head + confirm lag,
        the node's current consensus role, election win/loss tallies,
        queue depths, membership economy, and a stall flag (no commit
        for 3 block timeouts).  ``harness/observatory.py`` polls this on
        every node; keys here are the documented contract its tests
        assert."""
        node = self.node
        if node is None:
            raise RpcError(-32000, "no consensus node")
        height = self.chain.height()
        blk_num = node.wb.blk_num
        # role: what this node is for the CURRENT working block
        from eges_tpu_torch.consensus.node import BACKOFF, ELECTING, VALIDATING
        if node._phase == ELECTING:
            role = "electing"
        elif node._phase in (VALIDATING, BACKOFF):
            role = "sealing"
        elif not node.registered or node.coinbase not in node.membership:
            role = "observer"
        elif node.is_committee(blk_num, node.wb.max_version):
            role = "committee"
        elif node.is_acceptor(blk_num):
            role = "acceptor"
        else:
            role = "follower"
        members = node.membership.members()
        last_commit_age = node.clock.now() - node._last_commit_t
        return {
            "height": height,
            "headHash": "0x" + self.chain.head().hash.hex(),
            "lag": max(0, node.max_confirmed_block - height),
            "role": role,
            "electionsWon": node.elections_won,
            "electionsLost": node.elections_lost,
            "txpoolPending": len(self.txpool) if self.txpool is not None
            else 0,
            "deferredDepth": len(node._deferred),
            "members": len(members),
            "minTtl": min((m.ttl for m in members), default=0),
            "lastCommitAge": round(last_commit_age, 6),
            "stalled": last_commit_age > 3 * node.cfg.block_timeout_s,
            "journal": node.journal.stats(),
            # latest SLO alert state per objective from the node-local
            # burn-rate engine (harness/slo.py), attached by the service
            # when telemetry push is enabled; {} when not running
            "sloAlerts": (engine.alert_states()
                          if (engine := getattr(node, "slo_engine",
                                                None)) is not None
                          else {}),
            # continuous sampling profiler: rate, sample volume, loss,
            # and the self-cost estimate the <5% overhead guard pins
            "profiler": _profiler_stats(),
            # device-efficiency ledger: window/row volume, cumulative
            # goodput ratio, and the on-demand trace armer state
            "devstats": _devstats_stats(),
        }

    # -- read-only EVM execution (ref: internal/ethapi/api.go Call) -------

    def _call_raw(self, obj: dict, tag) -> tuple[bytes, int]:
        from eges_tpu_torch.core.evm import EVM
        from eges_tpu_torch.core.state import block_ctx

        st = self._state_for(tag)
        blk = self._resolve_block(tag)
        sender = (bytes.fromhex(obj["from"][2:]) if obj.get("from")
                  else bytes(20))
        to = bytes.fromhex(obj["to"][2:]) if obj.get("to") else None
        data = bytes.fromhex(obj.get("data", "0x")[2:])
        value = int(obj.get("value", "0x0"), 16)
        gas = int(obj.get("gas", "0x1c9c380"), 16)  # default 30M
        e = EVM(st.copy(), block_ctx(blk.header),
                verifier=self.chain.verifier)
        if to is None:
            res = e.create(sender, value, data, gas, st.nonce(sender))
        else:
            res = e.call(sender, to, value, data, gas)
        if not res.success and res.output:
            raise RpcError(-32000, "execution reverted: 0x"
                           + res.output.hex())
        if not res.success:
            raise RpcError(-32000, "execution failed (out of gas?)")
        from eges_tpu_torch.core.evm import intrinsic_gas
        return res.output, intrinsic_gas(data, to is None) + res.gas_used

    def _eth_call(self, obj: dict, tag) -> str:
        out, _ = self._call_raw(obj, tag)
        return "0x" + out.hex()

    def _estimate_gas(self, obj: dict, tag) -> int:
        """Binary-search the smallest sufficient gas limit (the 63/64
        call-gas rule means measured usage at a high limit can be too
        little to actually run — ref: internal/ethapi/api.go
        DoEstimateGas's binary search)."""
        from eges_tpu_torch.core.evm import intrinsic_gas

        _, used = self._call_raw(obj, tag)  # raises if it cannot run at cap
        lo, hi = used, max(used, int(obj.get("gas", "0x1c9c380"), 16))
        intr = intrinsic_gas(bytes.fromhex(obj.get("data", "0x")[2:]),
                             not obj.get("to"))

        def runs(limit: int) -> bool:
            # a txn with gas_limit=limit gives the EVM (limit - intrinsic)
            trial = dict(obj, gas=hex(max(limit - intr, 0)))
            try:
                self._call_raw(trial, tag)
                return True
            except RpcError:
                return False

        if runs(lo):
            return lo
        if not runs(hi):
            # even the cap cannot execute it as a txn (intrinsic tax +
            # 63/64 rule); geth errors the same way
            raise RpcError(-32000, "gas required exceeds allowance")
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if runs(mid):
                hi = mid
            else:
                lo = mid
        return hi

    # -- gas oracle (ref: eth/gasprice/gasprice.go SuggestPrice) ----------

    def _gas_price(self) -> int:
        prices = []
        h = self.chain.height()
        for n in range(h, max(0, h - 20), -1):
            blk = self.chain.get_block_by_number(n)
            if blk is None:
                continue
            prices.extend(t.gas_price for t in blk.transactions
                          if not t.is_geec)
        if not prices:
            return 1
        prices.sort()
        return max(1, prices[len(prices) // 2])

    # -- log filters (ref: eth/filters/filter.go + filter_system.go) ------

    def _match_log(self, log, addresses, topics) -> bool:
        """``topics`` entries are pre-parsed byte-sets (or None)."""
        addr, ltopics, _ = log
        if addresses and addr not in addresses:
            return False
        for i, want in enumerate(topics):
            if want is None:
                continue
            if i >= len(ltopics) or ltopics[i] not in want:
                return False
        return True

    def _bloom_skip(self, header, addresses, topics) -> bool:
        """True when the header bloom PROVES no log can match (the
        bloombits-index role, ref: core/bloombits/ + eth/filters
        bloomFilter); false positives fall through to the receipt scan."""
        from eges_tpu_torch.core.state import bloom_may_contain

        if header.bloom == bytes(256):
            return bool(addresses or any(t is not None for t in topics))
        if addresses and not any(bloom_may_contain(header.bloom, a)
                                 for a in addresses):
            return True
        for want in topics:
            if want is not None and not any(
                    bloom_may_contain(header.bloom, t) for t in want):
                return True
        return False

    def _logs_in_range(self, from_n: int, to_n: int, addresses,
                       topics) -> list:
        """Logs matching a filter over ``[from_n, to_n]``.

        Candidate blocks come from the chain's sectioned bloom index
        (3 index rows per filter value, ref core/bloombits role) — not
        a header walk; unindexed gaps (old stores) fall back to the
        linear header-bloom scan.  Index false positives are filtered
        by the per-header bloom, then the receipts themselves."""
        from_n = max(0, from_n)
        if to_n < from_n:
            return []
        idx = getattr(self.chain, "bloom_index", None)
        if idx is None:
            numbers, gaps = [], [(from_n, to_n)]
        else:
            numbers, gaps = idx.candidates(from_n, to_n, addresses, topics)
        for lo, hi in gaps:
            numbers.extend(range(lo, hi + 1))  # bounded-by: hi <= to_n <= chain.height() (clamped in _parse_filter)
        out = []
        for n in sorted(numbers):
            blk = self.chain.get_block_by_number(n)
            if blk is None:
                continue
            if self._bloom_skip(blk.header, addresses, topics):
                continue
            receipts = self.chain.receipts_of(blk.hash)
            log_index = 0
            for ti, r in enumerate(receipts):
                for log in getattr(r, "logs", ()):
                    if self._match_log(log, addresses, topics):
                        addr, ltopics, data = log
                        out.append({
                            "address": "0x" + addr.hex(),
                            "topics": ["0x" + t.hex() for t in ltopics],
                            "data": "0x" + data.hex(),
                            "blockNumber": _hex(n),
                            "blockHash": "0x" + blk.hash.hex(),
                            "transactionHash":
                                "0x" + blk.transactions[ti].hash.hex(),
                            "transactionIndex": _hex(ti),
                            "logIndex": _hex(log_index),
                        })
                    log_index += 1
        return out

    def _parse_filter(self, obj: dict):
        def block_num(tag, default):
            if tag in (None, "latest", "pending"):
                return default
            if tag == "earliest":
                return 0
            return int(tag, 16)

        h = self.chain.height()
        from_n = block_num(obj.get("fromBlock"), h)
        # clamp to the canonical height: a far-future toBlock must not
        # size the block scan in _logs_in_range (eth_getLogs DoS vector)
        to_n = min(block_num(obj.get("toBlock"), h), h)
        addrs = obj.get("address")
        if isinstance(addrs, str):
            addrs = [addrs]
        addresses = {bytes.fromhex(a[2:]) for a in (addrs or [])}
        # pre-parse topic filters once (hex -> byte-sets); each position
        # is None (wildcard) or a set of acceptable topics
        topics = []
        for want in obj.get("topics", []):
            if want is None:
                topics.append(None)
            else:
                alts = want if isinstance(want, list) else [want]
                topics.append({bytes.fromhex(a[2:]) for a in alts})
        return from_n, to_n, addresses, topics

    def _get_logs(self, obj: dict) -> list:
        from_n, to_n, addresses, topics = self._parse_filter(obj)
        return self._logs_in_range(from_n, to_n, addresses, topics)

    FILTER_TTL_S = 300.0   # unpolled filters expire (geth's 5-min timeout)
    FILTER_MAX = 256       # hard cap on installed filters per node
    HTTP_MAX_BODY = 16 * 1024 * 1024  # request-body cap (matches the WS cap)

    def _expire_filters(self) -> None:
        import time

        now = time.monotonic()
        for fid in [k for k, f in self._filters.items()
                    if now - f["touched"] > self.FILTER_TTL_S]:
            del self._filters[fid]
        while len(self._filters) > self.FILTER_MAX:
            oldest = min(self._filters, key=lambda k:
                         self._filters[k]["touched"])
            del self._filters[oldest]

    def _new_filter(self, method: str, obj: dict) -> str:
        import time

        self._expire_filters()
        self._filter_seq += 1
        fid = _hex(self._filter_seq)
        self._filters[fid] = {  # bounded-by: FILTER_MAX (_expire_filters above)
            "kind": "logs" if method == "eth_newFilter" else "blocks",
            "obj": obj,
            "last": self.chain.height(),
            "touched": time.monotonic(),
        }
        return fid

    def _filter_changes(self, fid: str):
        import time

        self._expire_filters()
        f = self._filters.get(fid)
        if f is None:
            raise RpcError(-32000, "filter not found")
        f["touched"] = time.monotonic()
        h = self.chain.height()
        start, f["last"] = f["last"] + 1, h
        if start > h:
            return []
        if f["kind"] == "blocks":
            out = []
            for n in range(start, h + 1):
                blk = self.chain.get_block_by_number(n)
                if blk is not None:
                    out.append("0x" + blk.hash.hex())
            return out
        from_n, to_n, addresses, topics = self._parse_filter(f["obj"])
        # honor the filter's own explicit block bounds (absent/"latest"
        # bounds mean "everything new since install"); a toBlock in the
        # past means no new logs can ever match
        explicit = lambda tag: tag not in (None, "latest", "pending")
        lo = max(start, from_n) if explicit(f["obj"].get("fromBlock")) \
            else start
        hi = min(h, to_n) if explicit(f["obj"].get("toBlock")) else h
        if lo > hi:
            return []
        return self._logs_in_range(lo, hi, addresses, topics)

    def _debug(self, method: str, params: list):
        """Runtime debug namespace (ref: internal/debug/api.go —
        StartCPUProfile/StopCPUProfile/Stacks/MemStats roles)."""
        from eges_tpu_torch.utils.debug import DebugController

        if not hasattr(self, "_debug_ctl"):
            self._debug_ctl = DebugController()
        if method == "debug_startProfile":
            return self._debug_ctl.start_profile()
        if method == "debug_stopProfile":
            return self._debug_ctl.stop_profile(
                int(params[0]) if params else 30)
        if method == "debug_stacks":
            return self._debug_ctl.stacks()
        if method == "debug_stats":
            return self._debug_ctl.stats()
        if method == "debug_traceTransaction":
            return self._trace_transaction(params[0], *params[1:2])
        raise RpcError(-32601, f"method {method} not found")

    def _trace_transaction(self, txh_hex: str, config: dict | None = None):
        """Replay a mined transaction against its parent state with the
        struct-log tracer attached (ref: eth/tracers/tracer.go +
        internal/ethapi TraceTransaction): preceding txns of the block
        re-execute untraced to reconstruct the exact pre-state, then the
        target runs with per-opcode capture."""
        from eges_tpu_torch.core.state import apply_txn, block_ctx, recover_senders
        from eges_tpu_torch.core.tracer import (
            CallTracer, FourByteTracer, PrestateTracer, StructLogTracer,
        )

        found = self.chain.lookup_txn(bytes.fromhex(txh_hex[2:]))
        if found is None:
            raise RpcError(-32000, "transaction not found")
        blk, index, _receipt = found
        parent_state = self.chain.state_at(blk.header.parent_hash)
        if parent_state is None:
            raise RpcError(-32000, "parent state pruned; restart replays "
                                   "it or trace a more recent transaction")
        senders = recover_senders(blk.transactions, self.chain.verifier)
        state = parent_state.copy()
        ctx = block_ctx(blk.header)
        gas = 0
        for i in range(index):  # bounded-by: index < len(blk.transactions) (lookup_txn invariant)
            r = apply_txn(state, blk.transactions[i], senders[i],
                          blk.header.coinbase, gas, ctx=ctx,
                          verifier=self.chain.verifier)
            gas = r.cumulative_gas_used
        # named tracers (the bundled-tracer surface of the reference,
        # eth/tracers/internal/tracers/*.js selected via config.tracer;
        # native Python here — see core/tracer.py design note)
        name = (config or {}).get("tracer", "")
        if name == "callTracer":
            tracer = CallTracer()
        elif name == "prestateTracer":
            # the traced txn runs on a COPY so ``state`` stays the
            # untouched pre-state reference the tracer reads from
            tracer = PrestateTracer(state, coinbase=blk.header.coinbase)
            state = state.copy()
        elif name == "4byteTracer":
            tracer = FourByteTracer()
        elif name:
            raise RpcError(-32602, f"unknown tracer {name!r}; built-ins: "
                                   "callTracer, prestateTracer, "
                                   "4byteTracer (custom tracers are "
                                   "Python FrameTracer subclasses, not "
                                   "JS — core/tracer.py)")
        else:
            tracer = StructLogTracer(
                with_stack=not (config or {}).get("disableStack", False))
        r = apply_txn(state, blk.transactions[index], senders[index],
                      blk.header.coinbase, gas, ctx=ctx,
                      verifier=self.chain.verifier, tracer=tracer)
        return tracer.result(gas_used=r.cumulative_gas_used - gas,
                             failed=r.status == 0, output=b"")

    # -- JSON-RPC plumbing ------------------------------------------------

    def _handle_body(self, body: bytes) -> bytes:  # ingress-entry:bounded
        try:
            req = json.loads(body)
        except json.JSONDecodeError:
            return json.dumps({"jsonrpc": "2.0", "id": None,
                               "error": {"code": -32700,
                                         "message": "parse error"}}).encode()
        batch = isinstance(req, list)
        reqs = req if batch else [req]
        out = []
        for r in reqs:
            rid = r.get("id")
            try:
                result = self.dispatch(r.get("method", ""),
                                       r.get("params", []) or [])
                out.append({"jsonrpc": "2.0", "id": rid, "result": result})
            except RpcError as e:
                out.append({"jsonrpc": "2.0", "id": rid,
                            "error": {"code": e.code, "message": e.message}})
            except Exception as e:  # robustness: malformed params etc.
                out.append({"jsonrpc": "2.0", "id": rid,
                            "error": {"code": -32603, "message": str(e)}})
        return json.dumps(out if batch else out[0]).encode()

    async def _handle_conn(self, reader: asyncio.StreamReader,  # ingress-entry
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                # minimal HTTP/1.1 request parsing
                line = await reader.readline()
                if not line:
                    break
                try:
                    http_method, path, _ = \
                        line.decode("latin-1").split(" ", 2)
                except ValueError:
                    http_method, path = "POST", "/"
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                if headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_ws(reader, writer, headers)
                    return
                length = int(headers.get("content-length", 0))
                if length > self.HTTP_MAX_BODY:
                    # refuse before buffering anything: the client's
                    # declared content-length must not size the read
                    writer.write(
                        b"HTTP/1.1 413 Payload Too Large\r\n"
                        b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                    await writer.drain()
                    break
                body = await reader.readexactly(length) if length else b""
                if http_method == "GET":
                    # Prometheus scrape endpoint; everything else 404s
                    if path.split("?", 1)[0] == "/metrics":
                        from eges_tpu_torch.utils.metrics import prometheus_text
                        resp = prometheus_text().encode()
                        writer.write(
                            b"HTTP/1.1 200 OK\r\nContent-Type: text/plain; "
                            b"version=0.0.4; charset=utf-8\r\n"
                            + f"Content-Length: {len(resp)}\r\n".encode()
                            + b"Connection: keep-alive\r\n\r\n" + resp)
                    else:
                        writer.write(
                            b"HTTP/1.1 404 Not Found\r\n"
                            b"Content-Length: 0\r\n"
                            b"Connection: keep-alive\r\n\r\n")
                    await writer.drain()
                    continue
                resp = self._handle_body(body)
                writer.write(
                    b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                    + f"Content-Length: {len(resp)}\r\n".encode()
                    + b"Connection: keep-alive\r\n\r\n" + resp)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            writer.close()

    # -- WebSocket transport + eth_subscribe push (ref: rpc/websocket.go
    # + eth/filters/filter_system.go subscription events) ----------------

    @staticmethod
    def _ws_frame(payload: bytes, opcode: int = 1) -> bytes:
        n = len(payload)
        head = bytes([0x80 | opcode])
        if n < 126:
            head += bytes([n])
        elif n < 1 << 16:
            head += bytes([126]) + n.to_bytes(2, "big")
        else:
            head += bytes([127]) + n.to_bytes(8, "big")
        return head + payload

    @staticmethod
    async def _ws_read_raw(reader) -> tuple[int, int, bytes] | None:
        try:
            h = await reader.readexactly(2)
        except asyncio.IncompleteReadError:
            return None
        fin = h[0] & 0x80
        opcode = h[0] & 0x0F
        masked = h[1] & 0x80
        n = h[1] & 0x7F
        if n == 126:
            n = int.from_bytes(await reader.readexactly(2), "big")
        elif n == 127:
            n = int.from_bytes(await reader.readexactly(8), "big")
        if n > 16 * 1024 * 1024:
            return None
        mask = await reader.readexactly(4) if masked else b""
        data = await reader.readexactly(n)
        if masked:
            data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        return fin, opcode, data

    async def _ws_read_frame(self, reader) -> tuple[int, bytes] | None:
        """One complete MESSAGE: reassembles fragmented frames (FIN=0
        text/binary + opcode-0 continuations); control frames interleave
        and are returned as-is."""
        buf = b""
        first_opcode = None
        while True:
            raw = await self._ws_read_raw(reader)
            if raw is None:
                return None
            fin, opcode, data = raw
            if opcode >= 8:  # control frames never fragment
                return opcode, data
            if first_opcode is None:
                first_opcode = opcode or 1
            buf += data
            if len(buf) > 16 * 1024 * 1024:
                return None
            if fin:
                return first_opcode, buf

    async def _handle_ws(self, reader, writer, headers: dict) -> None:  # ingress-entry
        import base64
        import hashlib

        key = headers.get("sec-websocket-key", "")
        accept = base64.b64encode(hashlib.sha1(
            (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()
        ).digest()).decode()
        writer.write((
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
        await writer.drain()

        subs: dict[str, dict] = {}  # sub id -> {"kind", "obj"}
        self._ws_conns.append((writer, subs))
        try:
            while True:
                frame = await self._ws_read_frame(reader)
                if frame is None:
                    break
                opcode, data = frame
                if opcode == 8:  # close
                    break
                if opcode == 9:  # ping -> pong
                    writer.write(self._ws_frame(data, opcode=10))
                    await writer.drain()
                    continue
                if opcode not in (1, 2):
                    continue
                try:
                    req = json.loads(data)
                except ValueError:
                    continue
                method = req.get("method", "")
                params = req.get("params", []) or []
                rid = req.get("id")
                try:
                    if method == "eth_subscribe":
                        if not params:
                            raise RpcError(-32602, "missing subscription kind")
                        kind = params[0]
                        if kind not in ("newHeads", "logs"):
                            raise RpcError(-32602, f"unsupported: {kind}")
                        obj = params[1] if len(params) > 1 else {}
                        if kind == "logs":
                            try:  # validate ONCE here, not on every push
                                self._parse_filter(obj)
                            except Exception:
                                raise RpcError(-32602, "invalid log filter")
                        self._filter_seq += 1
                        sid = _hex(self._filter_seq)
                        subs[sid] = {"kind": kind, "obj": obj}
                        result = sid
                    elif method == "eth_unsubscribe":
                        if not params:
                            raise RpcError(-32602, "missing subscription id")
                        result = subs.pop(params[0], None) is not None
                    else:
                        result = self.dispatch(method, params)
                    out = {"jsonrpc": "2.0", "id": rid, "result": result}
                except RpcError as e:
                    out = {"jsonrpc": "2.0", "id": rid,
                           "error": {"code": e.code, "message": e.message}}
                except Exception as e:  # malformed params must not kill
                    out = {"jsonrpc": "2.0", "id": rid,  # the connection
                           "error": {"code": -32603, "message": str(e)}}
                writer.write(self._ws_frame(json.dumps(out).encode()))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            self._ws_conns = [(w, s) for w, s in self._ws_conns
                              if w is not writer]
            writer.close()

    def _on_block_for_ws(self, block) -> None:
        """Chain listener: push newHeads/logs notifications to every
        subscribed WS connection (fire-and-forget writes on the shared
        event loop)."""
        if not self._ws_conns:
            return
        head_json = None
        for writer, subs in list(self._ws_conns):
            for sid, sub in subs.items():
                try:
                    if sub["kind"] == "newHeads":
                        if head_json is None:
                            head_json = _block_json(block, False)
                        result = head_json
                    else:
                        from_n = to_n = block.number
                        _, _, addrs, topics = self._parse_filter(sub["obj"])
                        logs = self._logs_in_range(from_n, to_n, addrs,
                                                   topics)
                        if not logs:
                            continue
                        result = logs
                    msg = {"jsonrpc": "2.0", "method": "eth_subscription",
                           "params": {"subscription": sid,
                                      "result": result}}
                    transport = writer.transport
                    if (transport is not None and
                            transport.get_write_buffer_size() > 4 << 20):
                        # a subscriber that stopped reading must not grow
                        # our buffers without bound: drop it
                        writer.close()
                        continue
                    writer.write(self._ws_frame(json.dumps(msg).encode()))
                # analysis: allow-swallow(dead subscriber; reaped on next pass)
                except Exception:
                    pass

    IPC_LIMIT = 16 * 1024 * 1024  # max request line (large raw txns)

    async def _handle_ipc(self, reader: asyncio.StreamReader,  # ingress-entry
                          writer: asyncio.StreamWriter) -> None:
        """IPC framing: newline-delimited raw JSON-RPC (no HTTP
        envelope), matching geth's geth.ipc convention."""
        try:
            while True:
                try:
                    line = await reader.readline()
                except ValueError:
                    # over-limit request: answer with a JSON-RPC error
                    # instead of silently dropping the connection
                    writer.write(json.dumps({
                        "jsonrpc": "2.0", "id": None,
                        "error": {"code": -32600,
                                  "message": "request too large"},
                    }).encode() + b"\n")
                    await writer.drain()
                    break
                if not line:
                    break
                writer.write(self._handle_body(line) + b"\n")
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def start(self, ipc_path: str | None = None) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.bind_ip, self.port)
        if ipc_path:
            import os
            import socket as _socket
            if os.path.exists(ipc_path):
                # refuse to sever a LIVE endpoint (a second node on the
                # same datadir); only clear stale leftover sockets
                probe = _socket.socket(_socket.AF_UNIX)
                try:
                    probe.settimeout(0.5)
                    probe.connect(ipc_path)
                    probe.close()
                    raise RpcError(
                        -32000, f"ipc endpoint {ipc_path} is in use "
                                "(another node on this datadir?)")
                except (ConnectionRefusedError, FileNotFoundError, OSError):
                    probe.close()
                    try:
                        os.unlink(ipc_path)
                    except FileNotFoundError:
                        pass
            self._ipc_server = await asyncio.start_unix_server(
                self._handle_ipc, path=ipc_path, limit=self.IPC_LIMIT)
            self._ipc_path = ipc_path

    def close(self) -> None:
        self.chain.remove_listener(self._on_block_for_ws)
        if self._server is not None:
            self._server.close()
        if getattr(self, "_ipc_server", None) is not None:
            self._ipc_server.close()
            import os
            try:
                os.unlink(self._ipc_path)
            except OSError:
                pass
