"""Node service container: the ``geth``-process equivalent.

The port's copy of ``eges_tpu/node/service.py``: the ``"torch"``
verifier mode takes the place of ``"jax"`` — the port's
``default_verifier`` on ``verifier_device`` (the card unless the
caller asks for the CPU) behind ``scheduler_for``, which over it serves
no row from the host model, warmed through the artifact store
(``crypto/aotstore.py``: the kernel library, not serialized graphs).
``"jax"`` is refused.  The optional ``harness.slo`` hook is absent (the
reference's own behaviour without its harness).

Assembles a full Geec node from a genesis file + flags (the role of
node.Node + eth.New, ref: node/node.go:138, eth/backend.go:105-185):
durable chain over a datadir FileStore, the consensus state machine,
both network planes, the UDP txn-ingest service, and the device batch
verifier — then runs the asyncio loop.
"""

from __future__ import annotations

import asyncio
import json
import os
from dataclasses import dataclass

from eges_tpu_torch.consensus.config import ChainGeecConfig, NodeConfig
from eges_tpu_torch.consensus.node import GeecNode
from eges_tpu_torch.core.chain import BlockChain, FileStore, make_genesis
from eges_tpu_torch.crypto import secp256k1 as secp
from eges_tpu_torch.ingress import direct_sink, gossip_sink, txn_sink
from eges_tpu_torch.net.transports import (
    AsyncioClock, DirectPlane, GeecTxnService, GossipPlane, SocketTransport,
)
from eges_tpu_torch.utils.log import get_logger


@dataclass
class ServiceConfig:
    datadir: str
    genesis_path: str
    key_hex: str                       # 32-byte private key (hex)
    gossip_ip: str = "127.0.0.1"
    gossip_port: int = 6190
    peers: tuple[tuple[str, int], ...] = ()  # static gossip peer list
    node: NodeConfig = None            # Geec knobs (coinbase filled in)
    mine: bool = True
    verbosity: int = 3
    use_device_verifier: bool = True   # device batch verify on acceptors
    verifier_mode: str = ""            # "" -> "torch" if
    #                                    use_device_verifier else "none";
    #                                    "native" = C++ batch verifier
    #                                    (no torch launch — for hosts
    #                                    without a card)
    verifier_device: str = "cuda"      # the "torch" mode's device: the
    #                                    card, or "cpu" for the plain
    #                                    versions of the kernels (tests)
    rpc_port: int = 0                  # 0 = RPC disabled
    net_secret_hex: str = ""           # gossip-plane auth secret; ""
    #                                    derives one from the genesis hash
    checkpoint_every: int = 256        # durable state-checkpoint cadence
    #                                    (blocks): every Nth commit writes
    #                                    a snapshot sidecar into the
    #                                    datadir so a restart replays only
    #                                    the tail past it; 0 disables.
    #                                    An explicit NodeConfig value
    #                                    overrides this service default.
    plaintext_gossip: bool = False     # disable the auth layer entirely
    allow_v1_peers: bool = False       # accept legacy v1 (symmetric)
    #                                    hellos on keyed nodes — mixed-
    #                                    mode upgrades only; bypasses
    #                                    per-peer identity, so never on
    #                                    by default
    allow_v2_peers: bool = False       # accept MAC-only (unencrypted)
    #                                    v2 hellos on v3 nodes — mixed-
    #                                    mode upgrades only; loses
    #                                    confidentiality on those links
    gossip_version: int = 3            # pin the plane's generation
    #                                    (2 = MAC-only, for staged
    #                                    upgrades of a running network)
    gossip_allowlist: tuple[str, ...] = ()  # hex addresses; when set,
    #                                    gossip connections are admitted
    #                                    only for peers whose handshake
    #                                    identity is listed here OR is a
    #                                    current member — the membership
    #                                    gate the v2 handshake's
    #                                    peer_addr exists to serve
    bootnodes: tuple[tuple[str, int], ...] = ()  # discovery; makes
    #                                    --peers optional (ref:
    #                                    p2p/discover + cmd/bootnode)
    nat: str = "none"                  # advertised-address policy for
    #                                    discovery announces: none /
    #                                    auto / extip:<ip> (ref:
    #                                    p2p/nat/nat.go Parse)
    collector_addr: str = ""           # host:port of a telemetry
    #                                    collector (harness/collector.py
    #                                    CollectorServer); enables the
    #                                    push plane: journal tail +
    #                                    periodic telemetry_sample
    #                                    envelopes over TCP, replacing
    #                                    per-node /metrics polling for
    #                                    cluster views
    telemetry_interval_s: float = 5.0  # push cadence when enabled


def load_genesis_config(path: str) -> tuple[ChainGeecConfig, dict]:
    """Parse the genesis JSON's ``config.thw`` section
    (ref: params/config.go:124, core/genesis.go SetupGenesisBlock)."""
    with open(path) as f:
        doc = json.load(f)
    thw = doc.get("config", {}).get("thw", {})
    return ChainGeecConfig.from_json(thw), doc


class _TelemetryPusher:
    """Push plane for a real node: samples the process metrics registry
    on the wall clock, tails the consensus journal through its
    ``on_record`` tap, and ships newline-JSON envelopes to a
    ``harness/collector.py`` CollectorServer.  The reference attaches
    a node-local ``harness.slo.SLOEngine`` here when its harness is
    installed; the port has none yet, so ``engine`` stays ``None``.

    Delivery is best-effort telemetry, not a durability channel: when
    the collector is unreachable the envelope for that tick is dropped
    and the connection is retried on the next one.
    """

    def __init__(self, node, addr: tuple[str, int], *,
                 interval_s: float = 5.0, log=None):
        import time as _t
        from collections import deque

        from eges_tpu_torch.utils.metrics import DEFAULT as registry
        from eges_tpu_torch.utils.timeseries import RegistrySampler
        self.node = node
        self.addr = addr
        self.interval_s = interval_s
        self.log = log
        self.sampler = RegistrySampler(registry, clock=_t.time)
        # journal tail: the tap enqueues every event as it is recorded,
        # so a drain (journal.dump) between ticks cannot lose envelopes
        # bounded deque shared tap->tick: append/popleft are GIL-atomic,
        # so the journal-writer and service-loop roles need no lock
        self._pending = deque(maxlen=8192)  # guarded-by: gil-atomic-deque
        self._prev_tap = node.journal.on_record
        node.journal.on_record = self._tap
        self._sock = None
        self.engine = None

    def _tap(self, ev: dict) -> None:  # thread-entry:journal-writer
        self._pending.append(ev)
        prev = self._prev_tap
        if prev is not None:
            prev(ev)

    def tick(self) -> None:  # thread-entry:service-loop
        """Sample, journal the sample, evaluate the local SLO engine,
        and push the journal tail as one envelope."""
        # refresh HBM watermark gauges first (utils/devstats.py) so the
        # registry sample below carries them; absent on backends
        # without memory_stats()
        from eges_tpu_torch.utils import devstats as devstats_mod
        devstats_mod.sample_memory()
        payload = self.sampler.sample()
        sample = self.node.journal.record(
            "telemetry_sample", step=self.sampler.steps, metrics=payload)
        if sample is None:
            return  # journal disabled (restart replay)
        evs = []
        while self._pending:
            evs.append(self._pending.popleft())
        if self.engine is not None:
            for ev in evs:
                self.engine.ingest(ev)
            self.engine.evaluate(float(sample.get("ts", 0.0)))
        self._send({"node": str(sample.get("node", "?")),
                    "ts": sample.get("ts", 0.0), "events": evs})

    def _send(self, envelope: dict) -> None:
        import socket as _socket
        data = json.dumps(envelope).encode() + b"\n"
        try:
            if self._sock is None:
                self._sock = _socket.create_connection(
                    self.addr, timeout=2.0)
                self._sock.settimeout(2.0)
            self._sock.sendall(data)
        except OSError:
            # collector down/unreachable: drop this tick's envelope and
            # reconnect on the next one
            sock, self._sock = self._sock, None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass  # already torn down
            if self.log is not None:
                self.log.geec("telemetry push failed",
                              addr=f"{self.addr[0]}:{self.addr[1]}")

    def close(self) -> None:
        # one final push so the collector sees the tail, then restore
        # the tap chain and tear the socket down
        self.tick()
        self.node.journal.on_record = self._prev_tap
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass  # already closed


class NodeService:
    def __init__(self, cfg: ServiceConfig):
        self.cfg = cfg
        priv = bytes.fromhex(cfg.key_hex)
        self.coinbase = secp.pubkey_to_address(secp.privkey_to_pubkey(priv))
        self.log = get_logger(f"geec.{self.coinbase.hex()[:8]}",
                              cfg.verbosity)

        chain_cfg, genesis_doc = load_genesis_config(cfg.genesis_path)
        extra = genesis_doc.get("extraData", "") or "geec-genesis"
        if isinstance(extra, str):
            extra = extra.encode()
        genesis = make_genesis(
            extra=extra,
            time=int(genesis_doc.get("timestamp", "0x0"), 16)
            if isinstance(genesis_doc.get("timestamp"), str)
            else int(genesis_doc.get("timestamp", 0)))

        mode = cfg.verifier_mode or ("torch" if cfg.use_device_verifier
                                     else "none")
        verifier = None
        if mode == "torch":
            # the port's facade on the card (or the CPU's plain kernels
            # when asked for); it names its device in the
            # verifier.device_name gauge.  No host fallback: a node whose
            # kernels fail to build or launch fails its windows.
            from eges_tpu_torch.crypto.verifier import default_verifier
            verifier = default_verifier(cfg.verifier_device)
        elif mode == "native":
            from eges_tpu_torch.crypto.verify_host import NativeBatchVerifier
            verifier = NativeBatchVerifier()
        elif mode == "jax":
            raise ValueError("verifier mode 'jax' is the JAX package's; "
                             "the port's device verifier is 'torch'")
        elif mode != "none":
            raise ValueError(f"unknown verifier mode {mode!r}: "
                             "'torch', 'native' or 'none'")
        self._verifier_mode = mode
        # the coalescing scheduler + sender-recovery cache fronts the
        # device for every consumer below (chain body validation, the
        # consensus node's vote paths, the txpool flush): concurrent RPC
        # submissions and consensus checks merge into one device batch
        # per micro-window, and commit-time re-verification of gossiped
        # signatures becomes a cache hit
        self._raw_verifier = verifier
        if verifier is not None:
            from eges_tpu_torch.crypto.scheduler import scheduler_for
            verifier = scheduler_for(verifier)
            # a mesh verifier (default_verifier over >1 visible device)
            # turns the scheduler into the mesh dispatcher: one window
            # lane per device.  Surface the topology in the service log
            # so an operator can see the fan-out without scraping stats.
            lanes = verifier.stats()["lanes"]
            if lanes > 1:
                self.log.geec("verifier mesh dispatch enabled",
                              devices=lanes)

        os.makedirs(cfg.datadir, exist_ok=True)
        store = FileStore(os.path.join(cfg.datadir, "chaindata"))
        self.chain = BlockChain(store=store, genesis=genesis,
                                verifier=verifier)

        import dataclasses
        ncfg = dataclasses.replace(cfg.node or NodeConfig(),
                                   coinbase=self.coinbase,
                                   privkey=priv)
        if ncfg.checkpoint_every == 0 and cfg.checkpoint_every:
            # service-level durability default: periodic checkpoints
            # into the datadir unless the node config pinned a cadence
            ncfg = dataclasses.replace(
                ncfg, checkpoint_every=cfg.checkpoint_every)

        self.clock = AsyncioClock(asyncio.get_event_loop())
        self.node = GeecNode(self.chain, self.clock, None, ncfg, chain_cfg,
                             mine=cfg.mine, verifier=verifier,
                             log=self._node_log)

        self.direct = DirectPlane(ncfg.consensus_ip, ncfg.consensus_port,
                                  direct_sink(self.node))
        # gossip-plane auth secret (the RLPx role): operator-provided, or
        # derived from the genesis hash — isolating networks and blocking
        # casual frame injection even without an explicit secret
        if cfg.plaintext_gossip:
            secret = None
        elif cfg.net_secret_hex:
            secret = bytes.fromhex(cfg.net_secret_hex)
        else:
            from eges_tpu_torch.crypto.keccak import keccak256
            secret = keccak256(b"geec/net-secret" + genesis.hash)
        # ECDH per-connection keys (v3 handshake) whenever auth is on:
        # encrypted frames + session keys no other member can compute,
        # identity = node key.
        # With an allowlist configured, that identity feeds the
        # membership gate: a peer must be explicitly listed or already a
        # registered member (joiners register THROUGH an allowlisted
        # seed, so bootstrap still works).  Without one, the plane is
        # authenticated but open — any keyholder may connect.
        authorize = None
        if cfg.gossip_allowlist:
            # an allowlist only binds when every connection carries a v2
            # identity: plaintext mode never handshakes, and v1 hellos
            # have no identity — both would silently void the gate
            if cfg.plaintext_gossip:
                raise ValueError("--gossipAllowlist requires the auth "
                                 "layer; remove --plaintextGossip")
            if cfg.allow_v1_peers:
                raise ValueError("--gossipAllowlist is unenforceable for "
                                 "identity-less v1 peers; remove "
                                 "--allowV1Peers")
            allowed = set()
            for a in cfg.gossip_allowlist:
                raw = bytes.fromhex(a.removeprefix("0x"))
                if len(raw) != 20:
                    raise ValueError(f"allowlist entry {a!r} is not a "
                                     "20-byte address")
                allowed.add(raw)
            authorize = (lambda addr: addr in allowed
                         or addr in self.node.membership)
        # the gossip plane's protocol table (the eth/62+63 capability
        # split, ref: eth/protocol.go:38-44): consensus control msgs,
        # chain sync, and txn exchange negotiate independently, so a
        # future sync-v2 peer still exchanges geec msgs with a sync-v1
        # one.  All handlers funnel into the node's single-threaded
        # dispatch — the mux contributes negotiation + misbehavior
        # scoring, not concurrency.
        from eges_tpu_torch.consensus import messages as M
        from eges_tpu_torch.net.transports import Protocol
        gossip = gossip_sink(self.node)
        protocols = [
            Protocol("geec", (1,),
                     {M.GOSSIP_VALIDATE_REQ, M.GOSSIP_QUERY,
                      M.GOSSIP_REGISTER_REQ, M.GOSSIP_CONFIRM_BLOCK},
                     gossip),
            Protocol("sync", (1,),
                     {M.GOSSIP_GET_BLOCKS, M.GOSSIP_BLOCKS_REPLY,
                      M.GOSSIP_GET_HEADERS, M.GOSSIP_HEADERS_REPLY},
                     gossip),
            Protocol("txn", (1,), {M.GOSSIP_TXNS}, gossip),
        ]
        self.gossip = GossipPlane(cfg.gossip_ip, cfg.gossip_port,
                                  list(cfg.peers), gossip,
                                  secret=secret,
                                  keypair=(priv, secp.privkey_to_pubkey(priv)),
                                  allow_v1_peers=cfg.allow_v1_peers,
                                  allow_v2_peers=cfg.allow_v2_peers,
                                  version=cfg.gossip_version,
                                  authorize=authorize,
                                  protocols=protocols)
        self.node.transport = SocketTransport(self.gossip, self.direct)

        self.discovery = None
        if cfg.bootnodes:
            from eges_tpu_torch.net import nat as natlib
            from eges_tpu_torch.net.discovery import DiscoveryClient
            # announce the NAT-resolved address, bind the configured one
            adv_gip = natlib.resolve(cfg.nat, cfg.gossip_ip)
            adv_cip = natlib.resolve(cfg.nat, ncfg.consensus_ip)
            disc_eps: dict[bytes, tuple[str, int]] = {}

            def _on_disc_peer(addr, gep, cep):
                # a higher-seq record can re-home a peer: retire the
                # dial loop on the old endpoint before adding the new
                old = disc_eps.get(addr)
                if old is not None and old != gep:
                    self.gossip.remove_peer(old)
                disc_eps[addr] = gep
                self.gossip.add_peer(gep)

            self.discovery = DiscoveryClient(
                list(cfg.bootnodes), priv,
                adv_gip, cfg.gossip_port,
                adv_cip, ncfg.consensus_port,
                on_peer=_on_disc_peer)

        self.txn_service = None
        if ncfg.geec_txn_port:
            self.txn_service = GeecTxnService(
                ncfg.consensus_ip, ncfg.geec_txn_port, txn_sink(self.node))

        from eges_tpu_torch.core.txpool import TxPool
        self.txpool = TxPool(
            self.clock, verifier=verifier,
            journal_path=os.path.join(cfg.datadir, "transactions.rlp"))
        self.txpool.owner = self.coinbase.hex()[:8]
        loaded = self.txpool.load_journal()
        if loaded:
            self.log.geec("txpool journal", reloaded=loaded)
        self.node.txpool = self.txpool

        self.rpc = None
        if cfg.rpc_port:
            from eges_tpu_torch.rpc.server import RpcServer
            self.rpc = RpcServer(self.chain, node=self.node,
                                 txpool=self.txpool,
                                 bind_ip=cfg.gossip_ip, port=cfg.rpc_port)

        self._telemetry = None
        if cfg.collector_addr:
            host, _, port = cfg.collector_addr.rpartition(":")
            self._telemetry = _TelemetryPusher(
                self.node, (host or "127.0.0.1", int(port)),
                interval_s=cfg.telemetry_interval_s, log=self.log)

        self._height_task = None
        # the background warm of the larger buckets (a card node only)
        self._prewarm_thread = None

    def _node_log(self, kind: str, **kw) -> None:
        if kind == "breakdown":
            self.log.breakdown(kw.pop("phase", "?"), kw.pop("dt", 0.0), **kw)
        else:
            self.log.geec(kind, **kw)

    async def start(self) -> None:
        from eges_tpu_torch.utils.debug import install_sigusr1
        install_sigusr1()  # kill -USR1 dumps stacks (pprof-dump parity)
        # continuous sampling profiler (geth --pprof parity): always on
        # unless EGES_PROFILE_HZ=0; serves thw_profile/thw_health and
        # the periodic profile.folded dump below
        from eges_tpu_torch.utils import profiler as profiler_mod
        if profiler_mod.DEFAULT.start():
            self.log.geec("profiler started", hz=profiler_mod.DEFAULT.hz)
        # device-efficiency plane (utils/devstats.py): baseline the
        # process-wide goodput ledger at service start and point the
        # on-demand trace armer at the datadir, so thw_device_trace
        # captures land as device_trace.NNN next to profile.folded
        from eges_tpu_torch.utils import devstats as devstats_mod
        devstats_mod.DEFAULT.rebase()
        devstats_mod.DEFAULT.trace.dir = self.cfg.datadir
        if self._verifier_mode == "torch" and self._raw_verifier is not None \
                and self._raw_verifier.device.type == "cuda":
            # get the kernel library and run the smallest recover bucket
            # NOW: a first-ever nvcc build takes minutes, and letting it
            # happen lazily inside a consensus message handler wedges
            # the event loop mid-election.  The warm goes through the
            # artifact store: a node whose checkout has built before
            # opens its build directory's library, one in a new checkout
            # loads the stored library in a fraction of a second, and a
            # first-ever build leaves an artifact behind for the next
            # checkout.  The next few buckets warm on a background
            # thread — off the critical path, so the first non-trivial
            # block doesn't stall either.  The CPU's plain kernels have
            # no library and nothing to warm.
            import time as _t

            from eges_tpu_torch.crypto.aotstore import default_store
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics

            store = default_store()
            t0 = _t.monotonic()
            info = self._raw_verifier.aot_prewarm(buckets=(16,),
                                                  store=store)
            cold = round(_t.monotonic() - t0, 3)
            metrics.gauge("verifier.cold_start_seconds").set(cold)
            metrics.gauge("verifier.aot_library").set(info["library"])
            self.log.geec("verifier warmup", dt=cold,
                          library=info["library"],
                          aot_loads=info["aot_loads"],
                          aot_compiles=info["aot_compiles"])
            self.node.journal.record(
                "verifier_aot_load", buckets=info["buckets"],
                aot_loads=info["aot_loads"],
                aot_compiles=info["aot_compiles"],
                load_s=round(info["load_s"], 3),
                compile_s=round(info["compile_s"], 3),
                cold_start_s=cold, device_kind=info["device_kind"],
                library=info["library"])
            self._prewarm_thread = self._raw_verifier.aot_prewarm(
                buckets=(32, 64, 128), store=store, background=True)
        await self.direct.start()
        await self.gossip.start()
        if self.discovery is not None:
            await self.discovery.start()
        if self.txn_service is not None:
            await self.txn_service.start()
        if self.rpc is not None:
            # HTTP + the geth.ipc-convention unix socket in the datadir
            await self.rpc.start(
                ipc_path=os.path.join(self.cfg.datadir, "geec.ipc"))
        # give gossip dials a moment, like the reference's block-1 grace
        # sleep (consensus/geec/geec.go:296)
        await asyncio.sleep(1.0)
        self.node.start()
        self.log.geec("node started", coinbase=self.coinbase.hex(),
                      height=self.chain.height(), mine=self.cfg.mine)
        self._height_task = asyncio.ensure_future(self._height_loop())

    async def _height_loop(self) -> None:
        last = -1
        last_metrics = 0.0
        last_push = 0.0
        while True:
            h = self.chain.height()
            if h != last:
                blk = self.chain.head()
                self.log.geec("head", height=h,
                              hash=blk.hash.hex()[:12],
                              geec_txns=len(blk.geec_txns),
                              fake_txns=len(blk.fake_txns))
                last = h
            import time as _time
            if self._telemetry is not None and \
                    _time.monotonic() - last_push > \
                    self._telemetry.interval_s:
                last_push = _time.monotonic()
                self._telemetry.tick()
            if _time.monotonic() - last_metrics > 30.0:
                last_metrics = _time.monotonic()
                from eges_tpu_torch.utils.metrics import DEFAULT as metrics
                snap = metrics.snapshot()
                if snap:
                    self.log.geec("metrics", **{
                        k.replace(".", "_"): v for k, v in snap.items()
                        if not isinstance(v, dict)})
                # drain finished spans to the datadir so multi-node runs
                # leave per-node JSONL dumps breakdown_report.py can merge
                from eges_tpu_torch.utils import tracing
                try:
                    tracing.DEFAULT.dump(
                        os.path.join(self.cfg.datadir, "spans.jsonl"))
                except OSError:
                    pass
                # same drain pattern for the consensus event journal:
                # per-node journal.jsonl feeds observatory.py --replay
                try:
                    self.node.journal.dump(
                        os.path.join(self.cfg.datadir, "journal.jsonl"))
                except OSError:
                    pass
                self._dump_profile()
            await asyncio.sleep(0.5)

    def _dump_profile(self) -> None:
        """Journal one aggregate profiler report (rides the telemetry
        push like every other journal event) and rewrite the cumulative
        ``profile.folded`` flamegraph artifact next to journal.jsonl.
        A real node's journal is not a determinism-checked stream, so
        the report lands inline — sims use a dedicated stream instead
        (sim/cluster.py enable_profiling)."""
        from eges_tpu_torch.utils import devstats as devstats_mod
        from eges_tpu_torch.utils import profiler as profiler_mod
        # one device-efficiency delta per dump interval, same inline
        # placement as the profiler report (and independent of whether
        # the sampler is running — the goodput ledger has no thread)
        devstats_mod.sample_memory()
        devstats_mod.DEFAULT.journal_snapshot(self.node.journal)
        prof = profiler_mod.DEFAULT
        if not prof.running:
            return
        prof.journal_snapshot(self.node.journal)
        from eges_tpu_torch.harness.profutil import artifact_header  # analysis: allow-layer-violation(profiler artifact emission; instrumentation hook)
        header = artifact_header(source="node-service")
        try:
            prof.dump_folded(
                os.path.join(self.cfg.datadir, "profile.folded"),
                header=header)
        except OSError:
            pass  # an unwritable datadir must not kill the height loop

    async def run_forever(self) -> None:
        await self.start()
        while True:
            await asyncio.sleep(3600)

    def close(self) -> None:
        if self._height_task is not None:
            self._height_task.cancel()
        if self._telemetry is not None:
            self._telemetry.close()
        from eges_tpu_torch.utils import tracing
        try:
            tracing.DEFAULT.dump(
                os.path.join(self.cfg.datadir, "spans.jsonl"))
        except OSError:
            pass
        # final profile report BEFORE the journal drain below (so it
        # lands in journal.jsonl), then join the sampler — a
        # still-walking sampler would race interpreter shutdown
        from eges_tpu_torch.utils import profiler as profiler_mod
        self._dump_profile()
        profiler_mod.DEFAULT.stop()
        try:
            self.node.journal.dump(
                os.path.join(self.cfg.datadir, "journal.jsonl"))
        except OSError:
            pass
        if self.discovery is not None:
            self.discovery.close()
        if self.rpc is not None:
            self.rpc.close()
        self.node.stop()
        if self.chain.verifier is not None and \
                hasattr(self.chain.verifier, "close"):
            # drain the scheduler's pending futures and join its
            # dispatch thread before the transports go away
            self.chain.verifier.close()
        self.txpool.close()
        self.gossip.close()
        self.direct.close()
        if self.txn_service is not None:
            self.txn_service.close()
        self.chain.store.close()
