"""Simulated Geec cluster: construction and control.

The port's copy of ``eges_tpu/sim/cluster.py``: the shared scheduler
wraps whatever verifier the caller passes.  ``verifier=None`` keeps
the host crypto; ``SimCluster(verifier=BatchVerifier())`` puts the
port's facade on the card behind ``scheduler_for``, which over it
serves no row from the host model.  The restart path warms the
port's facade through ``aot_prewarm``, as the reference's does: the
kernel library through the artifact store (``crypto/aotstore.py``)
and the 16-row bucket; a native verifier has no ``aot_prewarm``.

The in-process analogue of the reference's ``test.py`` local 3-node
harness (ref: test.py:1-138 — bootnode + N geth processes on distinct
ports) with deterministic keys, virtual time, and direct access to every
node's state.  Used by the consensus test-suite and by liveness/soak
checks (the ``test-sep-2.sh`` criterion: chain keeps advancing).
"""

from __future__ import annotations

from dataclasses import dataclass

from eges_tpu_torch.consensus.config import BootstrapNode, ChainGeecConfig, NodeConfig
from eges_tpu_torch.consensus.node import GeecNode
from eges_tpu_torch.core.chain import BlockChain, make_genesis
from eges_tpu_torch.crypto import secp256k1 as secp
from eges_tpu_torch.ingress import columns_of, direct_sink, gossip_sink
from eges_tpu_torch.sim.simnet import SimClock, SimNet, SkewedClock


@dataclass
class SimNode:
    name: str
    priv: bytes
    addr: bytes
    chain: BlockChain
    node: GeecNode
    clock: SkewedClock = None   # per-node (skewable) view of the clock
    crashed: bool = False


class SimCluster:
    def __init__(self, n_nodes: int = 3, *, n_bootstrap: int | None = None,
                 seed: int = 0, n_candidates: int = 3, n_acceptors: int = 4,
                 txn_per_block: int = 10, txn_size: int = 100,
                 block_timeout_s: float = 20.0, validate_timeout_ms: float = 500,
                 backoff_time_ms: float = 0.0, reg_timeout_s: float = 10.0,
                 drop_rate: float = 0.0, failure_test: bool = False,
                 verifier=None, mine=None, signed: bool = True,
                 alloc: dict | None = None, txpool: bool = False,
                 fast_sync: set | None = None, defer: set | None = None,
                 mesh_devices: int | None = None, sched_config=None,
                 columnar: bool = True, checkpoint_every: int = 0):
        self.clock = SimClock()
        self.net = SimNet(self.clock, seed=seed, drop_rate=drop_rate)
        self.nodes: list[SimNode] = []

        # mesh_devices builds an N-lane virtual mesh of host verifiers
        # (card-free), so sims and chaos runs exercise the scheduler's
        # per-device window lanes without an accelerator
        if verifier is None and mesh_devices:
            from eges_tpu_torch.crypto.verify_host import NativeMeshVerifier
            verifier = NativeMeshVerifier(mesh_devices)

        # every node shares ONE coalescing scheduler + recovery cache
        # around the supplied verifier (crypto/scheduler.py): the same
        # vote signature verified by N sim nodes costs one device row
        # and N-1 cache hits.  A mesh verifier (device_targets()) makes
        # that shared scheduler a mesh dispatcher — one window lane per
        # device, shared by every sim node.  verifier=None (host
        # fallback) passes through untouched.
        # sched_config (a crypto.scheduler.SchedulerConfig) pins the
        # shared scheduler's knobs for this cluster — chaos scenarios
        # use it to enable adaptive windowing / hedging with the sim's
        # deterministic flush discipline instead of env overrides
        from eges_tpu_torch.crypto.scheduler import scheduler_for
        kw = {"config": sched_config} if sched_config is not None else {}
        verifier = scheduler_for(verifier, **kw)
        self.verifier = verifier

        if n_bootstrap is None:
            n_bootstrap = n_nodes
        from eges_tpu_torch.crypto.keys import deterministic_node_key
        privs = [deterministic_node_key(i) for i in range(n_nodes)]
        addrs = [secp.pubkey_to_address(secp.privkey_to_pubkey(p))
                 for p in privs]
        boot = tuple(
            BootstrapNode(account=addrs[i], ip="10.0.0.%d" % (i + 1),
                          port=8100 + i)
            for i in range(n_bootstrap))
        ccfg = ChainGeecConfig(bootstrap=boot,
                               validate_timeout_ms=validate_timeout_ms,
                               backoff_time_ms=backoff_time_ms,
                               reg_timeout_s=reg_timeout_s,
                               signed_votes=signed)
        genesis = make_genesis(alloc=alloc)

        self._deferred: set[int] = set(defer or ())
        self._ccfg = ccfg
        self._genesis = genesis
        self._mine = mine
        self._txpool = txpool
        self._columnar = columnar
        self._alloc = alloc
        # crashed nodes' journal history, preserved across the rebuild
        # so the observatory sees one continuous per-node stream
        self._archived: dict[str, list] = {}
        # chaos harness attaches its fault-injector journal here; it
        # rides journals() under the synthetic "faults" node name
        self.fault_journal = None
        # telemetry plane (enable_telemetry): the sampler's journal
        # rides journals() as "telemetry"; a harness-side SLO engine's
        # alert journal attaches to slo_journal and rides as "slo", so
        # chaos canonical dumps byte-compare the alert stream too
        self.telemetry_journal = None
        self.slo_journal = None
        self._telemetry_sampler = None
        self._telemetry_sink = None
        self._telemetry_interval = 0.0
        self._telemetry_cursor: dict[str, int] = {}
        # continuous profiling plane (enable_profiling): aggregate
        # profiler_report events ride journals() as "profiler" — a
        # DEDICATED stream, because sampled counts are wall-clock and
        # must never touch the determinism-checked node streams (chaos
        # scenarios never call enable_profiling)
        self.profiler = None
        self.profile_journal = None
        self._profile_interval = 0.0
        # device-efficiency plane (enable_devstats): per-device
        # device_efficiency count deltas ride journals() as "devstats"
        # — a dedicated stream like "profiler", never enabled by the
        # chaos determinism scenarios
        self.devstats_journal = None
        self._devstats_interval = 0.0
        for i in range(n_nodes):
            name = f"node{i}"
            ncfg = NodeConfig(
                coinbase=addrs[i], consensus_ip="10.0.0.%d" % (i + 1),
                consensus_port=8100 + i, n_candidates=n_candidates,
                n_acceptors=n_acceptors, txn_per_block=txn_per_block,
                txn_size=txn_size, block_timeout_s=block_timeout_s,
                total_nodes=n_nodes, failure_test=failure_test,
                privkey=privs[i] if signed else b"",
                fast_sync=bool(fast_sync and i in fast_sync),
                checkpoint_every=checkpoint_every)
            node_clock = SkewedClock(self.clock)
            chain = BlockChain(genesis=genesis, verifier=verifier,
                               alloc=alloc)
            node = GeecNode(chain, node_clock, None, ncfg, ccfg,
                            mine=(mine[i] if mine is not None else True),
                            verifier=verifier)
            if txpool:
                from eges_tpu_torch.core.txpool import TxPool
                node.txpool = TxPool(node_clock, verifier=verifier)
                if columnar:
                    # the wire-speed ingest hook: relayed txn bundles go
                    # through the columnar admission seam.  Injected here
                    # (sim is L4) so the node (L2) never imports ingress
                    # (L3).  columnar=False keeps the per-tx legacy path
                    # — the differential test's oracle.
                    node.columnarize = columns_of
            if i not in self._deferred:
                # deferred nodes (late joiners) stay OFF the network —
                # no transport join, no gossip — until start_deferred()
                transport = self.net.join(name, ncfg.consensus_ip,
                                          ncfg.consensus_port,
                                          gossip_sink(node),
                                          direct_sink(node))
                node.transport = transport
            self.nodes.append(SimNode(name=name, priv=privs[i],
                                      addr=addrs[i], chain=chain, node=node,
                                      clock=node_clock))

    def start(self) -> None:
        for i, sn in enumerate(self.nodes):
            if i not in self._deferred:
                sn.node.start()

    def start_deferred(self, i: int) -> None:
        """Bring a deferred node online mid-run: the late-joiner leg of
        the sync scenarios (fast sync's raison d'être)."""
        assert i in self._deferred, f"node{i} was not deferred"
        self._deferred.discard(i)
        sn = self.nodes[i]
        ncfg = sn.node.cfg
        sn.node.transport = self.net.join(
            sn.name, ncfg.consensus_ip, ncfg.consensus_port,
            gossip_sink(sn.node), direct_sink(sn.node))
        sn.node.start()

    def crash(self, i: int) -> None:
        """Tear a node down mid-run: cancel its timers, detach it from
        the chain, unbind it from both network planes.  Its BlockChain
        (the "datadir") survives for :meth:`restart` to replay."""
        sn = self.nodes[i]
        assert not sn.crashed, f"{sn.name} already crashed"
        sn.node.stop()
        sn.chain.remove_listener(sn.node._on_new_block)
        self.net.leave(sn.name)
        # keep the dead node's journal history for the observatory merge
        self._archived.setdefault(sn.name, []).extend(
            sn.node.journal.events())
        # a cluster-shared scheduler journaling into this node's stream
        # re-attaches to whichever node adopts it next
        if self.verifier is not None and \
                getattr(self.verifier, "journal", None) is sn.node.journal:
            self.verifier.journal = None
        sn.crashed = True

    def restart(self, i: int) -> None:
        """Rebuild a crashed node from its surviving chain — the same
        restart-replay path a real process takes on boot (GeecNode's
        constructor re-ingests every canonical block with the journal
        gated off), then rejoin both planes and start."""
        sn = self.nodes[i]
        assert sn.crashed, f"{sn.name} is not crashed"
        ncfg = sn.node.cfg
        # the surviving store IS the datadir: rebuild the chain FROM it,
        # exactly as a real process boot does, so a durable checkpoint
        # sidecar anchors the state replay (O(tail) rejoin) instead of
        # inheriting the dead node's in-memory snapshots
        sn.chain = BlockChain(store=sn.chain.store, genesis=self._genesis,
                              verifier=self.verifier, alloc=self._alloc)
        node = GeecNode(sn.chain, sn.clock, None, ncfg, self._ccfg,
                        mine=(self._mine[i] if self._mine is not None
                              else True),
                        verifier=self.verifier)
        if self._txpool:
            from eges_tpu_torch.core.txpool import TxPool
            node.txpool = TxPool(sn.clock, verifier=self.verifier)
            if self._columnar:
                node.columnarize = columns_of
        node.transport = self.net.join(sn.name, ncfg.consensus_ip,
                                       ncfg.consensus_port,
                                       gossip_sink(node),
                                       direct_sink(node))
        sn.node = node
        sn.crashed = False
        # AOT prewarm before serving: the port's facade gets its
        # kernel library (the build directory's, the artifact store's,
        # or an nvcc build saved to the store) and runs the 16-row
        # bucket — and the rejoin cost lands in
        # the journal for the observatory and the chaos rejoin bound.
        # Native verifiers have no aot_prewarm; the no-op keeps chaos
        # runs byte-deterministic.
        backing = self.verifier
        if backing is not None:
            backing = getattr(backing, "_verifier", backing)
        warm = getattr(backing, "aot_prewarm", None)
        if callable(warm):
            import time as _time
            # analysis: allow-determinism(real AOT reload cost; cold_start_s is volatile-stripped)
            t0 = _time.monotonic()
            info = warm(buckets=(16,))
            # analysis: allow-determinism(real AOT reload cost; cold_start_s is volatile-stripped)
            cold = round(_time.monotonic() - t0, 3)
            node.journal.record(
                "verifier_aot_load", buckets=info["buckets"],
                aot_loads=info["aot_loads"],
                aot_compiles=info["aot_compiles"],
                load_s=round(info["load_s"], 3),
                compile_s=round(info["compile_s"], 3),
                cold_start_s=cold, device_kind=info["device_kind"],
                restart=True)
        node.start()

    def live_nodes(self) -> list[SimNode]:
        return [sn for sn in self.nodes if not sn.crashed]

    def run(self, seconds: float, stop_condition=None) -> None:
        self.clock.run_until(self.clock.now() + seconds, stop_condition)

    def heights(self) -> list[int]:
        return [sn.chain.height() for sn in self.nodes]

    def min_height(self) -> int:
        return min(self.heights())

    def net_stats(self) -> dict:
        """SimNet delivery counters (gossip/direct/dropped/dead_letter/
        corrupted/duplicated/reordered) for the cluster report."""
        return dict(self.net.stats)

    # -- telemetry push channel (utils/timeseries.py) -------------------

    def enable_telemetry(self, *, sink=None, interval_s: float = 5.0,
                         capacity: int = 512):
        """Turn on the periodic registry sampler and (optionally) the
        push channel to a collector.

        Every ``interval_s`` of VIRTUAL time one registry sample lands
        as a ``telemetry_sample`` event in the cluster's "telemetry"
        journal (the process-wide registry is shared by every sim node,
        so the cluster samples once — the per-process analogue of a real
        node's sampler), and ``sink`` — typically
        ``harness.collector.ClusterCollector.ingest`` — receives one
        envelope per journal stream carrying the events recorded since
        the previous tick.  Delivery runs synchronously on the sim
        clock: the deterministic stand-in for the socket push channel
        real nodes use (``node/service.py``).

        Returns the telemetry journal.
        """
        from eges_tpu_torch.utils.journal import Journal
        from eges_tpu_torch.utils.metrics import DEFAULT
        from eges_tpu_torch.utils.timeseries import RegistrySampler

        self.telemetry_journal = Journal("telemetry", clock=self.clock.now)
        self._telemetry_sampler = RegistrySampler(
            DEFAULT, clock=self.clock.now, capacity=capacity)
        self._telemetry_sink = sink
        self._telemetry_interval = interval_s
        self.clock.call_later(interval_s, self._telemetry_tick)
        return self.telemetry_journal

    def _telemetry_tick(self, reschedule: bool = True) -> None:
        from eges_tpu_torch.utils import devstats as devstats_mod

        now = self.clock.now()
        # refresh HBM watermark gauges (no-op on host-only runs) so the
        # registry sample below carries them — the sim analogue of the
        # real node's pre-sample hook in node/service.py
        devstats_mod.sample_memory()
        payload = self._telemetry_sampler.sample()
        self.telemetry_journal.record(
            "telemetry_sample", step=self._telemetry_sampler.steps,
            metrics=payload)
        sink = self._telemetry_sink
        if sink is not None:
            streams = self.journals()
            streams.pop("slo", None)  # the collector's own output
            for name in sorted(streams):
                evs = streams[name]
                cursor = self._telemetry_cursor.get(name, 0)
                fresh = evs[cursor:]
                if fresh:
                    sink({"node": name, "ts": now, "events": fresh})
                self._telemetry_cursor[name] = len(evs)
        if reschedule:
            self.clock.call_later(self._telemetry_interval,
                                  self._telemetry_tick)

    def flush_telemetry(self) -> None:
        """One final sample + push outside the periodic schedule, so a
        collector holds every event the journals hold (the round-trip
        test's precondition).  No-op when telemetry is off."""
        if self._telemetry_sampler is not None:
            self._telemetry_tick(reschedule=False)

    # -- continuous profiling plane (utils/profiler.py) -----------------

    def enable_profiling(self, *, hz: float | None = None,
                         interval_s: float = 5.0, profiler=None):
        """Start a sampling profiler for the sim process and journal
        one aggregate ``profiler_report`` per ``interval_s`` of VIRTUAL
        time into a dedicated "profiler" stream (like the telemetry
        plane, the process is shared so the cluster profiles once).

        The sampler itself runs on REAL time — stacks are wall-clock
        by nature — which is exactly why the reports get their own
        stream: chaos determinism checks byte-compare node streams and
        never enable this plane.  ``hz=None`` resolves EGES_PROFILE_HZ
        (default ~97); 0 leaves the plane off (no thread, empty
        stream).  Returns the profiler.
        """
        from eges_tpu_torch.utils.journal import Journal
        from eges_tpu_torch.utils.profiler import SamplingProfiler

        self.profiler = profiler or SamplingProfiler(hz=hz)
        self.profile_journal = Journal("profiler", clock=self.clock.now)
        self._profile_interval = interval_s
        self.profiler.start()
        self.clock.call_later(interval_s, self._profile_tick)
        return self.profiler

    def _profile_tick(self, reschedule: bool = True) -> None:
        self.profiler.journal_snapshot(self.profile_journal)
        if reschedule:
            self.clock.call_later(self._profile_interval,
                                  self._profile_tick)

    def stop_profiling(self) -> None:
        """Join the sampler and journal the final report (forced, so a
        profiled run is never invisible to the collector fold).  No-op
        when profiling is off."""
        if self.profiler is None:
            return
        self.profiler.stop()
        self.profiler.journal_snapshot(self.profile_journal, force=True)

    # -- device-efficiency plane (utils/devstats.py) ---------------------

    def enable_devstats(self, *, interval_s: float = 5.0):
        """Journal per-device ``device_efficiency`` count deltas every
        ``interval_s`` of VIRTUAL time into a dedicated "devstats"
        stream (the goodput ledger is process-wide like the metrics
        registry, so the cluster journals once).

        The ledger is rebased first so windows recorded by earlier
        runs in the same process never leak into the first tick.  Pair
        with ``mesh_devices=N`` at construction to give the scheduler
        real per-device lanes to account.  Returns the journal."""
        from eges_tpu_torch.utils import devstats as devstats_mod
        from eges_tpu_torch.utils.journal import Journal

        self.devstats_journal = Journal("devstats", clock=self.clock.now)
        self._devstats_interval = interval_s
        devstats_mod.DEFAULT.rebase()
        self.clock.call_later(interval_s, self._devstats_tick)
        return self.devstats_journal

    def _devstats_tick(self, reschedule: bool = True) -> None:
        from eges_tpu_torch.utils import devstats as devstats_mod

        devstats_mod.sample_memory()
        devstats_mod.DEFAULT.journal_snapshot(self.devstats_journal)
        if reschedule:
            self.clock.call_later(self._devstats_interval,
                                  self._devstats_tick)

    def stop_devstats(self) -> None:
        """Journal the final delta outside the periodic schedule so
        windows recorded after the last tick still reach the collector
        fold.  No-op when the plane is off."""
        if self.devstats_journal is None:
            return
        self._devstats_tick(reschedule=False)

    def journals(self) -> dict[str, list[dict]]:
        """Per-node consensus event journals, keyed by sim node name —
        the live-poll source ``harness/observatory.py`` merges (the
        RPC-less analogue of hitting ``thw_journal`` on every node).
        Crashed-then-restarted nodes contribute their archived pre-crash
        events plus the rebuilt node's stream; an attached fault
        injector's journal rides along as the "faults" node."""
        out = {}
        for sn in self.nodes:
            out[sn.name] = (self._archived.get(sn.name, [])
                            + sn.node.journal.events())
        if self.fault_journal is not None:
            out["faults"] = self.fault_journal.events()
        if self.telemetry_journal is not None:
            out["telemetry"] = self.telemetry_journal.events()
        if self.slo_journal is not None:
            out["slo"] = self.slo_journal.events()
        if self.profile_journal is not None:
            out["profiler"] = self.profile_journal.events()
        if self.devstats_journal is not None:
            out["devstats"] = self.devstats_journal.events()
        return out
