"""Consensus event journal: typed, replayable protocol-control-plane log.

The port's copy of ``eges_tpu/utils/journal.py``: its hooks reach the port's
tracing, ledger, profiler and devstats copies.

Role: the third observability generation.  The metrics registry
(``utils/metrics.py``) aggregates durations, the span tracer
(``utils/tracing.py``) follows one transaction — this module records
WHAT THE PROTOCOL DECIDED: elections started/won/lost, votes cast,
validate quorums, version bumps after failed rounds, block
confirm/commit, and the membership TTL economy.  The reference left
these as free-form log lines that ``grep.py`` scraped (SURVEY §5);
here they are typed events with monotonic sequence numbers that
``harness/observatory.py`` can merge across a cluster and replay
offline from JSONL dumps bit-for-bit.

Every event is a flat dict::

    {"seq": 17, "ts": 42.125, "node": "ab12cd34",
     "type": "election_won", "blk": 9, "version": 0, ...attrs}

``seq`` is per-journal monotonic (gap-free unless the ring dropped),
``ts`` comes from the injected clock (virtual time under the
simulator), ``blk``/``version`` correlate events to a consensus round,
and an active trace context adds ``trace`` so journal rows join the
span graph.  Event types are drawn from ONE registered set
(:data:`EVENT_TYPES`); ``record`` raises on an unknown type so emit
sites cannot drift from the observatory parser (the stringly-typed
drift the round-2 lint tests exist to prevent).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

# The single registered event vocabulary.  Emit sites (consensus/node.py,
# consensus/membership.py, core/chain.py, core/txpool.py) must use these
# literals and nothing else; tests/test_journal_observatory.py lints the
# sources against this set.
EVENT_TYPES = frozenset({
    # elections
    "election_started", "election_won", "election_lost",
    "vote_cast", "vote_stashed",
    # validate round
    "validate_request", "validate_reply", "validate_retry",
    "validate_quorum",
    # proposals
    "proposal_built", "proposal_aborted",
    # failed-round recovery
    "version_bump",
    # chain progress
    "block_confirmed", "block_committed",
    # membership TTL economy
    "member_registered", "member_renewed", "member_expired",
    # event-loop plumbing
    "deferred_drain",
    # txpool <-> chain coupling
    "txns_included",
    # verifier scheduler (crypto/scheduler.py): one coalesced dispatch
    # window flushed to the device or host-diverted
    "verifier_flush",
    # mesh dispatch (crypto/scheduler.py): one window/chunk served by a
    # specific device lane — device index, rows, queue wait, and whether
    # the lane host-diverted it (straggler rescue)
    "verifier_mesh_dispatch",
    # fault injection (sim/faults.py + harness/chaos.py): every
    # scripted fault lands in the journal stream so the observatory can
    # render the fault timeline next to the consensus events it caused
    "fault_crash", "fault_restart", "fault_partition", "fault_heal",
    "fault_link", "fault_net", "fault_skew", "fault_trigger",
    # verifier circuit breaker (crypto/scheduler.py): device declared
    # dead / half-open re-probe / recovered
    "fault_breaker",
    # AOT prewarm (node/service.py + sim/cluster.py restart): one
    # prewarm pass over the artifact store with load-vs-compile split
    # timing so the observatory can report cold-start time
    "verifier_aot_load",
    # telemetry plane (utils/timeseries.py + harness/collector.py): one
    # periodic registry sample — counters as deltas, gauges/percentiles
    # as points — riding the push channel to the cluster collector
    "telemetry_sample",
    # SLO burn-rate engine (harness/slo.py): alert state-machine
    # transitions, journaled so chaos scenarios assert on them and
    # --check-determinism byte-compares the alert stream
    "slo_pending", "slo_firing", "slo_resolved",
    # commit anatomy (harness/anatomy.py): per-block phase boundaries
    # emitted at three sites — the txpool's ingest/admit timestamps for
    # a block's included txns (stage="pool"), the proposer's
    # election/ack/seal split at seal time (stage="seal"), and one
    # verify-window interior per computed scheduler window
    # (stage="verify_window", wall-clock ms + lane; those attrs are
    # volatile-stripped by the chaos canonical dump)
    "commit_anatomy",
    # ingress provenance ledger (eges_tpu_torch/utils/ledger.py): one
    # per-origin decayed cost snapshot journaled at each block commit
    # when anything was charged — deterministic counts/deltas plus the
    # wall-clock "costs" account the chaos canonical dump strips
    "ingress_ledger",
    # adaptive scheduler controller (crypto/scheduler.py): one
    # window-sizing decision per controller step — chosen flush deadline
    # and target rows plus the burn/latency inputs that drove it (the
    # timing-derived attrs are volatile-stripped by the chaos canonical
    # dump; the decision COUNT stays deterministic)
    "sched_adapt",
    # continuous sampling profiler (eges_tpu_torch/utils/profiler.py): one
    # aggregate per-phase/per-role sample-count report per profiling
    # interval.  Sampled stacks are wall-clock by nature, so these are
    # journaled ONLY into the dedicated "profiler" stream created by
    # SimCluster.enable_profiling() (or a real node's journal) — never
    # into determinism-checked streams; chaos scenarios never enable
    # the plane
    "profiler_report",
    # snapshot state sync (consensus/node.py + core/statesync.py):
    # durable checkpoint written at the cadence boundary; O(tail)
    # restart anchored on a root-verified checkpoint; mid-sync crash
    # resume from staged pages; poisoned-page detection (final-root
    # mismatch → serving peer blacklisted); download re-anchored on a
    # fresh pivot/server; quiet-server rotation; bounded abort back to
    # full replay; successful snapshot adoption
    "statesync_checkpoint", "statesync_restart", "statesync_resume",
    "statesync_poisoned", "statesync_reanchor", "statesync_server_rotate",
    "statesync_abort", "statesync_adopted",
    # device-efficiency observatory (eges_tpu_torch/utils/devstats.py): one
    # per-device delta of deterministic window/row/waste counts per
    # devstats tick — goodput numerators/denominators plus the
    # per-bucket split.  Journaled into the dedicated "devstats" stream
    # created by SimCluster.enable_devstats() (or a real node's
    # journal); chaos determinism scenarios never enable the plane.
    # The optional "mem" block carries point-in-time HBM watermarks
    # and is absent on backends without memory_stats().
    "device_efficiency",
})

# The registered ``_breakdown`` phase vocabulary (consensus/node.py);
# kept here beside EVENT_TYPES so the lint test checks both stringly
# namespaces against one module.
BREAKDOWN_PHASES = frozenset({"election", "ack", "seal_total"})


class Journal:
    """Bounded per-node event ring with JSONL persistence.

    One instance per consensus node (NOT a process-global default: a sim
    cluster runs many nodes in one process and their journals must stay
    separable for the observatory merge).
    """

    def __init__(self, node: str = "", clock=time.monotonic,
                 capacity: int = 65536):
        self.node = node
        self._clock = clock
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=capacity)
        self._seq = 0
        self.dropped = 0
        # restart replay re-runs historical inserts through the live emit
        # sites; flipping this off keeps replayed history out of the ring
        self.enabled = True
        # optional event tap: called with each recorded event dict AFTER
        # it is appended.  The fault injector's leader-targeted triggers
        # ("kill the winner the moment it wins") listen here.
        self.on_record = None

    # -- recording ------------------------------------------------------
    def record(self, type: str, blk: int | None = None,
               version: int | None = None, **attrs) -> dict | None:
        if type not in EVENT_TYPES:
            raise ValueError(f"unregistered journal event type: {type!r}")
        if not self.enabled:
            return None
        ev: dict = {"ts": round(float(self._clock()), 6),
                    "node": self.node, "type": type}
        if blk is not None:
            ev["blk"] = blk
        if version is not None:
            ev["version"] = version
        from eges_tpu_torch.utils import tracing
        ctx = tracing.DEFAULT.current_context()
        if ctx is not None:
            ev["trace"] = ctx.trace_id
        ev.update(attrs)
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
        tap = self.on_record
        if tap is not None:
            tap(ev)  # outside the ring lock: taps may record elsewhere
        return ev

    # -- export ---------------------------------------------------------
    def events(self, limit: int = 0, since: int = 0) -> list[dict]:
        """Chronological events; ``since`` filters to ``seq >= since``
        (incremental polling), ``limit`` keeps only the newest N."""
        with self._lock:
            evs = list(self._events)
        if since:
            evs = [e for e in evs if e["seq"] >= since]
        if limit and limit > 0:
            evs = evs[-limit:]
        return evs

    def stats(self) -> dict:
        with self._lock:
            return {"seq": self._seq, "buffered": len(self._events),
                    "dropped": self.dropped,
                    "capacity": self._events.maxlen}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dump(self, path: str, drain: bool = True) -> int:
        """Append buffered events to ``path`` as JSONL; returns the
        number written.  ``drain`` empties the ring so periodic dumps
        never duplicate rows (same contract as ``Tracer.dump``)."""
        with self._lock:
            evs = list(self._events)
            if drain:
                self._events.clear()
        if not evs:
            return 0
        with open(path, "a", encoding="utf-8") as fh:
            for e in evs:
                fh.write(json.dumps(e, sort_keys=True) + "\n")
        return len(evs)


def load(path: str) -> list[dict]:
    """Parse a journal JSONL dump; a torn tail row (a live dump racing
    the reader) is skipped, everything parsed before it is kept."""
    out: list[dict] = []
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
