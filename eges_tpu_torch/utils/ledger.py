"""Ingress provenance ledger: per-origin cost accounting + abuse forensics.

The port's copy of ``eges_tpu/utils/ledger.py``, less its sim selftest
and its ``--replay`` report, which wait for the port's copies of
``sim/cluster.py`` and the observatory.

The paper's headline claim is *DoS-resistant* consensus, but the verify
pipeline accounts everything globally — the scheduler's cache hits,
invalid-signature early-outs, host diverts and device-ms say nothing
about WHICH peer or claimed sender consumed them.  This module is the
attribution substrate under the adversarial-load roadmap items: a
compact **origin tag** rides the thread from datagram/RPC ingest
(``sim/simnet.py`` stamps the delivering peer, ``consensus/node.py``
binds ``peer:<id>`` / ``rpc`` around its entry points) through txpool
admit/reject, scheduler window rows and consensus drops into one
:class:`IngressLedger` per node.

Two cooperating pieces:

* **Ambient origin context** (thread-local): :func:`peer` marks the
  delivering transport peer, :func:`bind` attaches (ledger, origin) for
  the duration of a handler, :func:`charge` books counts against the
  ambient origin and no-ops when unbound — instrumented layers never
  need a ledger reference threaded through their signatures.  Layers
  whose work completes on another thread or a later clock tick (txpool
  window flush, scheduler windows) capture :func:`current` at ingest
  and charge the captured pair at completion, so attribution survives
  the handoff.  Pool flushes fired by the clock timer carry per-txn
  captured origins; scheduler rows submitted OUTSIDE any bound handler
  (none today) simply stay unattributed.

* :class:`IngressLedger`: per-origin **exponentially decayed** counters
  (rows, admits, rejects, drops, deferred, cache hits/misses) plus
  wall-clock device/host milliseconds, under space-saving top-K
  tracking — evicting the lightest origin hands its weight to the
  newcomer as ``error``, the classic heavy-hitter bound, so a flood of
  one-shot origins can't wash out the real talkers.  Decay runs on the
  ledger's injected clock (virtual under the simulator), so the decayed
  counts are a pure function of the deterministic charge schedule.

Determinism contract: :meth:`IngressLedger.journal_snapshot` emits one
``ingress_ledger`` journal event per committed block (when anything
changed).  Every field is deterministic under the sim clock EXCEPT the
wall-clock ``costs`` account, which lives under that one top-level key
so the chaos canonical dump can strip it (``VOLATILE_KEYS``).  The
:class:`LedgerAssembler` below is a pure incremental function over the
sorted event stream — ``harness/collector.py`` feeds it live and in
replay in the same order, so the ledger section of the collector report
stays byte-identical between the two.
"""

from __future__ import annotations

import contextlib
import threading

from eges_tpu_torch.utils.metrics import DEFAULT as metrics

# decayed per-origin counter families (deterministic under the sim
# clock; wall-clock ms are accounted separately under "costs")
COUNT_KEYS = ("rows", "admits", "rejects", "drops", "deferred",
              "cache_hits", "cache_misses")
COST_KEYS = ("device_ms", "host_ms")

# distinct recovered/claimed senders remembered per origin — enough to
# tell one flooding key from a sender-cycling flood without letting an
# adversary grow the set unboundedly (beyond the cap only the count of
# remembered senders is reported, an undercount by design)
SENDER_CAP = 8


# -- ambient origin context ------------------------------------------------

_tls = threading.local()


# Origin strings come off the wire (transport peer ids, RPC client
# tags): clamp their length before they key ledger records or land in
# journal rows, so a hostile transport cannot inflate either.
_ORIGIN_MAX = 64


@contextlib.contextmanager
def peer(peer_id: str):
    """Mark ``peer_id`` as the delivering transport peer for the
    duration of a delivery callback (set by the network fabric, read by
    the receiving node's entry points via :func:`current_peer`)."""
    prev = getattr(_tls, "peer", "")
    _tls.peer = str(peer_id)[:_ORIGIN_MAX]
    try:
        yield
    finally:
        _tls.peer = prev


def current_peer() -> str:
    """The delivering peer id marked by :func:`peer`, or ``""``."""
    return getattr(_tls, "peer", "")


@contextlib.contextmanager
def bind(ledger: "IngressLedger", origin: str):
    """Attach ``(ledger, origin)`` as the ambient charge target for the
    duration of a handler (node entry points wrap their dispatch)."""
    prev = getattr(_tls, "bound", None)
    _tls.bound = (ledger, str(origin)[:_ORIGIN_MAX])
    try:
        yield
    finally:
        _tls.bound = prev


def current() -> tuple | None:
    """The ambient ``(ledger, origin)`` pair, or ``None`` unbound —
    capture this at ingest when the work completes on another thread."""
    return getattr(_tls, "bound", None)


def charge(**counts) -> None:
    """Book counts against the ambient origin; no-op when unbound (a
    layer driven outside any instrumented entry point, e.g. unit
    tests exercising the pool directly)."""
    bound = getattr(_tls, "bound", None)
    if bound is None:
        return
    led, origin = bound
    led.charge(origin, **counts)


# -- the per-node ledger ---------------------------------------------------

class IngressLedger:
    """Per-origin decayed cost counters with space-saving top-K.

    ``clock`` is a zero-arg callable (virtual under the simulator);
    decay is applied lazily at charge/snapshot time with half-life
    ``half_life_s``, so an origin that goes quiet fades instead of
    dominating the table forever.  At most ``k`` origins are tracked:
    adding one beyond that evicts the minimum-weight entry and the
    newcomer inherits its weight as ``error`` (the space-saving
    guarantee: a true heavy hitter is never displaced by churn).
    """

    def __init__(self, clock, *, k: int = 32, half_life_s: float = 60.0):
        self._clock = clock
        self.k = max(1, k)
        self.half_life_s = half_life_s
        # origin -> record; mutated only under the lock.  Metrics and
        # journal emits happen OUTSIDE it (fail-under-lock hygiene).
        self._origins: dict[str, dict] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._evictions = 0  # guarded-by: _lock
        # raw monotonic totals (ints): per-snapshot deltas drive the
        # invalid_sig_reject_ratio SLO and guarantee post-heal resolution
        # (decayed values never reach exactly zero)
        self._totals = {k2: 0 for k2 in COUNT_KEYS}
        self._last_emitted = dict(self._totals)

    def _decay(self, rec: dict, now: float) -> None:
        dt = now - rec["ts"]
        if dt <= 0:
            rec["ts"] = now
            return
        f = 0.5 ** (dt / self.half_life_s)
        for k2 in COUNT_KEYS + COST_KEYS:
            rec[k2] *= f
        rec["error"] *= f
        rec["ts"] = now

    @staticmethod
    def _weight(rec: dict) -> float:
        # deterministic counts only — never the wall-clock ms
        return sum(rec[k2] for k2 in COUNT_KEYS) + rec["error"]

    def charge(self, origin: str, *, rows: int = 0, admits: int = 0,
               rejects: int = 0, drops: int = 0, deferred: int = 0,
               cache_hits: int = 0, cache_misses: int = 0,
               device_ms: float = 0.0, host_ms: float = 0.0,
               sender: bytes | None = None) -> None:
        """Book one layer's outcome against ``origin``.  Thread-safe;
        cheap enough for per-row call sites (one lock, one decay)."""
        evicted = False
        with self._lock:
            now = self._clock()
            rec = self._origins.get(origin)
            if rec is None:
                error = 0.0
                if len(self._origins) >= self.k:
                    # space-saving eviction: drop the lightest origin
                    # (ties by name so the pick never depends on dict
                    # order) and inherit its weight as the error bound
                    victim = min(self._origins, key=lambda o: (
                        self._weight(self._origins[o]), o))
                    vrec = self._origins.pop(victim)
                    self._decay(vrec, now)
                    error = self._weight(vrec)
                    self._evictions += 1
                    evicted = True
                rec = self._origins[origin] = dict(
                    {k2: 0.0 for k2 in COUNT_KEYS + COST_KEYS},
                    error=error, ts=now, senders=set())
            else:
                self._decay(rec, now)
            rec["rows"] += rows
            rec["admits"] += admits
            rec["rejects"] += rejects
            rec["drops"] += drops
            rec["deferred"] += deferred
            rec["cache_hits"] += cache_hits
            rec["cache_misses"] += cache_misses
            rec["device_ms"] += device_ms
            rec["host_ms"] += host_ms
            if sender is not None and len(rec["senders"]) < SENDER_CAP:
                rec["senders"].add(bytes(sender))
            t = self._totals
            t["rows"] += rows
            t["admits"] += admits
            t["rejects"] += rejects
            t["drops"] += drops
            t["deferred"] += deferred
            t["cache_hits"] += cache_hits
            t["cache_misses"] += cache_misses
        if evicted:
            metrics.counter("ledger.evictions").inc()

    def _snapshot_locked(self) -> tuple[dict, dict]:
        now = self._clock()
        for rec in self._origins.values():
            self._decay(rec, now)
        order = sorted(self._origins,
                       key=lambda o: (-self._weight(self._origins[o]), o))
        origins = []
        costs = {}
        for o in order:
            rec = self._origins[o]
            row = {"origin": o}
            for k2 in COUNT_KEYS:
                row[k2] = round(rec[k2], 3)
            row["senders"] = len(rec["senders"])
            row["error"] = round(rec["error"], 3)
            origins.append(row)
            costs[o] = {"device_ms": round(rec["device_ms"], 3),
                        "host_ms": round(rec["host_ms"], 3)}
        deltas = {k2: self._totals[k2] - self._last_emitted[k2]
                  for k2 in COUNT_KEYS}
        snap = {
            "origins": origins,
            "tracked": len(origins),
            "evictions": self._evictions,
            "rows_delta": deltas["rows"],
            "admits_delta": deltas["admits"],
            "rejects_delta": deltas["rejects"],
            "drops_delta": deltas["drops"],
            # the ONE volatile account: wall-clock device/host time per
            # origin, stripped by the chaos canonical dump
            "costs": costs,
        }
        return snap, deltas

    def snapshot(self) -> dict:
        """Decayed per-origin state right now (does NOT advance the
        delta cursor — see :meth:`journal_snapshot`)."""
        with self._lock:
            return self._snapshot_locked()[0]

    def journal_snapshot(self, journal, *, blk: int) -> bool:
        """Journal one ``ingress_ledger`` event for block ``blk`` and
        advance the delta cursor; silent (returns False) when nothing
        was charged since the last emitted snapshot, so idle origins
        don't spam the stream."""
        with self._lock:
            if all(self._totals[k2] == self._last_emitted[k2]
                   for k2 in COUNT_KEYS):
                return False
            snap, deltas = self._snapshot_locked()
            self._last_emitted = dict(self._totals)
        # journal + metrics outside the ledger lock (fail-under-lock)
        if journal is not None:
            journal.record("ingress_ledger", blk=blk, **snap)
        metrics.counter("ledger.snapshots").inc()
        metrics.gauge("ledger.origins").set(snap["tracked"])
        if deltas["rows"]:
            metrics.counter("ledger.rows").inc(deltas["rows"])
        if deltas["rejects"]:
            metrics.counter("ledger.rejects").inc(deltas["rejects"])
        return True


# -- collector-side assembly ----------------------------------------------

# an offender needs SOME abuse mass before the verdict names anyone —
# one stray reject on a healthy cluster is noise, not an attacker
DOMINANT_MIN_ABUSE = 1.0


def _order_key(ev: dict) -> tuple:  # api: _order_key
    # identical to harness/collector._order_key; duplicated to keep the
    # assembler importable without pulling the collector's socket deps
    return (float(ev.get("ts", 0.0)), str(ev.get("node", "")),
            int(ev.get("seq", 0)), str(ev.get("type", "")))


class LedgerAssembler:
    """Incremental cluster-wide view over ``ingress_ledger`` events.

    Feed sorted events via :meth:`ingest` (the collector's barrier
    flush provides the order); each node's LATEST snapshot wins (the
    ledger is cumulative-decayed, not per-interval), and the report
    merges origins across nodes.  Pure function of the ingested
    stream — live push and journal replay byte-match.
    """

    def __init__(self):
        self._latest: dict[str, dict] = {}  # node -> latest event
        self._events = 0
        self._deltas = {"rows": 0, "admits": 0, "rejects": 0, "drops": 0}

    def ingest(self, ev: dict) -> None:
        if ev.get("type") != "ingress_ledger":
            return
        node = str(ev.get("node", "?"))
        self._latest[node] = ev
        self._events += 1
        for k2 in self._deltas:
            v = ev.get(k2 + "_delta")
            if isinstance(v, int):
                self._deltas[k2] += v

    def _merged(self) -> dict[str, dict]:
        per: dict[str, dict] = {}
        for node in sorted(self._latest):
            ev = self._latest[node]
            costs = ev.get("costs") or {}
            for row in ev.get("origins", ()):
                if not isinstance(row, dict):
                    continue
                o = str(row.get("origin", "?"))
                agg = per.setdefault(o, dict(
                    {k2: 0.0 for k2 in COUNT_KEYS + COST_KEYS},
                    senders=0, nodes=0))
                for k2 in COUNT_KEYS:
                    v = row.get(k2)
                    if isinstance(v, (int, float)):
                        agg[k2] += float(v)
                c = costs.get(o)
                if isinstance(c, dict):
                    for k2 in COST_KEYS:
                        v = c.get(k2)
                        if isinstance(v, (int, float)):
                            agg[k2] += float(v)
                agg["senders"] = max(agg["senders"],
                                     int(row.get("senders", 0) or 0))
                agg["nodes"] += 1
        return per

    @staticmethod
    def _score(agg: dict) -> float:
        return sum(agg[k2] for k2 in COUNT_KEYS)

    @staticmethod
    def _abuse(agg: dict) -> float:
        # the forensics signal: work the pipeline THREW AWAY for this
        # origin (invalid-sig rejects + duplicate/replacement drops)
        return agg["rejects"] + agg["drops"]

    def dominant(self) -> dict | None:
        """Name the top offender, or None when nobody crossed the abuse
        floor.  Deterministic: decayed counts only (already rounded at
        journal time), ties broken by origin name."""
        per = self._merged()
        total = sum(self._abuse(a) for a in per.values())
        if total < DOMINANT_MIN_ABUSE:
            return None
        name = min(per, key=lambda o: (-self._abuse(per[o]), o))
        agg = per[name]
        return {"origin": name,
                "share": round(self._abuse(agg) / total, 4),
                "rejects": round(agg["rejects"], 3),
                "drops": round(agg["drops"], 3)}

    def report(self) -> dict:
        per = self._merged()
        origins = []
        for o in sorted(per, key=lambda o: (-self._score(per[o]), o)):
            agg = per[o]
            attempts = agg["admits"] + agg["rejects"]
            row = {"origin": o}
            for k2 in COUNT_KEYS + COST_KEYS:
                row[k2] = round(agg[k2], 3)
            row["reject_ratio"] = (round(agg["rejects"] / attempts, 4)
                                   if attempts > 0 else 0.0)
            row["senders"] = agg["senders"]
            row["nodes"] = agg["nodes"]
            origins.append(row)
        return {
            "snapshots": self._events,
            "nodes": len(self._latest),
            "rows_delta_total": self._deltas["rows"],
            "admits_total": self._deltas["admits"],
            "rejects_total": self._deltas["rejects"],
            "drops_total": self._deltas["drops"],
            "origins": origins,
            "dominant": self.dominant(),
        }


def assemble(by_node: dict[str, list[dict]]) -> dict:
    """Offline ledger view over merged journal streams (the shape
    ``SimCluster.journals()`` / ``observatory.load_journals`` produce).
    Events feed in the same sorted order the live collector uses, so a
    replayed report byte-matches the live one."""
    asm = LedgerAssembler()
    merged: list[dict] = []
    for name in sorted(by_node):
        merged.extend(e for e in by_node[name] if isinstance(e, dict))
    for ev in sorted(merged, key=_order_key):
        asm.ingest(ev)
    return asm.report()
