"""Metrics registry: counters / gauges / meters / timers / histograms.

The port's copy of ``eges_tpu/utils/metrics.py``, with its own
``DEFAULT`` registry and ``percentile``: the port's facade, scheduler
and devstats publish into it, never into the reference's.

Role parity with the reference's ``metrics/`` fork (ref:
metrics/metrics.go:25 ``--metrics`` flag; instrumented in p2p/metrics.go,
eth/metrics.go, eth/downloader/metrics.go).  In-process registry with
snapshot export; the RPC layer and harness read snapshots instead of the
reference's influxdb/librato push exporters, and ``prometheus_text``
renders the whole registry in Prometheus text exposition format 0.0.4
for the RPC server's ``GET /metrics``.

Label convention: the registry is flat, so labeled series are encoded in
the metric name as ``family;key=value,key2=value2`` (e.g.
``verifier.device_seconds;bucket=128``).  The Prometheus exporter parses
that back into real labels; ``snapshot()`` keeps the flat names.
"""

from __future__ import annotations

import random
import re
import threading
import time
from collections import deque

# Closed vocabulary of metric families emitted by the library (the part
# of the name before the ``;`` label separator).  Emit sites are checked
# against this set by ``python -m harness.analysis`` (vocabulary rule):
# an unregistered family, a family used as two different kinds, or a
# registered family with no emit site all fail the gate.
METRIC_FAMILIES = frozenset({
    # core/chain.py
    "chain.bad_blocks", "chain.blocks", "chain.fastsync_adoptions",
    "chain.geec_txns", "chain.height", "chain.insert",
    "chain.insert_seconds", "chain.txns",
    # consensus/
    "consensus.deferred_depth", "consensus.deferred_dropped",
    "consensus.elected", "consensus.forced_empties",
    "consensus.geec_txn_dropped", "consensus.ingress_oversized",
    "consensus.phase_seconds", "consensus.reg_req_dropped",
    "consensus.sealed", "membership.min_ttl", "membership.size",
    # net/ + sim/simnet.py
    "net.dead_letters", "net.direct_bytes", "net.direct_msgs",
    "net.gossip_bytes", "net.gossip_msgs", "net.peer_count",
    # sim/faults.py — deterministic fault injection
    "sim.faults_injected",
    # core/txpool.py
    "txpool.known_clears", "txpool.pending", "txpool.window_undecoded",
    # crypto/ verifiers
    "verifier.batches", "verifier.compile_cache_hits",
    "verifier.compile_cache_misses", "verifier.d2h_seconds",
    "verifier.device", "verifier.device_name", "verifier.device_seconds",
    "verifier.h2d_seconds", "verifier.host_rows", "verifier.native",
    "verifier.native_batches", "verifier.native_rows",
    "verifier.pad_waste", "verifier.padded_rows", "verifier.rows",
    # crypto/scheduler.py — coalescing scheduler + sender-recovery cache
    "verifier.cache_hits", "verifier.cache_misses",
    "verifier.prewarmed_buckets", "verifier.sched_batch_rows",
    "verifier.sched_occupancy", "verifier.sched_queue_wait_seconds",
    "verifier.singleton_batches",
    # crypto/scheduler.py — fail-safe circuit breaker around the device
    "verifier.breaker_probes", "verifier.breaker_state",
    "verifier.breaker_trips", "verifier.device_errors",
    # crypto/scheduler.py — mesh dispatch (per-device window lanes);
    # the per-device families carry a ``;device=N`` label
    "verifier.mesh_devices", "verifier.mesh_occupancy",
    "verifier.mesh_queue_depth", "verifier.mesh_rows",
    "verifier.mesh_straggler_diverts", "verifier.mesh_window_splits",
    # crypto/aotstore.py + crypto/verifier.py — AOT-serialized
    # executables: artifact save/load/export accounting, persistent
    # compile-cache hardening, and service cold-start time
    "verifier.aot_compiles", "verifier.aot_export_seconds",
    "verifier.aot_load_errors", "verifier.aot_load_seconds",
    "verifier.aot_loads", "verifier.aot_saves",
    "verifier.cold_start_seconds", "verifier.compile_cache_errors",
    # crypto/scheduler.py — double-buffered window pipeline: fraction
    # of lane windows whose H2D staging overlapped the previous
    # window's compute/D2H
    "verifier.pipeline_overlap_ratio",
    # crypto/scheduler.py — window flight recorder (bounded lifecycle
    # ring behind the thw_flight RPC)
    "verifier.flight_windows",
    # crypto/scheduler.py — flight-ring overflow (oldest window evicted
    # before anything read it; the ring's silent-loss signal)
    "verifier.flight_dropped",
    # crypto/scheduler.py — SLO-driven adaptive window controller:
    # chosen deadline/bucket per step plus the decision count
    "verifier.adapt_decisions", "verifier.sched_target_rows",
    "verifier.sched_window_ms",
    # crypto/scheduler.py — hedged re-dispatch of straggling windows:
    # speculative duplicates placed, duplicates that won, losers
    # cancelled before execution, losers that ran to waste
    "verifier.hedge_cancelled", "verifier.hedge_wasted",
    "verifier.hedge_wins", "verifier.hedges",
    # consensus/node.py — snapshot state sync: durable checkpoints,
    # O(tail) restarts, byzantine-tolerant live sync, and the billed,
    # bounded snapshot-serving plane
    "statesync.aborts", "statesync.checkpoint_bytes",
    "statesync.checkpoints", "statesync.oversized_reply",
    "statesync.pages_accepted", "statesync.pages_rejected",
    "statesync.pages_served", "statesync.poisoned",
    "statesync.reanchors", "statesync.restart_replayed",
    "statesync.resumes", "statesync.serve_throttled",
    # utils/timeseries.py + harness/collector.py — telemetry plane
    "telemetry.envelopes", "telemetry.samples",
    # harness/slo.py — burn-rate SLO engine
    "slo.alerts_firing", "slo.transitions",
    # harness/anatomy.py — commit critical-path assembler
    "anatomy.blocks",
    # eges_tpu_torch/utils/ledger.py — ingress provenance ledger
    "ledger.evictions", "ledger.origins", "ledger.rejects",
    "ledger.rows", "ledger.snapshots",
    # eges_tpu_torch/utils/profiler.py — continuous sampling profiler
    "profiler.dropped", "profiler.hz", "profiler.overhead_pct",
    "profiler.reports", "profiler.samples",
    # eges_tpu_torch/utils/devstats.py — device-efficiency observatory; the
    # goodput and HBM-watermark families carry a ``;device=N`` label
    "devstats.goodput_ratio", "devstats.mem_bytes_in_use",
    "devstats.mem_limit_bytes", "devstats.mem_peak_bytes",
    "devstats.reports", "devstats.trace_captures",
})

# One-line help string per registered family, emitted as ``# HELP``
# lines by ``prometheus_text`` and kept exhaustive by the vocabulary
# checker (``python -m harness.analysis``): a family registered above
# without a help entry here fails the gate.
METRIC_HELP = {
    "chain.bad_blocks": "Blocks rejected by validation on insert.",
    "chain.blocks": "Canonical blocks inserted into the chain.",
    "chain.fastsync_adoptions": "Fast-sync snapshot adoptions.",
    "chain.geec_txns": "Geec control-plane transactions inserted.",
    "chain.height": "Current canonical chain height.",
    "chain.insert": "Block insert attempts.",
    "chain.insert_seconds": "Block insert latency in seconds.",
    "chain.txns": "Payload transactions inserted with blocks.",
    "consensus.deferred_depth": "Events parked on the deferred queue.",
    "consensus.deferred_dropped": "Oldest deferrals evicted at DEFER_MAX.",
    "consensus.elected": "Elections won by this node.",
    "consensus.forced_empties": "Empty blocks forced by round timeout.",
    "consensus.geec_txn_dropped": "UDP geec txns shed by size or backlog cap.",
    "consensus.ingress_oversized": "Datagrams dropped by the ingress "
                                   "byte cap before decode.",
    "consensus.reg_req_dropped": "Pending registrations evicted at "
                                 "REG_PENDING_MAX.",
    "consensus.phase_seconds": "Consensus phase duration in seconds.",
    "consensus.sealed": "Blocks sealed by this node.",
    "membership.min_ttl": "Minimum TTL across registered members.",
    "membership.size": "Registered committee members.",
    "net.dead_letters": "Messages dropped with no deliverable peer.",
    "net.direct_bytes": "Bytes sent over the direct (point-to-point) plane.",
    "net.direct_msgs": "Messages sent over the direct plane.",
    "net.gossip_bytes": "Bytes sent over the gossip plane.",
    "net.gossip_msgs": "Messages sent over the gossip plane.",
    "net.peer_count": "Currently connected peers.",
    "sim.faults_injected": "Scripted faults injected by the chaos harness.",
    "txpool.known_clears": "Coarse clears of the known-txn dedup set.",
    "txpool.pending": "Transactions pending in the pool.",
    "txpool.window_undecoded": (
        "Rows of a columnar ingest window dropped because the frame "
        "failed to decode."),
    "verifier.batches": "Signature verification batches dispatched.",
    "verifier.compile_cache_hits": "Verifier JIT compile-cache hits.",
    "verifier.compile_cache_misses": "Verifier JIT compile-cache misses.",
    "verifier.d2h_seconds": "Device-to-host transfer seconds.",
    "verifier.device": "Accelerator devices visible to the verifier.",
    "verifier.device_name": "Accelerator device platform/name label.",
    "verifier.device_seconds": "On-device compute seconds per batch.",
    "verifier.h2d_seconds": "Host-to-device transfer seconds.",
    "verifier.host_rows": "Rows verified on the host fallback path.",
    "verifier.native": "Whether the native host verifier is loaded.",
    "verifier.native_batches": "Batches served by the native host verifier.",
    "verifier.native_rows": "Rows served by the native host verifier.",
    "verifier.pad_waste": "Rows of padding added to reach bucket sizes.",
    "verifier.padded_rows": "Total rows after bucket padding.",
    "verifier.rows": "Signature rows submitted for verification.",
    "verifier.cache_hits": "Sender-recovery cache hits.",
    "verifier.cache_misses": "Sender-recovery cache misses.",
    "verifier.prewarmed_buckets": "Buckets compiled ahead of traffic.",
    "verifier.sched_batch_rows": "Rows per coalesced scheduler window.",
    "verifier.sched_occupancy": "Dispatched rows over padded bucket rows.",
    "verifier.sched_queue_wait_seconds":
        "Seconds a submission waited in the coalescing window.",
    "verifier.singleton_batches": "Single-row windows diverted to the host.",
    "verifier.breaker_probes": "Half-open circuit-breaker probe dispatches.",
    "verifier.breaker_state": "Circuit breaker state (0 closed, 1 open).",
    "verifier.breaker_trips": "Circuit breaker open transitions.",
    "verifier.device_errors": "Device dispatch failures.",
    "verifier.mesh_devices": "Device lanes in the mesh dispatcher.",
    "verifier.mesh_occupancy": "Per-device window occupancy.",
    "verifier.mesh_queue_depth": "Windows queued per device lane.",
    "verifier.mesh_rows": "Rows served per device lane.",
    "verifier.mesh_straggler_diverts":
        "Lane windows rescued to the host by the straggler policy.",
    "verifier.mesh_window_splits": "Windows split across device lanes.",
    "verifier.aot_compiles": "AOT executables compiled (cache miss).",
    "verifier.aot_export_seconds": "AOT artifact export seconds.",
    "verifier.aot_load_errors": "AOT artifact load failures.",
    "verifier.aot_load_seconds": "AOT artifact deserialize seconds.",
    "verifier.aot_loads": "AOT executables loaded from the artifact store.",
    "verifier.aot_saves": "AOT executables serialized to the artifact store.",
    "verifier.cold_start_seconds":
        "Service cold start: verifier ready after process start.",
    "verifier.compile_cache_errors": "Persistent compile-cache failures.",
    "verifier.pipeline_overlap_ratio":
        "Lane windows whose staging overlapped the previous compute.",
    "verifier.flight_windows":
        "Windows recorded by the lifecycle flight recorder.",
    "verifier.flight_dropped":
        "Flight-recorder windows evicted unread by ring overflow.",
    "verifier.adapt_decisions":
        "Window-sizing decisions taken by the adaptive controller.",
    "verifier.sched_target_rows":
        "Current adaptive target rows per coalesced window.",
    "verifier.sched_window_ms":
        "Current adaptive flush deadline in milliseconds.",
    "verifier.hedge_cancelled":
        "Hedged duplicates cancelled before execution (winner first).",
    "verifier.hedge_wasted":
        "Hedged duplicates that ran after the winner (wasted work).",
    "verifier.hedge_wins": "Straggling windows won by the hedge copy.",
    "verifier.hedges": "Speculative duplicate dispatches placed.",
    "statesync.aborts": "Fast syncs aborted back to full block replay.",
    "statesync.checkpoint_bytes": "Size of the newest durable checkpoint.",
    "statesync.checkpoints": "Durable state checkpoints written.",
    "statesync.oversized_reply": "State replies dropped by the pre-decode "
                                 "byte cap.",
    "statesync.pages_accepted": "State pages staged from serving peers.",
    "statesync.pages_rejected": "State pages rejected (unsolicited, "
                                "out-of-order, or unattributable).",
    "statesync.pages_served": "State pages served to fetching peers.",
    "statesync.poisoned": "Downloads rejected by the pivot root check.",
    "statesync.reanchors": "Downloads re-anchored on a fresh pivot/server.",
    "statesync.restart_replayed": "Tail blocks replayed on the last restart.",
    "statesync.resumes": "Syncs resumed from crash-staged pages.",
    "statesync.serve_throttled": "State fetches dropped by the per-peer "
                                 "serve rate limit.",
    "telemetry.envelopes": "Telemetry envelopes ingested by the collector.",
    "telemetry.samples": "Registry samples taken by the telemetry sampler.",
    "slo.alerts_firing": "SLO objectives currently in the firing state.",
    "slo.transitions": "SLO alert state-machine transitions journaled.",
    "anatomy.blocks": "Committed blocks assembled by the anatomy profiler.",
    "ledger.evictions": "Origins evicted by space-saving top-K tracking.",
    "ledger.origins": "Origins currently tracked by the ingress ledger.",
    "ledger.rejects": "Ingress rejects booked to origins by the ledger.",
    "ledger.rows": "Verifier rows booked to origins by the ledger.",
    "ledger.snapshots": "Per-block ingress_ledger snapshots journaled.",
    "profiler.dropped": "Profiler samples lost to walk races or stack caps.",
    "profiler.hz": "Configured stack-sampling rate of the CPU profiler.",
    "profiler.overhead_pct": "Profiler self-cost as % of elapsed wall time.",
    "profiler.reports": "profiler_report events folded by the collector.",
    "profiler.samples": "Thread stack samples captured by the CPU profiler.",
    "devstats.goodput_ratio":
        "Useful rows over padded device rows per lane (last tick).",
    "devstats.mem_bytes_in_use": "Device HBM bytes currently in use.",
    "devstats.mem_limit_bytes": "Device HBM allocation limit in bytes.",
    "devstats.mem_peak_bytes": "Device HBM peak bytes-in-use watermark.",
    "devstats.reports": "device_efficiency events folded by the collector.",
    "devstats.trace_captures": "On-demand device trace captures completed.",
}


def percentile(sorted_vals, q: float) -> float:
    """Linear-interpolation percentile over a pre-sorted sequence,
    matching numpy.percentile's default method."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_vals[0])
    rank = (q / 100.0) * (n - 1)
    lo = int(rank)
    frac = rank - lo
    if lo + 1 >= n:
        return float(sorted_vals[-1])
    return float(sorted_vals[lo]) + frac * (
        float(sorted_vals[lo + 1]) - float(sorted_vals[lo]))


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Meter:
    """Event rate: count + rate over the process lifetime and a 1-minute
    sliding window."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.count = 0
        self._start = clock()
        self._window: deque[tuple[float, int]] = deque()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
            now = self._clock()
            self._window.append((now, n))
            cutoff = now - 60.0
            while self._window and self._window[0][0] < cutoff:
                self._window.popleft()

    @property
    def rate_mean(self) -> float:
        dt = self._clock() - self._start
        return self.count / dt if dt > 0 else 0.0

    @property
    def rate_1m(self) -> float:
        with self._lock:
            return sum(n for _, n in self._window) / 60.0


class Timer:
    """Duration accumulator with count/total/min/max/mean."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def update(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)

    def time(self):
        t0 = self._clock()
        timer = self

        class _Ctx:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                timer.update(timer._clock() - t0)

        return _Ctx()

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Histogram:
    """Reservoir-sampled distribution (Vitter's Algorithm R, fixed-size
    uniform reservoir) with exact count/total/min/max and interpolated
    percentiles over the sample.

    A seeded PRNG keeps test runs deterministic; below ``reservoir``
    observations the percentiles are exact.
    """

    RESERVOIR = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._rng = random.Random(0x5eed)
        self._sample: list[float] = []
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if len(self._sample) < self.RESERVOIR:
                self._sample.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.RESERVOIR:
                    self._sample[j] = v

    def percentile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._sample)
        return percentile(vals, q)

    def percentiles(self, qs=(50.0, 95.0, 99.0)) -> dict[float, float]:
        with self._lock:
            vals = sorted(self._sample)
        return {q: percentile(vals, q) for q in qs}

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls()
                self._metrics[name] = m
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = {}
        for name, m in metrics:
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.value
            elif isinstance(m, Meter):
                out[name] = {"count": m.count,
                             "rate_mean": round(m.rate_mean, 3),
                             "rate_1m": round(m.rate_1m, 3)}
            elif isinstance(m, Timer):
                out[name] = {"count": m.count,
                             "mean_s": round(m.mean, 6),
                             "min_s": round(m.min, 6) if m.count else 0.0,
                             "max_s": round(m.max, 6)}
            elif isinstance(m, Histogram):
                ps = m.percentiles()
                out[name] = {"count": m.count,
                             "mean": round(m.mean, 6),
                             "min": round(m.min, 6) if m.count else 0.0,
                             "max": round(m.max, 6),
                             "p50": round(ps[50.0], 6),
                             "p95": round(ps[95.0], 6),
                             "p99": round(ps[99.0], 6)}
        return out


# -- Prometheus text exposition (format 0.0.4) --------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _split_labels(name: str) -> tuple[str, dict[str, str]]:
    """``family;k=v,k2=v2`` -> (family, {k: v})."""
    if ";" not in name:
        return name, {}
    family, _, rest = name.partition(";")
    labels = {}
    for pair in rest.split(","):
        if "=" in pair:
            k, _, v = pair.partition("=")
            labels[k.strip()] = v.strip()
    return family, labels


def _prom_name(family: str) -> str:
    name = _NAME_RE.sub("_", family)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    quoted = ",".join(
        '%s="%s"' % (_prom_name(k),
                     str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{" + quoted + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(f) if f != int(f) else str(int(f))


def prometheus_text(registry: "Registry | None" = None) -> str:
    """Render the registry in Prometheus text format.

    Counters/Meters become ``counter`` families, numeric Gauges become
    ``gauge``, Timers and Histograms become ``summary`` families (with
    quantile samples for Histograms).  Non-numeric gauges (e.g.
    ``verifier.device_name``) become ``<name>_info{value="..."} 1``.
    """
    reg = registry if registry is not None else DEFAULT
    with reg._lock:
        metrics = sorted(reg._metrics.items())

    families: dict[str, list[tuple[str, dict, object]]] = {}
    for name, m in metrics:
        family, labels = _split_labels(name)
        families.setdefault(_prom_name(family), []).append((name, labels, m))

    lines: list[str] = []
    for fam in sorted(families):
        members = families[fam]
        kind = type(members[0][2])
        # ``# HELP`` text keyed by the ORIGINAL (dotted) family name of
        # the first member; escaping per exposition format 0.0.4
        help_text = METRIC_HELP.get(_split_labels(members[0][0])[0], "")
        help_text = help_text.replace("\\", "\\\\").replace("\n", "\\n")

        def _help(suffix: str = "") -> None:
            if help_text:
                lines.append(f"# HELP {fam}{suffix} {help_text}")

        if kind is Counter:
            _help()
            lines.append(f"# TYPE {fam} counter")
            for _, labels, m in members:
                lines.append(f"{fam}{_fmt_labels(labels)} "
                             f"{_fmt_value(m.value)}")
        elif kind is Gauge:
            numeric = [(lb, m) for _, lb, m in members
                       if isinstance(m.value, (int, float))]
            info = [(lb, m) for _, lb, m in members
                    if not isinstance(m.value, (int, float))]
            if numeric:
                _help()
                lines.append(f"# TYPE {fam} gauge")
                for labels, m in numeric:
                    lines.append(f"{fam}{_fmt_labels(labels)} "
                                 f"{_fmt_value(m.value)}")
            if info:
                _help("_info")
                lines.append(f"# TYPE {fam}_info gauge")
                for labels, m in info:
                    lb = dict(labels)
                    lb["value"] = str(m.value)
                    lines.append(f"{fam}_info{_fmt_labels(lb)} 1")
        elif kind is Meter:
            _help("_total")
            lines.append(f"# TYPE {fam}_total counter")
            for _, labels, m in members:
                lines.append(f"{fam}_total{_fmt_labels(labels)} {m.count}")
            _help("_rate_1m")
            lines.append(f"# TYPE {fam}_rate_1m gauge")
            for _, labels, m in members:
                lines.append(f"{fam}_rate_1m{_fmt_labels(labels)} "
                             f"{_fmt_value(m.rate_1m)}")
        elif kind is Timer:
            _help()
            lines.append(f"# TYPE {fam} summary")
            for _, labels, m in members:
                lb = _fmt_labels(labels)
                lines.append(f"{fam}_count{lb} {m.count}")
                lines.append(f"{fam}_sum{lb} {_fmt_value(m.total)}")
        elif kind is Histogram:
            _help()
            lines.append(f"# TYPE {fam} summary")
            for _, labels, m in members:
                ps = m.percentiles()
                for q, key in ((50.0, "0.5"), (95.0, "0.95"), (99.0, "0.99")):
                    qlb = dict(labels)
                    qlb["quantile"] = key
                    lines.append(f"{fam}{_fmt_labels(qlb)} "
                                 f"{_fmt_value(ps[q])}")
                qlb = dict(labels)
                qlb["quantile"] = "1"
                mx = m.max if m.count else 0.0
                lines.append(f"{fam}{_fmt_labels(qlb)} {_fmt_value(mx)}")
                lb = _fmt_labels(labels)
                lines.append(f"{fam}_count{lb} {m.count}")
                lines.append(f"{fam}_sum{lb} {_fmt_value(m.total)}")
    return "\n".join(lines) + "\n"


DEFAULT = Registry()
