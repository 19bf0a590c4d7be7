"""Continuous sampling profiler: phase-attributed CPU flamegraphs.

The port's copy of ``eges_tpu/utils/profiler.py`` (same phase and
family names), less its sim selftest, which waits for the port's copy
of ``sim/cluster.py``.

Role: the "which *functions* burn the time" half of the observability
plane.  Anatomy (``harness/anatomy.py``) attributes wall-clock to
pipeline phases from journal events; the flight recorder attributes
window latency to verifier lifecycle phases; neither can say whether
``pool_admit`` cost is RLP decode, LRU probes, or lock wait.  This
module can: a background thread walks ``sys._current_frames()`` at a
configurable rate (default ~97 Hz — prime, so it never beats with
periodic 10 ms/100 ms work), folds each observed stack into the
standard flamegraph format (``root;child;leaf N``), and tags every
sample with

* the **thread role**, recovered from the thread-name vocabulary the
  lockset plane already standardizes (``verifier-scheduler`` /
  ``verifier-lane-*`` / ``verifier-hedge`` / ``collector-*`` / the
  asyncio service loop), and
* the **pipeline phase**, a per-thread tag maintained by the
  ``phase()`` context manager and — the bridge to the span tracer —
  set automatically for the duration of any ``Tracer.span`` whose name
  appears in :data:`SPAN_PHASES` (``txpool.ingest``/``txpool.admit``
  -> ``pool_admit``).  The phase vocabulary is the anatomy plane's
  ``PHASE_ORDER`` plus the verify-window interior
  (``verify_stage``/``verify_compute``/``verify_collect``) so profile
  reports and anatomy reports speak the same language.

Because this is a *wall-clock* sampler (every live thread is sampled,
running or blocked), lock wait and queue wait show up as samples whose
leaf frame is the wait primitive — exactly the attribution the
wire-speed-ingest work needs.

Determinism contract: like the flight recorder, sampled stacks are
real-time by nature and are NEVER journaled into determinism-checked
streams.  Sims that want profile data in the collector plane call
``SimCluster.enable_profiling()``, which journals aggregate
``profiler_report`` events into a dedicated ``"profiler"`` stream the
chaos determinism checks never enable.  Live-push and ``--replay``
collector folds therefore agree on sample *counts* by construction
(both consume the same journaled reports); the stacks themselves are
volatile by contract.

Knobs: ``EGES_PROFILE_HZ`` overrides the sampling rate; ``0`` disables
the plane entirely (``start()`` spawns no thread).  The sampler keeps
its own cost observable: ``stats()["overhead_pct"]`` is cumulative
frame-walk time over elapsed wall time, and the tier-1 overhead guard
pins it under 5%.

Reference: geth ships this plane as ``--pprof`` +
``debug_cpuProfile``/``debug_goTrace`` (node/api.go); the folded
artifact this module dumps next to ``journal.jsonl`` is the
flamegraph-ready equivalent.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager

ENV_HZ = "EGES_PROFILE_HZ"
DEFAULT_HZ = 97.0       # prime-ish: avoids aliasing with periodic work
MAX_DEPTH = 48          # frames kept per stack (root-most are dropped)
FOLD_CAP = 20_000       # distinct folded stacks before new ones drop
TOP_CAP = 40            # (func, phase) self-time rows per report
SNAP_RING = 64          # report snapshots kept for the thw_profile RPC

# The closed phase vocabulary: anatomy's PHASE_ORDER (harness/anatomy.py)
# plus the verify-window interior the flight recorder times.  Closed on
# purpose — an unknown tag raises, like journal.record on an unknown
# event type, so the vocabulary cannot drift silently.
PROFILE_PHASES = frozenset({
    # anatomy macro phases (block pipeline)
    "pool_admit", "pool_queue", "election", "ack_quorum",
    "seal_other", "publish", "propagation",
    # verify-window interior (scheduler fill/dispatch, device compute
    # or host divert, blocking collect)
    "verify_stage", "verify_compute", "verify_collect",
    # threads carrying no tag
    "untagged",
})

# Span-tracer bridge: a Tracer.span() with one of these names tags the
# thread for the span body (see utils/tracing.py).  Only *live* spans
# appear here — consensus phases are record_span()'d after the fact
# from virtual-clock durations and have no live extent to sample.
SPAN_PHASES = {
    "txpool.ingest": "pool_admit",
    "txpool.admit": "pool_admit",
    "txpool.admit_window": "pool_admit",
}

# Host-vs-verify split used by the bench gate: what share of
# pipeline-attributed samples is host-side ingest work rather than the
# verify window itself.
POOL_PHASES = ("pool_admit", "pool_queue")
VERIFY_PHASES = ("verify_stage", "verify_compute", "verify_collect")

# Thread-name prefix -> role, reusing the lockset plane's thread-entry
# vocabulary (scheduler dispatch/lane/hedge workers, collector accept +
# per-connection workers).  The asyncio service loop runs consensus,
# the telemetry pusher and RPC handlers; its executor threads serve
# blocking RPC work.
_ROLE_PREFIXES = (
    ("verifier-scheduler", "dispatch"),
    ("verifier-lane", "lane"),
    ("verifier-hedge", "hedge"),
    ("collector", "collector"),
    ("profiler-sampler", "profiler"),
    ("telemetry", "telemetry"),
    ("journal-writer", "telemetry"),
    ("asyncio", "rpc"),
    ("ThreadPoolExecutor", "rpc"),
    ("MainThread", "main"),
)


def role_of(thread_name: str) -> str:
    """Map a thread name onto the role vocabulary (``other`` if none)."""
    for prefix, role in _ROLE_PREFIXES:
        if thread_name.startswith(prefix):
            return role
    return "other"


def configured_hz() -> float:
    """The env-resolved sampling rate (``0`` disables the plane)."""
    raw = os.environ.get(ENV_HZ)
    if raw is None or not raw.strip():
        return DEFAULT_HZ
    try:
        hz = float(raw)
    # analysis: allow-swallow(a malformed EGES_PROFILE_HZ falls back to the default rate)
    except ValueError:
        return DEFAULT_HZ
    return max(0.0, hz)


# -- per-thread phase tags ------------------------------------------------
# Keyed by thread ident.  Single-key dict reads/writes are GIL-atomic,
# and each thread only ever touches its own key, so no lock is needed;
# the sampler reads other threads' entries with a plain .get(), which
# at worst observes the previous tag for one sample.
_PHASES: dict[int, str | None] = {}


def push_phase(name: str):
    """Tag the calling thread with ``name``; returns a token for
    :func:`pop_phase`.  Raises on a name outside the closed
    vocabulary."""
    if name not in PROFILE_PHASES:
        raise ValueError(f"unknown profile phase {name!r}")
    ident = threading.get_ident()
    prev = _PHASES.get(ident)
    _PHASES[ident] = name
    return (ident, prev)


def pop_phase(token) -> None:
    """Restore the tag saved by :func:`push_phase` (exception-safe)."""
    ident, prev = token
    if prev is None:
        _PHASES.pop(ident, None)
    else:
        _PHASES[ident] = prev


@contextmanager
def phase(name: str):
    """Tag the calling thread with pipeline phase ``name`` for the
    body.  Nests: the previous tag is restored on exit."""
    token = push_phase(name)
    try:
        yield
    finally:
        pop_phase(token)


def tag_span(span_name: str):
    """Span-tracer hook: tag the thread if ``span_name`` maps to a
    phase; returns a pop token or None.  Called by ``Tracer.span``."""
    ph = SPAN_PHASES.get(span_name)
    if ph is None:
        return None
    return push_phase(ph)


def host_cpu_share(by_phase: dict) -> float | None:
    """``host_cpu_share_of_verify_pct``: the share of pipeline-tagged
    samples spent in host-side ingest phases rather than the verify
    window — the before/after number for the wire-speed-ingest work.
    None when no pipeline-tagged samples exist."""
    pool = sum(int(by_phase.get(p, 0)) for p in POOL_PHASES)
    verify = sum(int(by_phase.get(p, 0)) for p in VERIFY_PHASES)
    total = pool + verify
    if total <= 0:
        return None
    return 100.0 * pool / total


# -- the sampler ----------------------------------------------------------

class SamplingProfiler:
    """Background-thread wall-clock sampler with folded-stack
    aggregation and per-role/per-phase attribution.

    ``clock`` is injectable for tests; it times the sampler's own
    bookkeeping (overhead estimate, snapshot cadence) and defaults to
    real time — sampling is wall-clock by nature even under a virtual
    sim clock.
    """

    def __init__(self, hz: float | None = None, *,
                 clock=time.monotonic, snapshots: int = SNAP_RING):
        self.hz = float(configured_hz() if hz is None else max(0.0, hz))
        self._clock = clock
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        # sampler-thread-private ident -> name cache (refreshed from
        # threading.enumerate() when an unknown ident appears)
        self._names: dict[int, str] = {}
        # guarded-by: _lock
        self._folded: dict[tuple, int] = {}
        # guarded-by: _lock
        self._by_phase: dict[str, int] = {}
        # guarded-by: _lock
        self._by_role: dict[str, int] = {}
        # guarded-by: _lock  ((phase, leaf func) -> self samples)
        self._self: dict[tuple[str, str], int] = {}
        # guarded-by: _lock
        self._samples = 0
        # guarded-by: _lock
        self._dropped = 0
        # guarded-by: _lock  (cumulative seconds spent walking frames)
        self._walk_s = 0.0
        # guarded-by: _lock
        self._started_at: float | None = None
        # guarded-by: _lock  (delta baseline for snap())
        self._base = {"samples": 0, "dropped": 0, "by_phase": {},
                      "by_role": {}, "self": {}}
        # guarded-by: _lock
        self._snaps: deque[dict] = deque(maxlen=max(1, snapshots))
        # guarded-by: _lock
        self._snap_seq = 0

    # -- lifecycle --------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> bool:
        """Spawn the sampler daemon.  ``hz <= 0`` (the
        ``EGES_PROFILE_HZ=0`` kill switch) spawns NOTHING and returns
        False — zero threads is the disabled contract the thread
        hygiene tests audit."""
        if self.hz <= 0.0:
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return True
            if self._started_at is None:
                self._started_at = self._clock()
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, name="profiler-sampler", daemon=True)
            self._thread.start()
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.gauge("profiler.hz").set(self.hz)
        return True

    def stop(self, timeout: float = 2.0) -> None:
        """Stop and JOIN the sampler (daemonhood alone is not enough —
        a still-walking sampler after close would race interpreter
        teardown).  Aggregates survive for a final report/dump."""
        with self._lock:
            t = self._thread
            self._thread = None
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout)

    # thread-entry:profiler-sampler
    def _loop(self) -> None:
        period = 1.0 / self.hz
        evt = self._stop_evt
        while not evt.is_set():
            t0 = self._clock()
            self._sample_once()
            walked = self._clock() - t0
            with self._lock:
                self._walk_s += walked
            evt.wait(max(0.001, period - walked))

    def _sample_once(self) -> None:
        try:
            frames = sys._current_frames()
        # analysis: allow-swallow(a failed frame walk loses one sample tick, counted as dropped)
        except Exception:
            with self._lock:
                self._dropped += 1
            return
        me = threading.get_ident()
        names = self._names
        if any(ident not in names for ident in frames):
            names = {t.ident: t.name for t in threading.enumerate()
                     if t.ident is not None}
            self._names = names
        local: list[tuple[str, str, tuple]] = []
        bad = 0
        for ident, frame in frames.items():
            if ident == me:
                continue  # never sample the sampler
            role = role_of(names.get(ident, "?"))
            ph = _PHASES.get(ident) or "untagged"
            stack: list[str] = []
            f = frame
            try:
                while f is not None and len(stack) < MAX_DEPTH:
                    code = f.f_code
                    qual = getattr(code, "co_qualname", code.co_name)
                    stack.append(
                        f"{f.f_globals.get('__name__', '?')}.{qual}")
                    f = f.f_back
            # analysis: allow-swallow(a frame mutating mid-walk loses one sample, counted as dropped)
            except Exception:
                bad += 1
                continue
            stack.reverse()  # root-first, the folded convention
            local.append((role, ph, tuple(stack)))
        del frames
        capped = 0
        with self._lock:
            self._dropped += bad
            for role, ph, stack in local:
                self._samples += 1
                self._by_phase[ph] = self._by_phase.get(ph, 0) + 1
                self._by_role[role] = self._by_role.get(role, 0) + 1
                leaf = (ph, stack[-1] if stack else "?")
                self._self[leaf] = self._self.get(leaf, 0) + 1
                key = (role, ph, stack)
                n = self._folded.get(key)
                if n is None and len(self._folded) >= FOLD_CAP:
                    # stack-shape explosion guard: counts above stay
                    # exact, only the new *shape* is dropped
                    self._dropped += 1
                    capped += 1
                    continue
                self._folded[key] = (n or 0) + 1
        # emitted after release: counters take the registry lock
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        if local:
            metrics.counter("profiler.samples").inc(len(local) - capped)
        if bad or capped:
            metrics.counter("profiler.dropped").inc(bad + capped)

    # -- reporting --------------------------------------------------------
    def _overhead_pct_locked(self) -> float:
        if self._started_at is None:
            return 0.0
        elapsed = max(1e-9, self._clock() - self._started_at)
        return round(100.0 * self._walk_s / elapsed, 3)

    def stats(self) -> dict:
        """The ``thw_health`` block: rate, volume, loss, self-cost."""
        with self._lock:
            return {
                "running": self.running,
                "hz": self.hz,
                "samples": self._samples,
                "dropped": self._dropped,
                "stacks": len(self._folded),
                "snapshots": len(self._snaps),
                "overhead_pct": self._overhead_pct_locked(),
            }

    def report(self, top_n: int = TOP_CAP) -> dict:
        """Cumulative attribution report: per-phase and per-role sample
        shares plus the top self-time (phase, function) rows."""
        with self._lock:
            samples = self._samples
            by_phase = dict(self._by_phase)
            by_role = dict(self._by_role)
            top = sorted(self._self.items(),
                         key=lambda kv: (-kv[1], kv[0]))[:top_n]
            overhead = self._overhead_pct_locked()
        return {
            "samples": samples,
            "hz": self.hz,
            "overhead_pct": overhead,
            "by_phase": {k: by_phase[k] for k in sorted(by_phase)},
            "by_role": {k: by_role[k] for k in sorted(by_role)},
            "top": [{"func": func, "phase": ph, "samples": n}
                    for (ph, func), n in top],
            "host_cpu_share_of_verify_pct": host_cpu_share(by_phase),
        }

    def snap(self) -> dict:
        """One delta report since the previous ``snap()`` — the unit
        the ``thw_profile`` RPC pages through and the sim profiling
        plane journals.  Appended to a bounded ring."""
        with self._lock:
            base = self._base
            d_phase = {k: v - base["by_phase"].get(k, 0)
                       for k, v in self._by_phase.items()
                       if v - base["by_phase"].get(k, 0) > 0}
            d_role = {k: v - base["by_role"].get(k, 0)
                      for k, v in self._by_role.items()
                      if v - base["by_role"].get(k, 0) > 0}
            d_self = {k: v - base["self"].get(k, 0)
                      for k, v in self._self.items()
                      if v - base["self"].get(k, 0) > 0}
            snap = {
                "seq": self._snap_seq,
                "hz": self.hz,
                "samples": self._samples - base["samples"],
                "dropped": self._dropped - base["dropped"],
                "by_phase": {k: d_phase[k] for k in sorted(d_phase)},
                "by_role": {k: d_role[k] for k in sorted(d_role)},
                "top": [[func, ph, n] for (ph, func), n in
                        sorted(d_self.items(),
                               key=lambda kv: (-kv[1], kv[0]))[:TOP_CAP]],
                "overhead_pct": self._overhead_pct_locked(),
            }
            self._snap_seq += 1
            self._base = {"samples": self._samples,
                          "dropped": self._dropped,
                          "by_phase": dict(self._by_phase),
                          "by_role": dict(self._by_role),
                          "self": dict(self._self)}
            self._snaps.append(snap)
            overhead = snap["overhead_pct"]
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.gauge("profiler.overhead_pct").set(overhead)
        return snap

    def snapshots(self, limit: int = 0) -> list[dict]:
        """Oldest-first report snapshots (RPC callers reverse for the
        newest-first wire contract, like the flight recorder)."""
        with self._lock:
            out = list(self._snaps)
        if limit and limit > 0:
            out = out[-limit:]
        return out

    def journal_snapshot(self, journal, force: bool = False):
        """Take a :meth:`snap` and journal it as one aggregate
        ``profiler_report`` event.  Skips empty deltas unless
        ``force`` (the final flush always records, so a profiled run
        is never invisible to the collector fold)."""
        snap = self.snap()
        if snap["samples"] <= 0 and not force:
            return None
        return journal.record(
            "profiler_report", hz=snap["hz"], samples=snap["samples"],
            dropped=snap["dropped"], by_phase=snap["by_phase"],
            by_role=snap["by_role"], top=snap["top"],
            overhead_pct=snap["overhead_pct"])

    def folded(self) -> list[str]:
        """The cumulative profile as folded-stack lines —
        ``role;phase;root;...;leaf N``, highest count first.  Feed
        straight to any flamegraph renderer."""
        with self._lock:
            items = list(self._folded.items())
        items.sort(key=lambda kv: (-kv[1], kv[0]))
        return [";".join((role, ph) + stack) + f" {n}"
                for (role, ph, stack), n in items]

    def dump_folded(self, path: str, header: dict | None = None) -> int:
        """Write (overwrite — the profile is cumulative) the folded
        artifact; returns the number of stack lines.  ``header`` is
        embedded as a ``# eges-profile-v1 {...}`` comment so every
        profiling artifact in the tree carries the same provenance
        stamp (see harness/profutil.py)."""
        import json

        lines = self.folded()
        with open(path, "w", encoding="utf-8") as fh:
            if header is not None:
                fh.write("# eges-profile-v1 "
                         + json.dumps(header, sort_keys=True) + "\n")
            for line in lines:
                fh.write(line + "\n")
        return len(lines)


# The process-wide profiler the node service starts and the RPC/health
# surfaces read.  Constructed from the environment; NOT started here —
# lifecycle belongs to NodeService (and to sims via enable_profiling).
DEFAULT = SamplingProfiler()


# -- collector-plane assembler --------------------------------------------

class ProfileAssembler:
    """Incremental fold of journaled ``profiler_report`` events into
    one cluster-wide attribution report — the profiler analog of
    ``AnatomyAssembler``.  Pure function of the event stream, so the
    live-push and ``--replay`` collector paths agree byte-for-byte on
    everything derived from sample counts."""

    def __init__(self):
        self._nodes: dict[str, int] = {}
        self._samples = 0
        self._dropped = 0
        self._hz = 0.0
        self._by_phase: dict[str, int] = {}
        self._by_role: dict[str, int] = {}
        self._self: dict[tuple[str, str], int] = {}

    def ingest(self, ev: dict) -> None:
        if ev.get("type") != "profiler_report":
            return
        node = str(ev.get("node", "?"))
        self._nodes[node] = self._nodes.get(node, 0) + 1
        self._samples += int(ev.get("samples", 0) or 0)
        self._dropped += int(ev.get("dropped", 0) or 0)
        self._hz = max(self._hz, float(ev.get("hz", 0.0) or 0.0))
        for ph, n in (ev.get("by_phase") or {}).items():
            self._by_phase[ph] = self._by_phase.get(ph, 0) + int(n)
        for role, n in (ev.get("by_role") or {}).items():
            self._by_role[role] = self._by_role.get(role, 0) + int(n)
        for row in (ev.get("top") or []):
            func, ph, n = row[0], row[1], int(row[2])
            key = (str(ph), str(func))
            self._self[key] = self._self.get(key, 0) + n
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.counter("profiler.reports").inc()

    def report(self, top_n: int = 20) -> dict:
        samples = self._samples
        top = sorted(self._self.items(),
                     key=lambda kv: (-kv[1], kv[0]))[:top_n]
        return {
            "reports": sum(self._nodes.values()),
            "nodes": {k: self._nodes[k] for k in sorted(self._nodes)},
            "samples": samples,
            "dropped": self._dropped,
            "hz": self._hz,
            "by_phase": {k: self._by_phase[k]
                         for k in sorted(self._by_phase)},
            "by_role": {k: self._by_role[k]
                        for k in sorted(self._by_role)},
            "top_self": [
                {"func": func, "phase": ph, "samples": n,
                 "pct": round(100.0 * n / samples, 2) if samples else 0.0}
                for (ph, func), n in top],
            "host_cpu_share_of_verify_pct": host_cpu_share(self._by_phase),
        }


def assemble(by_node: dict[str, list[dict]]) -> dict:
    """Batch-mode fold over per-stream event lists (the observatory
    ``--replay`` path); mirrors ``anatomy.assemble``."""
    from eges_tpu_torch.utils.ledger import _order_key

    asm = ProfileAssembler()
    merged: list[dict] = []
    for events in by_node.values():
        merged.extend(e for e in events
                      if e.get("type") == "profiler_report")
    merged.sort(key=_order_key)
    for ev in merged:
        asm.ingest(ev)
    return asm.report()
