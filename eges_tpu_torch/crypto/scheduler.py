"""Mesh-sharded coalescing verifier scheduler with a sender-recovery cache.

The port's copy of ``eges_tpu/crypto/scheduler.py``: the same
``SchedulerConfig`` (``EGES_SCHED_*``), lanes, breaker, adaptive
windowing, hedging, recovery cache and pipelined lane worker, publishing
into the port's metrics, tracing, ledger and devstats.  It calls the
facade's methods duck-typed and imports nothing of it; over the port's
``BatchVerifier`` a window runs through ``stage_recover`` /
``commit_recover`` / ``collect_recover`` on the lane worker's current
CUDA stream.  That facade says ``host_fallback = False``, and the
scheduler then serves none of its rows from the host model: the
singleton divert, the breaker's divert and the host recovery of failed
or post-close rows below are the reference's behavior over host
targets only; over the card a device error fails its window's futures.

Every consensus/txpool call site used to drive the batch verifier
synchronously — including one-row dispatches per candidacy/registration
message that got padded to a 16-row bucket and still paid full dispatch
plus transfer cost.  This layer sits between those callers and the
device facade (:class:`~eges_tpu_torch.crypto.verifier.BatchVerifier` or the
card-free :class:`~eges_tpu_torch.crypto.verify_host.NativeBatchVerifier`):

* callers :meth:`submit` ``(sighash, sig)`` requests and get futures;
* a background dispatch thread coalesces concurrent requests across
  callers (txpool sender recovery + vote quorums + single-message
  checks) into ONE batch per micro-window — flushed when the bucket
  fills, when the deadline measured from the oldest pending entry
  expires, or when a synchronous caller *kicks* the window;
* an LRU ``(sighash, sig) -> address-or-None`` recovery cache makes
  gossip re-delivery and commit-time re-verification free — the role
  split the reference implements host-side as the concurrent sender
  cacher + signature LRU (ref: core/tx_cacher.go:45 txSenderCacher,
  core/types/transaction_signing.go:42 sigCache via Transaction.from);
* a flush that coalesced down to a single row is diverted to the host
  recovery path instead of the device: a padded 1-row device dispatch
  costs more than one native recover, and diverting keeps
  ``verifier.singleton_batches`` at zero in steady state.

**Mesh dispatch.** When the backing verifier exposes ``device_targets()``
(the reference's ``MeshBatchVerifier``, not yet copied into the port,
or the host-model ``NativeMeshVerifier``), the admission front above
feeds one *window lane* per device instead of calling the verifier
inline:

* each lane owns a FIFO queue and a worker thread, so a slow chip
  stalls only the windows placed on it (stragglers never head-of-line
  block the mesh);
* placement fills the least-loaded lane (queued + in-flight rows; ties
  rotate round-robin so idle meshes still spread sequential windows),
  and a window larger than ``max_batch / n_lanes`` splits into
  contiguous chunks across distinct lanes — saturated load reaches
  every device;
* the circuit breaker is scoped PER LANE: one dead device trips
  one breaker, that lane's windows host-divert, every other lane keeps
  the device path (per-lane ``straggler_diverts`` counts the rescue);
* completion is per chunk — each chunk resolves (or fails) its own
  futures independently, reusing the fail-safe resolution, so one
  device's death diverts exactly its own in-flight windows.

With one visible device the lane machinery collapses to the single-device
behavior: the admission thread dispatches inline, no extra threads.

**Double-buffered window pipeline.** A target exposing the split-phase
``stage_recover`` / ``commit_recover`` / ``collect_recover`` trio
(:class:`~eges_tpu_torch.crypto.verifier.BatchVerifier`) gets its
windows run on a lane worker even single-lane: the worker begins
window k+1 — numpy fill, H2D upload into the verifier's double
buffers, async device dispatch — BEFORE blocking on window k's
collect, so consecutive windows overlap H2D/compute/D2H instead of
serializing.  ``verifier.pipeline_overlap_ratio`` (and per-lane
``pipeline_windows``/``pipeline_overlapped`` stats) report how often
the overlap actually happened.  Native verifiers don't expose the trio,
so sims and the chaos harness keep the inline path and its
byte-deterministic event ordering.

**SLO-driven adaptive scheduling.** Every real-time knob lives in
:class:`SchedulerConfig` (env-overridable as ``EGES_SCHED_*``).  With
``adaptive=True`` a closed-loop controller runs one step per recorded
window: it reads the flight recorder's recent wait/stage/compute
timings plus the SLO engine's commit-latency burn rate (injectable
:attr:`VerifierScheduler.burn_probe`) and steers the flush deadline and
target bucket — large occupancy-biased windows while the burn is calm,
small deadline-biased windows while the p99 objective is burning.
Decisions journal as ``sched_adapt``.  Windows carry a priority class:
``"consensus"`` submissions (election acks, QC checks) flush ahead of
``"bulk"`` tx-ingest rows and their windows preempt bulk windows at
lane placement, with per-class queue-wait metrics.  In mesh mode a
straggler monitor hedges: a window whose wall-clock age exceeds its
lane's flight-derived threshold (median × ``hedge_factor``) is
speculatively re-placed on the least-loaded sibling lane; the first
result wins, the loser is cancelled (or its results discarded), and
stats/journal/ledger all record the window exactly once.

This module must stay importable WITHOUT torch (same contract as
``verify_host.py``): the bench parent and host-fallback node processes
construct schedulers around native verifiers.

Thread model: ``submit``/``kick``/``close`` arrive on any caller thread
(RPC workers, the sim clock thread, consensus dispatch); the flush loop
runs on one daemon thread, plus one daemon worker per device lane in
mesh mode.  Every mutable field — pending map, cache, stats, every lane
queue and breaker — is guarded by the one condition ``self._lock``; the
dispatch and lane threads call only the backing verifier outside it,
never a caller's lock — so they can never deadlock against the
node/txpool lock domain.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, fields, replace

import numpy as np

from eges_tpu_torch.crypto.bucketing import bucket_round
from eges_tpu_torch.utils import ledger, profiler

# sentinel distinguishing "cached None" (a signature that verifiably
# fails recovery) from "not cached"
_MISS = object()

# the shared bucket model (back-compat alias: scheduler and verifier
# both round through crypto/bucketing.bucket_round now)
_bucket16 = bucket_round


class _WindowRows:
    """Result holder for one window-granular submission: N rows, ONE
    completion — :meth:`VerifierScheduler.submit_window` returns one of
    these instead of N per-row futures, so a 16k-row ingest window
    costs one wait-side object and one wakeup.

    Each row is occupied by a :class:`_WindowSlot` riding the normal
    pending map; the backing future resolves with the full ``results``
    list once every row has resolved.  Row failures are stored as
    exception VALUES (never raised here) so one dead row cannot poison
    its window — callers decide per row (``recover_window`` host-
    diverts them, mirroring ``recover_signers``)."""

    __slots__ = ("results", "_done", "_remaining", "_lock", "_fut",
                 "_finished")

    def __init__(self, n: int):
        self.results: list = [None] * n
        self._done = bytearray(n)
        self._remaining = n
        self._lock = threading.Lock()
        self._fut: Future = Future()
        self._finished = False

    def _slot_set(self, idx: int, value) -> None:
        with self._lock:
            if self._done[idx]:
                return  # exactly-once per row (hedge losers re-resolve)
            self._done[idx] = 1
            self.results[idx] = value
            self._remaining -= 1
        self._try_finish()

    def prefill(self, idx: int, value) -> None:
        """Construction-time row fill (cache hits, post-close rows) —
        called before any slot of this window is visible to the lanes,
        so the row lock is uncontended; taken anyway to keep every
        write to the shared slots under the same lock.  The window
        future completes later via :meth:`_try_finish`."""
        with self._lock:
            self._done[idx] = 1
            self.results[idx] = value
            self._remaining -= 1

    def _try_finish(self) -> None:
        with self._lock:
            if self._remaining or self._finished:
                return
            self._finished = True
        self._fut.set_result(self.results)

    def result(self, timeout: float | None = None) -> list:
        return self._fut.result(timeout)


class _WindowSlot:
    """Future duck-type occupying one row of a :class:`_WindowRows`.

    Exposes exactly the surface the scheduler's resolution paths use on
    a real ``Future`` — ``done()`` / ``set_result`` / ``set_exception``
    — so window rows ride the pending map, dedup, lane dispatch, hedge
    and close() drains unchanged.  Exceptions become stored row values
    (see ``_WindowRows``)."""

    __slots__ = ("_win", "_idx")

    def __init__(self, win: _WindowRows, idx: int):
        self._win = win
        self._idx = idx

    def done(self) -> bool:
        return bool(self._win._done[self._idx])

    def set_result(self, value) -> None:
        self._win._slot_set(self._idx, value)

    def set_exception(self, exc: BaseException) -> None:
        self._win._slot_set(self._idx, exc)


@dataclass
class SchedulerConfig:
    """Every real-time knob of the scheduler in one bundle.

    The scattered constructor kwargs (flush deadline, bucket cap, cache
    size, breaker cooldown, mesh split floor) plus the adaptive
    controller gains and hedging thresholds live here so bench runs and
    tests can sweep them without monkeypatching scheduler internals.
    Any field can be overridden from the environment as
    ``EGES_SCHED_<FIELD>`` (upper-cased field name) — e.g.
    ``EGES_SCHED_WINDOW_MS=0.5`` or ``EGES_SCHED_ADAPTIVE=1`` — read
    once per :meth:`from_env` call (which is what the scheduler
    constructor uses when no explicit config is passed).
    """

    # -- static window policy (the pre-adaptive scheduler surface) --
    window_ms: float = 2.0        # flush deadline from the oldest entry
    max_batch: int = 1024         # hard bucket cap per window
    cache_size: int = 4096        # LRU recovery-cache entries
    breaker_cooldown_s: float = 5.0  # per-lane breaker open time
    min_split: int = 16           # smallest mesh chunk worth a dispatch
    flight_ring: int = 256        # flight-recorder ring capacity
    # -- adaptive windowing (closed-loop controller) --
    adaptive: bool = False        # enable the per-window controller
    slo_p99_ms: float = 50.0      # declared p99 window objective for the
    #                               derived burn (no SLO probe attached)
    min_window_ms: float = 0.25   # deadline floor when shrinking
    max_window_ms: float = 8.0    # deadline ceiling when growing
    min_target_rows: int = 32     # bucket floor when shrinking
    shrink_gain: float = 0.5      # deadline multiplier while burning
    grow_gain: float = 1.5        # deadline multiplier while calm
    burn_shrink: float = 1.0      # burn >= this -> latency-bias
    burn_relax: float = 0.5       # burn <= this -> occupancy-bias
    adapt_every: int = 1          # controller period, recorded windows
    adapt_recent: int = 32        # flight entries per decision
    # -- hedged re-dispatch (mesh straggler speculation) --
    hedge: bool = True            # speculative straggler re-placement
    hedge_factor: float = 3.0     # straggler = age > lane median x this
    hedge_min_windows: int = 4    # lane flights before its own median
    #                               outranks the all-lane median
    hedge_floor_ms: float = 25.0  # never hedge a window younger than this
    hedge_poll_ms: float = 5.0    # straggler monitor poll period

    @classmethod
    def from_env(cls, env=None) -> "SchedulerConfig":
        """A config built from defaults plus ``EGES_SCHED_*`` overrides
        (field types are inferred from the defaults; booleans accept
        1/true/yes/on).  A malformed value raises — a bad sweep knob
        must fail loudly, not silently run the defaults."""
        env = os.environ if env is None else env
        kw = {}
        for f in fields(cls):
            raw = env.get("EGES_SCHED_" + f.name.upper())
            if raw is None:
                continue
            if isinstance(f.default, bool):
                kw[f.name] = raw.strip().lower() in ("1", "true",
                                                     "yes", "on")
            elif isinstance(f.default, int):
                kw[f.name] = int(raw)
            else:
                kw[f.name] = float(raw)
        return cls(**kw)


class _DeviceLane:
    """One device's window queue + dispatch bookkeeping (a mesh lane).

    Single-device schedulers have exactly one lane driven inline by the
    admission thread; in mesh mode each lane owns a worker thread
    draining its queue, so one slow or dead device stalls only the
    windows placed on it.  Every field here is guarded by the owning
    scheduler's ``self._lock``.
    """

    __slots__ = ("index", "target", "queue", "thread", "breaker",
                 "breaker_until", "inflight_rows", "queued_rows",
                 "max_queue_depth", "stats")

    def __init__(self, index: int, target):
        self.index = index
        self.target = target
        self.queue: deque = deque()  # (batch, reason)
        self.thread: threading.Thread | None = None
        self.breaker = "closed"      # "closed" | "open"
        self.breaker_until = 0.0
        self.inflight_rows = 0       # rows at the device right now
        self.queued_rows = 0         # rows waiting in self.queue
        self.max_queue_depth = 0     # high-water of len(self.queue)
        self.stats = {
            "batches": 0, "rows": 0, "bucket_rows": 0,
            "host_diverted": 0, "straggler_diverts": 0,
            "device_errors": 0, "breaker_trips": 0,
            "breaker_probes": 0, "breaker_diverted": 0,
            "pipeline_windows": 0, "pipeline_overlapped": 0,
        }

    def load(self) -> int:
        """Placement score: rows waiting plus rows in flight."""
        return self.queued_rows + self.inflight_rows


class _PendingWindow:
    """One window's begin-to-finish state in the split-phase pipeline.

    ``_begin_batch`` fills it (and, on a pipeline-capable target, leaves
    the staged+dispatched device computation in ``staged``);
    ``_finish_batch`` collects, records and resolves it.  A lane worker
    holds at most ONE of these in flight — beginning window k+1 before
    finishing window k is exactly the H2D/compute/D2H overlap.
    """

    __slots__ = ("batch", "keys", "reason", "t0", "rows", "results",
                 "staged", "probing", "diverted", "computed", "failure",
                 "traced", "finished", "t_dispatch", "t_collect", "ticket")


class _WindowTicket:
    """Shared placement identity for one mesh window and (when hedged)
    its speculative duplicate.

    Lane queues hold tickets; the straggler monitor re-places a ticket
    whose wall-clock age exceeds its lane's flight-derived threshold
    onto the least-loaded sibling lane, so the SAME ticket can sit in
    two queues at once.  ``winner`` is claimed under the scheduler lock
    by the first dispatch to finish: the loser is either *cancelled*
    (still queued at claim time — dropped at pop, never touches a
    device) or *wasted* (already executing — its results are discarded
    and it skips ``_record_window``, so stats, journal events, flight
    entries and ledger charges all happen exactly once per window).
    Every field is guarded by the owning scheduler's ``self._lock``
    except ``batch``/``reason``/``klass``/``rows``/``lane``, which are
    immutable after construction.
    """

    __slots__ = ("batch", "reason", "klass", "rows", "lane",
                 "hedge_lane", "t_placed", "hedged", "winner")

    def __init__(self, batch, reason: str, klass: str, lane: int):
        self.batch = batch
        self.reason = reason
        self.klass = klass           # "consensus" | "bulk"
        self.rows = len(batch)
        self.lane = lane             # primary placement lane index
        self.hedge_lane = None       # sibling index once hedged
        # Straggler aging is wall-clock by nature: a stuck lane freezes
        # the sim's virtual clock, so a virtual-time age could never
        # fire.  Hedges journal nothing, so determinism holds.
        # analysis: allow-determinism(hedge aging; hedges journal nothing)
        self.t_placed = time.monotonic()
        self.hedged = False
        self.winner = None           # winning lane index once recorded


class VerifierScheduler:
    """Coalescing dispatch front-end over a batch verifier.

    Facade-compatible with the verifier it wraps: ``recover_addresses``
    / ``recover_signers`` / ``ecrecover`` / ``verify`` all exist, so the
    chain, txpool, EVM precompile, and consensus node can hold a
    scheduler wherever they previously held a ``BatchVerifier``.
    """

    def __init__(self, verifier, *, config: SchedulerConfig | None = None,
                 breaker_clock=None, **overrides):
        # config consolidation: explicit kwargs (the historical
        # ``window_ms=``/``max_batch=``/... surface every call site
        # already uses) override a copy of the passed config, which
        # itself defaults to SchedulerConfig.from_env() — so env sweeps,
        # config objects and legacy kwargs compose without ambiguity
        cfg = config if config is not None else SchedulerConfig.from_env()
        if overrides:
            cfg = replace(cfg, **overrides)
        self.config = cfg
        self._verifier = verifier
        window_ms = cfg.window_ms
        if cfg.adaptive:
            # the controller moves the deadline inside
            # [min_window_ms, max_window_ms]; start inside the band
            window_ms = min(max(window_ms, cfg.min_window_ms),
                            cfg.max_window_ms)
        self._window_s = window_ms / 1e3  # guarded-by: _lock
        self.max_batch = cfg.max_batch
        self.cache_size = cfg.cache_size
        # injectable device-failure hook (chaos harness / tests): called
        # with the row count right before every device dispatch, on any
        # lane; raising is treated exactly like the device itself
        # raising.  Per-lane kills go through the lane target's own
        # ``failure_hook`` instead.
        self.failure_hook = None
        # circuit breaker around each lane's device path: a device
        # exception trips that lane OPEN (its windows host-divert, no
        # device calls) for ``breaker_cooldown_s``; the first window
        # after the cooldown is a HALF-OPEN probe — success closes the
        # lane's breaker, failure re-opens it.  ``breaker_clock`` is
        # injectable so chaos runs can measure the cooldown in
        # deterministic virtual time.
        self.breaker_cooldown_s = cfg.breaker_cooldown_s
        self.breaker_clock = breaker_clock or time.monotonic
        # ONE condition guards every mutable field below (including all
        # lane queues); dispatch + lane threads wait on it.
        self._lock = threading.Condition()
        # one window lane per device the verifier exposes; a verifier
        # without device_targets() is itself the single lane's target
        targets = None
        probe = getattr(verifier, "device_targets", None)
        if callable(probe):
            targets = list(probe())
        if not targets:
            targets = [verifier]
        self._lanes = [_DeviceLane(i, t) for i, t in enumerate(targets)]
        # host fallback: a target may answer ``host_fallback = False``
        # (the port's BatchVerifier does), and then no row is served by
        # the host model: singletons go to the device, a device error
        # fails its window's futures (the breaker never opens), and a
        # row submitted after close() fails instead of recovering inline
        self._host_fallback = all(
            getattr(lane.target, "host_fallback", True)
            for lane in self._lanes)
        # double-buffered pipeline capability: targets exposing the
        # split-phase stage/commit/collect trio get their windows run
        # on a lane worker even single-lane, so window k+1's H2D
        # staging overlaps window k's compute + D2H.  Native verifiers
        # don't expose it — sims keep the inline path and its
        # byte-deterministic event ordering.
        self._pipelined = any(
            callable(getattr(lane.target, "stage_recover", None))
            for lane in self._lanes)
        # placement: a window larger than this splits across lanes
        # (floor min_split keeps chunks worth a device dispatch)
        self.min_split = max(1, cfg.min_split)
        self._chunk_cap = max(self.min_split,
                              -(-cfg.max_batch // len(self._lanes)))
        self._rr = 0  # round-robin cursor breaking equal-load ties
        # LRU recovery cache: (sighash, sig) -> 20-byte address or None
        # (a deterministic recovery failure is cached too — re-gossiped
        # garbage must not re-reach the device either)
        self._cache: OrderedDict[tuple, object] = OrderedDict()  # guarded-by: _lock
        # key -> [futures, t_submit, klass]: identical in-flight keys
        # share one row (in-batch dedup), arrival order preserved.
        # ``klass`` is the priority class ("consensus" | "bulk"): dedup
        # promotes a shared row to the higher class, and the flush
        # selects consensus rows first when the window cannot take
        # everything pending.
        self._pending: OrderedDict[tuple, list] = OrderedDict()  # guarded-by: _lock
        # key -> trace id of the submitter's active span (txpool ingest,
        # quorum verify): commit-anatomy linkage tying flight-recorder
        # windows back to the transactions that rode them.  Bounded like
        # the ingest-context map; entries pop when their window records.
        self._pending_trace: dict[tuple, str] = {}  # guarded-by: _lock
        self._PENDING_TRACE_CAP = 8192
        # key -> (ledger, origin) captured at submit (utils/ledger.py):
        # the window executes on the dispatch/lane thread where the
        # submitter's ambient binding is gone, so each row's share of
        # the window cost charges the captured pair when it records.
        # Same cap discipline as the trace map; entries pop with their
        # window (in-flight dedup keeps the FIRST submitter's origin).
        self._pending_origin: dict[tuple, tuple] = {}  # guarded-by: _lock
        # cache-served rows since the last recorded window: cache hits
        # never reach a window, so without this the flight rows (and the
        # cheap-reject cost math over them) under-count a warm-cache
        # flood as free — drained into flight["cache_rows"]
        self._cache_rows_pending = 0  # guarded-by: _lock
        # in-flight-deduped rows since the last recorded window — the
        # same drain discipline as cache rows, feeding the goodput
        # ledger's waste decomposition (utils/devstats.py)
        self._dedup_rows_pending = 0  # guarded-by: _lock
        self._kick = False  # guarded-by: _lock
        self._closed = False
        # set once the dispatch loop exits
        self._admission_done = False  # guarded-by: _lock
        self._thread: threading.Thread | None = None
        self._stats = {  # guarded-by: _lock
            "cache_hits": 0, "cache_misses": 0, "cache_served_rows": 0,
            "coalesced_rows": 0,
            "batches": 0, "rows": 0, "bucket_rows": 0, "host_diverted": 0,
            "kicks": 0, "flush_full": 0, "flush_deadline": 0,
            "flush_kick": 0, "flush_close": 0, "invalid": 0,
            "device_errors": 0, "breaker_trips": 0, "breaker_probes": 0,
            "breaker_diverted": 0, "window_splits": 0,
            "straggler_diverts": 0, "pipeline_windows": 0,
            "pipeline_overlapped": 0,
            # hedged re-dispatch accounting: every hedge ends as either
            # a cancelled loser (never ran) or a wasted loser (ran,
            # discarded) — hedges == hedge_cancelled + hedge_wasted at
            # quiescence is the exactly-once recording invariant
            "hedges": 0, "hedge_wins": 0, "hedge_cancelled": 0,
            "hedge_wasted": 0,
            # closed-loop controller + flight-ring loss accounting
            "adapt_decisions": 0, "flight_dropped": 0,
            # window-granular admissions (submit_window): whole ingest
            # windows entering in ONE lock hold instead of row-by-row
            "window_submits": 0, "window_rows": 0,
        }
        # optional consensus event journal (utils/journal.py), attached
        # by the first owning node; flush decisions land in its stream
        self.journal = None
        # window flight recorder: every computed window's
        # submit->place->stage->compute->collect->resolve lifecycle with
        # lane/device attribution, in a bounded ring behind the
        # thw_flight RPC and the observatory waterfall.  Wall-clock by
        # nature (it measures real phase durations) and never journaled,
        # so it stays outside the determinism contract.  The ring size
        # is configurable (flight_ring) and an append that evicts the
        # oldest entry counts into stats["flight_dropped"] +
        # verifier.flight_dropped — silent loss under load is visible.
        self._flights: deque = deque(maxlen=max(1, cfg.flight_ring))  # guarded-by: _lock
        self._flight_seq = 0  # guarded-by: _lock
        # adaptive windowing: the controller consumes recent flight
        # timings plus the SLO burn probe and steers the flush deadline
        # (_window_s) and target bucket (_target_rows) per window
        self._adaptive = cfg.adaptive
        self._target_rows = cfg.max_batch  # guarded-by: _lock
        self._adapt_windows = 0  # guarded-by: _lock
        # injectable SLO feedback: a zero-arg callable returning the
        # (fast, slow) burn-rate pair of the commit-latency objective
        # (harness/slo.py SLOEngine.burn_probe); set like failure_hook /
        # breaker_clock before traffic.  Without one the controller
        # derives burn from recent window p99 against config.slo_p99_ms.
        self.burn_probe = None
        # per-class queue-wait samples (ms) behind stats()'s
        # class_wait_ms percentiles — the bench adaptive stage reads
        # per-class p99 here without scraping the labeled histograms
        self._class_waits = {
            "bulk": deque(maxlen=2048),
            "consensus": deque(maxlen=2048),
        }  # guarded-by: _lock
        # hedged re-dispatch: live (unrecorded) window tickets the
        # straggler monitor scans; mesh-only — with one lane there is
        # no sibling to hedge onto
        self._hedge_on = bool(cfg.hedge) and len(self._lanes) > 1
        self._hedge_poll_s = max(0.5e-3, cfg.hedge_poll_ms / 1e3)
        self._tickets: set = set()  # guarded-by: _lock
        self._hedge_thread: threading.Thread | None = None
        if len(self._lanes) > 1:
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            metrics.gauge("verifier.mesh_devices").set(len(self._lanes))

    # -- public async API -------------------------------------------------

    def submit(self, sighash: bytes, sig: bytes,
               priority: str = "bulk") -> Future:  # thread-entry hot-path-entry
        """Queue one ``(sighash32, sig65)`` recovery; the future resolves
        to the 20-byte signer address, or ``None`` for an invalid
        signature.  Cache hits resolve immediately; misses ride the next
        coalesced batch.

        ``priority`` is the window class: ``"consensus"`` rows
        (election acks, QC checks — anything consensus blocks on) are
        flushed ahead of ``"bulk"`` tx-ingest rows when a window can't
        take everything pending, and their windows preempt bulk windows
        at lane placement.  In-flight dedup promotes a shared row to
        the higher class."""
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        klass = "consensus" if priority == "consensus" else "bulk"
        fut: Future = Future()
        if len(sig) != 65 or len(sighash) != 32:
            # malformed entries never reach the device (the zero-fill
            # rows of verify_host.recover_signers recover as invalid —
            # same observable result, no batch slot burned)
            with self._lock:
                self._stats["invalid"] += 1
            # invalid-sig early-out: billed to the ambient ingress
            # origin (utils/ledger.py) — the cheapest reject there is,
            # which is exactly why a flood of them must stay attributed
            ledger.charge(rejects=1)
            fut.set_result(None)
            return fut
        key = (bytes(sighash), bytes(sig))
        resolve = _MISS
        with self._lock:
            hit = self._cache.get(key, _MISS)
            if hit is not _MISS:
                self._cache.move_to_end(key)
                self._stats["cache_hits"] += 1
                # a cache-served row is still a served row: without this
                # accounting a 100% warm-cache flood looks free in
                # stats()/flight rows (drained into the next window's
                # flight entry as cache_rows)
                self._stats["cache_served_rows"] += 1
                self._cache_rows_pending += 1
                resolve = hit
            elif self._closed:
                # post-close stragglers execute inline on the caller —
                # the contract is "no lost futures", not "no work"
                self._stats["cache_misses"] += 1
                resolve = self._post_close(key)
                if not isinstance(resolve, BaseException):
                    self._cache_put(key, resolve)
            else:
                self._stats["cache_misses"] += 1
                row = self._pending.get(key)
                if row is not None:
                    # in-flight dedup: same signature already queued by
                    # another caller — share its batch row (and promote
                    # it if this caller is consensus-critical)
                    row[0].append(fut)
                    self._stats["coalesced_rows"] += 1
                    self._dedup_rows_pending += 1
                    if klass == "consensus":
                        row[2] = "consensus"
                else:
                    # analysis: allow-determinism(coalescing deadline is real-time by contract; chaos pins batching via max_batch kicks)
                    self._pending[key] = [[fut], time.monotonic(), klass]
                    from eges_tpu_torch.utils import tracing
                    ctx = tracing.DEFAULT.current_context()
                    if (ctx is not None and len(self._pending_trace)
                            < self._PENDING_TRACE_CAP):
                        self._pending_trace[key] = ctx.trace_id
                    rec = ledger.current()
                    if (rec is not None and len(self._pending_origin)
                            < self._PENDING_TRACE_CAP):
                        self._pending_origin[key] = rec
                    self._ensure_thread()
                if len(self._pending) >= self._flush_target():
                    self._kick = True
                self._lock.notify_all()
        if resolve is not _MISS:
            metrics.counter("verifier.cache_hits" if hit is not _MISS
                            else "verifier.cache_misses").inc()
            ledger.charge(cache_hits=1 if hit is not _MISS else 0,
                          cache_misses=0 if hit is not _MISS else 1)
            if isinstance(resolve, BaseException):
                fut.set_exception(resolve)
            else:
                fut.set_result(resolve)
            return fut
        metrics.counter("verifier.cache_misses").inc()
        ledger.charge(cache_misses=1)
        return fut

    def kick(self) -> None:  # thread-entry hot-path-entry
        """Flush the current micro-window immediately: synchronous
        callers (quorum tallies under the virtual-time sim clock) must
        not sleep out the real-time deadline."""
        with self._lock:
            if self._pending:
                self._kick = True
                self._stats["kicks"] += 1
                self._lock.notify_all()

    # -- synchronous facades (BatchVerifier-compatible) -------------------

    def recover_signers(self, entries, *, priority: str = "bulk") -> list:
        """Batch-recover ``(sighash32, sig65)`` entries; one 20-byte
        address or ``None`` per entry.  Submits everything, kicks the
        window (coalescing with whatever else is pending right now), and
        blocks for the results — ``verify_host.recover_signers``
        delegates here when the node's verifier is a scheduler.
        ``priority="consensus"`` marks the rows consensus-critical (see
        :meth:`submit`)."""
        futs = [self.submit(h, s, priority) for h, s in entries]
        self.kick()
        out = []
        for (h, s), f in zip(entries, futs):
            try:
                out.append(f.result())
            # analysis: allow-swallow(a torn-down scheduler fails futures
            # with an error; consensus keeps committing on the host path)
            except Exception:
                if not self._host_fallback:
                    raise
                out.append(self._host_recover((bytes(h), bytes(s)))
                           if len(s) == 65 and len(h) == 32 else None)
        return out

    def recover_addresses(self, sigs: np.ndarray, hashes: np.ndarray,
                          *, priority: str = "bulk"):
        """Array-in/array-out facade matching
        ``BatchVerifier.recover_addresses`` so the txpool window flush,
        block body validation, and the EVM ecrecover precompile route
        through the cache/coalescer unchanged."""
        n = sigs.shape[0]
        addrs = np.zeros((n, 20), np.uint8)
        ok = np.zeros((n,), bool)
        if n == 0:
            return addrs, ok
        rec = self.recover_signers(
            [(bytes(hashes[i]), bytes(sigs[i])) for i in range(n)],
            priority=priority)
        for i, r in enumerate(rec):
            if r is not None:
                addrs[i] = np.frombuffer(r, np.uint8)
                ok[i] = True
        return addrs, ok

    def submit_window(self, hashes: np.ndarray, sigs: np.ndarray,
                      priority: str = "bulk") -> _WindowRows:
        """Window-granular :meth:`submit`: a whole columnar ingest
        window — ``hashes`` (n,32) / ``sigs`` (n,65) uint8 rows — enters
        in ONE lock acquisition with a batched cache probe + in-flight
        dedup sweep, and returns ONE :class:`_WindowRows` instead of N
        row futures.  Cache/dedup accounting aggregates into single
        counter bumps and the cache-hit/miss split bills the ambient
        ingress origin as ONE ``charge()`` for the whole window (N unit
        charges at one timestamp sum to the same ledger state).  Row
        semantics — LRU touch, post-close inline recovery, class
        promotion, trace/origin capture — match per-row submit exactly."""
        from eges_tpu_torch.utils import tracing
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        n = len(hashes)
        win = _WindowRows(n)
        if n == 0:
            win._try_finish()
            return win
        if hashes.shape[1] != 32 or sigs.shape[1] != 65:
            raise ValueError("window arrays must be (n,32) and (n,65)")
        klass = "consensus" if priority == "consensus" else "bulk"
        n_hits = 0
        with self._lock:
            # analysis: allow-determinism(coalescing deadline is real-time by contract; chaos pins batching via max_batch kicks)
            t_now = time.monotonic()
            ctx = tracing.DEFAULT.current_context()
            tid = ctx.trace_id if ctx is not None else None
            rec = ledger.current()
            added = False
            for i in range(n):
                key = (bytes(hashes[i]), bytes(sigs[i]))
                hit = self._cache.get(key, _MISS)
                if hit is not _MISS:
                    self._cache.move_to_end(key)
                    n_hits += 1
                    self._cache_rows_pending += 1
                    win.prefill(i, hit)
                    continue
                if self._closed:
                    # post-close stragglers execute inline on the
                    # caller — no lost rows, same as per-row submit
                    v = self._post_close(key)
                    if not isinstance(v, BaseException):
                        self._cache_put(key, v)
                    win.prefill(i, v)
                    continue
                row = self._pending.get(key)
                if row is not None:
                    # in-flight dedup (intra-window duplicates land
                    # here too: the first occurrence owns the batch
                    # row, later ones share it)
                    row[0].append(_WindowSlot(win, i))
                    self._stats["coalesced_rows"] += 1
                    self._dedup_rows_pending += 1
                    if klass == "consensus":
                        row[2] = "consensus"
                else:
                    self._pending[key] = [[_WindowSlot(win, i)], t_now,
                                          klass]
                    if (tid is not None and len(self._pending_trace)
                            < self._PENDING_TRACE_CAP):
                        self._pending_trace[key] = tid
                    if (rec is not None and len(self._pending_origin)
                            < self._PENDING_TRACE_CAP):
                        self._pending_origin[key] = rec
                    added = True
            self._stats["cache_hits"] += n_hits
            self._stats["cache_served_rows"] += n_hits
            self._stats["cache_misses"] += n - n_hits
            self._stats["window_submits"] += 1
            self._stats["window_rows"] += n
            if added:
                self._ensure_thread()
            if len(self._pending) >= self._flush_target():
                self._kick = True
            self._lock.notify_all()
        if n_hits:
            metrics.counter("verifier.cache_hits").inc(n_hits)
        if n > n_hits:
            metrics.counter("verifier.cache_misses").inc(n - n_hits)
        ledger.charge(cache_hits=n_hits, cache_misses=n - n_hits)
        win._try_finish()  # all-prefilled windows complete right here
        return win

    def recover_window(self, hashes: np.ndarray, sigs: np.ndarray,
                       *, priority: str = "bulk") -> list:
        """Synchronous window facade: :meth:`submit_window`, one kick,
        one blocking wait — ``verify_host.recover_signers_window``
        delegates here when the pool's verifier is a scheduler.  Rows a
        torn-down scheduler failed fall back to host recovery, exactly
        like :meth:`recover_signers`."""
        win = self.submit_window(hashes, sigs, priority)
        self.kick()
        out = win.result()
        fixed = None
        for i, v in enumerate(out):
            if isinstance(v, BaseException):
                if not self._host_fallback:
                    raise v
                if fixed is None:
                    fixed = list(out)
                fixed[i] = self._host_recover(
                    (bytes(hashes[i]), bytes(sigs[i])))
        return fixed if fixed is not None else out

    def ecrecover(self, sigs: np.ndarray, hashes: np.ndarray):
        """Full-pubkey recovery delegates straight to the backing
        verifier: the cache stores addresses only (the sigCache role),
        and the sole ``pubs`` consumer is the startup warmup."""
        return self._verifier.ecrecover(sigs, hashes)

    def verify(self, sigs: np.ndarray, hashes: np.ndarray,
               pubs: np.ndarray):
        """Classic known-pubkey verify is not address recovery — pass
        through to the backing verifier's batched path."""
        return self._verifier.verify(sigs, hashes, pubs)

    # -- lifecycle --------------------------------------------------------

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self, timeout: float | None = 30.0) -> None:  # thread-entry
        """Drain every pending future, then stop and join every thread —
        no lost futures, no leaked threads.

        The drain order is deterministic and documented:

        1. the admission front flushes whatever is pending as one final
           ``flush_close`` window (placed/run like any other) and the
           dispatch thread exits;
        2. each device lane drains its queue FIFO — lane workers exit
           only after the admission thread is done, so a final window
           placed during shutdown is always served — and lanes are
           joined in ascending device index;
        3. anything still unresolved (a dead thread or a join timeout)
           is FAILED rather than left to hang callers: lane queues
           first in ascending device index (FIFO within each lane), the
           admission front last.
        """
        with self._lock:
            self._closed = True
            self._kick = True
            self._lock.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)
        with self._lock:
            # the admission thread sets this on exit; force it if the
            # thread never ran or the join timed out, so lane workers
            # can stop waiting for more placements
            self._admission_done = True
            self._lock.notify_all()
            lane_threads = [lane.thread for lane in self._lanes]
            hedge_thread = self._hedge_thread
        for lt in lane_threads:
            if lt is not None:
                lt.join(timeout)
        if hedge_thread is not None:
            hedge_thread.join(timeout)
        leftovers: list[list] = []
        with self._lock:
            seen_tickets: set = set()
            for lane in self._lanes:
                while lane.queue:
                    tk = lane.queue.popleft()
                    lane.queued_rows -= tk.rows
                    # a hedged ticket can sit in two queues; drain its
                    # rows once, and skip tickets a dispatch already won
                    if tk in seen_tickets or tk.winner is not None:
                        continue
                    seen_tickets.add(tk)
                    leftovers.extend(row for _k, row in tk.batch)
            self._tickets.clear()
            leftovers.extend(self._pending.values())
            self._pending.clear()
            self._pending_trace.clear()
            self._pending_origin.clear()
        for row in leftovers:
            for f in row[0]:
                if not f.done():
                    f.set_exception(RuntimeError(
                        "verifier scheduler closed with unresolved futures"))

    def stats(self) -> dict:
        """Snapshot of scheduler counters (tests and the bench stage
        read deltas here instead of the process-global registry).  The
        flat keys are scheduler-wide aggregates — exactly the pre-mesh
        surface — plus ``lanes`` and a ``devices`` list of per-lane
        breakdowns (queue depth, in-flight rows, breaker state, rows /
        batches / diverts / occupancy per device)."""
        with self._lock:
            out = dict(self._stats)
            out["cached_entries"] = len(self._cache)
            out["pending"] = len(self._pending)
            out["breaker"] = ("open" if any(
                lane.breaker == "open" for lane in self._lanes)
                else "closed")
            out["lanes"] = len(self._lanes)
            out["pipeline_overlap_ratio"] = (
                round(out["pipeline_overlapped"]
                      / out["pipeline_windows"], 4)
                if out["pipeline_windows"] else 0.0)
            devices = []
            for lane in self._lanes:
                d = {"device": lane.index,
                     "queue_depth": len(lane.queue),
                     "max_queue_depth": lane.max_queue_depth,
                     "inflight_rows": lane.inflight_rows,
                     "breaker": lane.breaker}
                d.update(lane.stats)
                d["occupancy"] = (
                    round(lane.stats["rows"] / lane.stats["bucket_rows"], 4)
                    if lane.stats["bucket_rows"] else None)
                d["pipeline_overlap_ratio"] = (
                    round(lane.stats["pipeline_overlapped"]
                          / lane.stats["pipeline_windows"], 4)
                    if lane.stats["pipeline_windows"] else 0.0)
                devices.append(d)
            out["devices"] = devices
            out["flight_windows"] = self._flight_seq
            out["flight_capacity"] = self._flights.maxlen
            out["adaptive"] = self._adaptive
            out["window_ms"] = round(self._window_s * 1e3, 4)
            out["target_rows"] = self._target_rows
            from eges_tpu_torch.utils.metrics import percentile
            class_wait = {}
            for klass in sorted(self._class_waits):
                vals = sorted(self._class_waits[klass])
                class_wait[klass] = {
                    "count": len(vals),
                    "p50_ms": round(percentile(vals, 50.0), 3),
                    "p99_ms": round(percentile(vals, 99.0), 3),
                }
            out["class_wait_ms"] = class_wait
        return out

    def flights(self, limit: int = 0) -> list[dict]:
        """Flight-recorder entries, oldest first (the ring keeps the
        newest ``config.flight_ring`` windows — default 256 — and
        evictions count into ``stats()["flight_dropped"]`` /
        ``verifier.flight_dropped``); ``limit`` keeps only the newest
        N.  Each
        entry is one window's lifecycle: phase timestamps
        (``t_submit``/``t_begin``/``t_dispatch``/``t_collect``/
        ``t_done``), phase durations, and lane/device attribution."""
        with self._lock:
            evs = list(self._flights)
        if limit and limit > 0:
            evs = evs[-limit:]
        return [dict(f) for f in evs]

    # -- internals --------------------------------------------------------

    def _flush_target(self) -> int:
        """Rows that flush a window as "full" right now — ``max_batch``
        statically, the controller's ``_target_rows`` (never above the
        cap) when adaptive.  Caller holds ``self._lock``."""
        return min(self.max_batch, max(1, self._target_rows))

    def _ensure_thread(self) -> None:
        # caller holds self._lock
        if self._thread is None or not self._thread.is_alive():
            self._admission_done = False
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="verifier-scheduler",
                daemon=True)
            self._thread.start()

    def _ensure_lane_thread(self, lane: _DeviceLane) -> None:
        # caller holds self._lock; lane workers start lazily on first
        # placement so single-lane schedulers never spawn them
        if lane.thread is None or not lane.thread.is_alive():
            lane.thread = threading.Thread(
                target=self._lane_loop, args=(lane,),
                name=f"verifier-lane-{lane.index}", daemon=True)
            lane.thread.start()

    def _cache_put(self, key: tuple, addr) -> None:
        # caller holds self._lock
        self._cache[key] = addr
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def _post_close(self, key: tuple):
        """A row submitted after close(): recovered inline on the host
        where host fallback is on, else refused (an exception value)."""
        if self._host_fallback:
            return self._host_recover(key)
        return RuntimeError("the verifier scheduler is closed")

    def _host_recover(self, key: tuple):
        """One host-path recovery (native C++ single recover when built,
        pure-Python model otherwise) — the divert target for flushes
        that coalesced down to a single row, and the post-close inline
        path.  Counts into ``verifier.host_rows`` like every other host
        fallback so the device-share metric stays honest."""
        with profiler.phase("verify_compute"):
            h, sig = key
            from eges_tpu_torch.crypto.verify_host import _count_host_rows
            _count_host_rows(1)
            from eges_tpu_torch.crypto import native
            if native.available():
                from eges_tpu_torch.crypto.keccak import keccak256
                pubs, okb = native.ec_recover_batch(h, sig, 1)
                return keccak256(pubs[:64])[12:] if okb[0] else None
            from eges_tpu_torch.crypto import secp256k1 as host
            try:
                return host.recover_address(h, sig)
            # analysis: allow-swallow(invalid signature maps to a None result)
            except Exception:
                return None

    def _dispatch_loop(self) -> None:
        """Wrapper keeping the strand-no-future invariant: if the flush
        loop itself dies on an unexpected error, every queued future is
        failed with that error instead of hanging its caller forever
        (``_ensure_thread`` restarts a thread on the next submit)."""
        try:
            self._dispatch_forever()
        except BaseException as exc:
            with self._lock:
                leftovers = list(self._pending.values())
                self._pending.clear()
            for row in leftovers:
                for f in row[0]:
                    if not f.done():
                        f.set_exception(exc)
            raise
        finally:
            with self._lock:
                # lane workers drain-and-exit only once the admission
                # front can place no further windows
                self._admission_done = True
                self._lock.notify_all()

    def _dispatch_forever(self) -> None:  # hot-path-entry
        """Background flush loop: wait for work, coalesce inside the
        micro-window, place/dispatch ONE window, repeat.  Exits only
        once closed AND drained."""
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if not self._pending and self._closed:
                    return
                # coalescing window: more submitters may land until the
                # bucket fills (the adaptive controller's target, capped
                # at max_batch), a sync caller kicks, close drains, or
                # the deadline measured from the OLDEST entry expires —
                # both the target and the deadline are re-read each
                # iteration so a controller decision applies to the
                # window being coalesced right now
                while (len(self._pending) < self._flush_target()
                        and not self._kick and not self._closed
                        and self._pending):
                    oldest = next(iter(self._pending.values()))[1]
                    # analysis: allow-determinism(window-expiry wait is the real-time contract; chaos batch membership is pinned by max_batch kicks)
                    left = self._window_s - (time.monotonic() - oldest)
                    if left <= 0:
                        break
                    self._lock.wait(left)
                if not self._pending:
                    continue
                # "close" outranks "kick": close() raises the kick flag
                # to wake the window wait, and the shutdown drain must
                # be journaled as the documented flush_close step
                limit = self._flush_target()
                reason = ("full" if len(self._pending) >= limit
                          else "close" if self._closed
                          else "kick" if self._kick else "deadline")
                self._stats["flush_" + reason] += 1
                if len(self._pending) > limit:
                    # overfull window: consensus-class rows outrank bulk
                    # for the seats this flush has (within a class,
                    # arrival order is preserved)
                    keys = [k for k, row in self._pending.items()
                            if row[2] == "consensus"][:limit]
                    if len(keys) < limit:
                        taken = set(keys)
                        keys += [k for k in self._pending
                                 if k not in taken][:limit - len(keys)]
                else:
                    keys = list(self._pending)
                batch = [(k, self._pending.pop(k)) for k in keys]
                if not self._pending:
                    self._kick = False
            if (len(self._lanes) > 1 or self._pipelined) and (
                    len(batch) > 1 or not self._host_fallback):
                # mesh windows go to the per-device lanes; single-lane
                # pipeline-capable targets ALSO route through the lane
                # worker, whose begin/finish split overlaps consecutive
                # windows (inline dispatch can't — it must block).
                # Without host fallback a singleton runs on the device
                # too, so it takes the lane: only the lane's worker
                # drives the target's split-phase trio
                self._place(batch, reason)
                continue
            try:
                # single-lane (or singleton) windows dispatch inline on
                # this thread — the pre-mesh behavior, no lane workers
                self._run_batch(self._lanes[0], batch, reason)
            # the batch's futures were already resolved or failed inside
            # _run_batch's finally; the loop survives to the next window
            # analysis: allow-swallow(futures already resolved/failed in _run_batch finally)
            except Exception:
                pass

    # -- mesh placement ---------------------------------------------------

    def _place(self, batch, reason: str) -> None:
        """Place one flushed window onto the device lanes.

        A window at most ``chunk_cap = max(min_split, max_batch/lanes)``
        rows fills the single least-loaded lane; a larger one splits
        into contiguous near-equal chunks (each >= ``min_split`` rows)
        placed on DISTINCT lanes in ascending load order, so a
        saturating window reaches every device at once.  Equal-load
        ties rotate round-robin — an idle mesh still spreads
        back-to-back windows instead of pinning device 0.

        A window carrying any consensus-class row is placed at the HEAD
        of its lane's queue (placement preemption): queued bulk
        tx-ingest windows wait, already-dispatched ones are not
        interrupted.
        """
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        rows = len(batch)
        n_chunks = 1
        if rows > self._chunk_cap:
            n_chunks = min(len(self._lanes), -(-rows // self._chunk_cap))
            n_chunks = min(n_chunks, max(1, rows // self.min_split))
        size = -(-rows // n_chunks)
        chunks = [batch[i:i + size] for i in range(0, rows, size)]
        klass = ("consensus" if any(row[2] == "consensus"
                                    for _k, row in batch) else "bulk")
        # queue depths are captured under the lock and emitted after it:
        # the metrics registry takes its own lock, and nesting it inside
        # the scheduler condition would order-couple the two on every
        # window placement (fail-under-lock)
        depth_updates: list[tuple[int, int]] = []
        with self._lock:
            order = sorted(
                self._lanes,
                key=lambda L: (L.load(),
                               (L.index - self._rr) % len(self._lanes)))
            self._rr = (self._rr + 1) % len(self._lanes)
            if len(chunks) > 1:
                self._stats["window_splits"] += 1
            for chunk, lane in zip(chunks, order):
                tk = _WindowTicket(chunk, reason, klass, lane.index)
                if klass == "consensus":
                    lane.queue.appendleft(tk)
                else:
                    lane.queue.append(tk)
                self._tickets.add(tk)
                lane.queued_rows += tk.rows
                lane.max_queue_depth = max(lane.max_queue_depth,
                                           len(lane.queue))
                depth_updates.append((lane.index, len(lane.queue)))
                self._ensure_lane_thread(lane)
            if self._hedge_on:
                self._ensure_hedge_thread()
            self._lock.notify_all()
        if len(chunks) > 1:
            metrics.counter("verifier.mesh_window_splits").inc()
        for index, depth in depth_updates:
            metrics.gauge(
                f"verifier.mesh_queue_depth;device={index}").set(depth)

    def _lane_loop(self, lane: _DeviceLane) -> None:  # hot-path-entry
        """One device lane's worker: drain the lane queue FIFO; on an
        unexpected loop death fail THIS lane's queued futures — other
        lanes keep serving (straggler isolation).

        On a pipeline-capable target the worker is double-buffered: it
        holds ONE collected-later window in ``pending`` and, when the
        queue has a successor, begins (fills + uploads + dispatches)
        that successor BEFORE blocking on ``pending``'s collect — so
        window k+1's H2D stages while window k computes and drains.
        Windows still finish strictly FIFO, so cache inserts and
        journal events keep their queue order.
        """
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        pipelined = callable(getattr(lane.target, "stage_recover", None))
        pending: _PendingWindow | None = None
        nxt_p: _PendingWindow | None = None
        try:
            while True:
                with self._lock:
                    while not lane.queue and pending is None and not (
                            self._closed and self._admission_done):
                        self._lock.wait()
                    if not lane.queue and pending is None:
                        return  # closed, admission drained, queue empty
                    nxt = None
                    depth = None
                    cancelled = False
                    if lane.queue:
                        tk = lane.queue.popleft()
                        lane.queued_rows -= tk.rows
                        depth = len(lane.queue)
                        if tk.winner is not None:
                            # the hedge raced us and its sibling dispatch
                            # already recorded this window — drop the
                            # loser before it touches the device (the
                            # "cancelled" outcome; a loser that already
                            # started finishes as "wasted" instead)
                            self._stats["hedge_cancelled"] += 1
                            self._tickets.discard(tk)
                            cancelled = True
                        else:
                            nxt = tk
                            lane.inflight_rows += tk.rows
                if depth is not None:
                    # emitted after release: the gauge takes the metrics
                    # registry lock (fail-under-lock)
                    metrics.gauge(
                        f"verifier.mesh_queue_depth;device={lane.index}") \
                        .set(depth)
                if cancelled:
                    metrics.counter("verifier.hedge_cancelled").inc()
                nxt_p: _PendingWindow | None = None
                if nxt is not None:
                    if pipelined:
                        with profiler.phase("verify_stage"):
                            nxt_p = self._begin_batch(lane, nxt.batch,
                                                      nxt.reason,
                                                      ticket=nxt)
                        if (pending is not None and nxt_p.staged is not None
                                and nxt_p.failure is None):
                            # this begin's H2D ran while the previous
                            # window was still on the device — the
                            # overlap the ratio metric reports
                            with self._lock:
                                self._stats["pipeline_overlapped"] += 1
                                lane.stats["pipeline_overlapped"] += 1
                    else:
                        try:
                            self._run_batch(lane, nxt.batch, nxt.reason,
                                            ticket=nxt)
                        # analysis: allow-swallow(futures already resolved/failed in _run_batch finally; the lane survives to its next window)
                        except Exception:
                            pass
                        finally:
                            with self._lock:
                                lane.inflight_rows -= nxt.rows
                if pending is not None:
                    self._finish_lane_window(lane, pending)
                    pending = None
                if nxt_p is not None:
                    if (nxt_p.staged is not None and not nxt_p.computed
                            and nxt_p.failure is None):
                        pending = nxt_p
                    else:
                        # host-diverted / singleton / failed windows
                        # have nothing on the device — finish them now
                        self._finish_lane_window(lane, nxt_p)
        except BaseException as exc:
            with self._lock:
                leftovers = list(lane.queue)
                lane.queue.clear()
                lane.queued_rows = 0
                for tk in leftovers:
                    self._tickets.discard(tk)
            unfinished = []
            if pending is not None and not pending.finished:
                unfinished.append(pending)
            if (nxt_p is not None and nxt_p is not pending
                    and not nxt_p.finished):
                unfinished.append(nxt_p)
            for p in unfinished:
                with self._lock:
                    lane.inflight_rows -= p.rows
                for _k, row in p.batch:
                    for f in row[0]:
                        if not f.done():
                            f.set_exception(exc)
            for tk in leftovers:
                # a hedged ticket's sibling dispatch may still win; only
                # fail futures no other lane will resolve (done() guards
                # make the race harmless either way)
                for _k, row in tk.batch:
                    for f in row[0]:
                        if not f.done():
                            f.set_exception(exc)
            raise

    def _finish_lane_window(self, lane: _DeviceLane,
                            p: _PendingWindow) -> None:
        """Collect + record + resolve one lane window, releasing its
        in-flight rows whatever happens."""
        try:
            self._finish_batch(lane, p)
        # analysis: allow-swallow(futures already resolved/failed in _finish_batch finally; the lane survives to its next window)
        except Exception:
            pass
        finally:
            with self._lock:
                lane.inflight_rows -= p.rows

    # -- breaker (per lane) -----------------------------------------------

    def _breaker_admits(self, lane: _DeviceLane) -> tuple[bool, bool]:
        """(use_device, probing): closed -> dispatch normally; open ->
        host-divert until the cooldown elapses, then admit ONE half-open
        probe window."""
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        with self._lock:
            if lane.breaker == "closed":
                return True, False
            if self.breaker_clock() >= lane.breaker_until:
                self._stats["breaker_probes"] += 1
                lane.stats["breaker_probes"] += 1
                probe = True
            else:
                return False, False
        metrics.counter("verifier.breaker_probes").inc()
        return True, probe

    def _device_error(self, lane: _DeviceLane) -> None:
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        with self._lock:
            self._stats["device_errors"] += 1
            lane.stats["device_errors"] += 1
        metrics.counter("verifier.device_errors").inc()

    def _breaker_trip(self, lane: _DeviceLane, probing: bool) -> None:
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        self._device_error(lane)
        with self._lock:
            self._stats["breaker_trips"] += 1
            lane.stats["breaker_trips"] += 1
            lane.breaker = "open"
            lane.breaker_until = self.breaker_clock() \
                + self.breaker_cooldown_s
        metrics.counter("verifier.breaker_trips").inc()
        metrics.gauge("verifier.breaker_state").set(1)
        journal = self.journal
        if journal is not None:
            journal.record("fault_breaker", state="open",
                           probe=bool(probing), device=lane.index,
                           cooldown_s=self.breaker_cooldown_s)

    def _breaker_close(self, lane: _DeviceLane) -> None:
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        with self._lock:
            lane.breaker = "closed"
            any_open = any(x.breaker == "open" for x in self._lanes)
        metrics.gauge("verifier.breaker_state").set(1 if any_open else 0)
        journal = self.journal
        if journal is not None:
            journal.record("fault_breaker", state="closed",
                           device=lane.index)

    # -- window execution -------------------------------------------------

    def _run_batch(self, lane: _DeviceLane, batch, reason: str,
                   ticket: "_WindowTicket | None" = None) -> None:
        """Dispatch one coalesced window (or mesh chunk) on ``lane``,
        OUTSIDE the scheduler lock (the device call is the long pole;
        submitters keep queueing into the next window meanwhile).  The
        inline composition of the split-phase halves: begin (fill +
        dispatch) then finish (collect + record + resolve) with no
        overlap — the pre-pipeline behavior."""
        with profiler.phase("verify_stage"):
            p = self._begin_batch(lane, batch, reason, ticket)
        self._finish_batch(lane, p)

    def _begin_batch(self, lane: _DeviceLane, batch, reason: str,
                     ticket: "_WindowTicket | None" = None) -> _PendingWindow:
        """Phase 1 of one window: singleton/breaker divert decisions,
        numpy fill, and the device dispatch.  On a pipeline-capable
        target the dispatch is split-phase (stage H2D + async commit,
        left in ``staged`` for ``_finish_batch`` to collect); otherwise
        the device call runs to completion here.  NEVER raises — any
        error lands in ``failure`` so the caller always gets a window
        to finish (and the futures always resolve there)."""
        p = _PendingWindow()
        p.batch = batch
        p.keys = [k for k, _ in batch]
        p.reason = reason
        p.ticket = ticket
        p.rows = len(batch)
        p.results = [None] * p.rows
        p.staged = None
        p.probing = False
        p.diverted = False
        p.computed = False
        p.failure = None
        p.traced = False
        p.finished = False
        p.t_dispatch = None
        p.t_collect = None
        # analysis: allow-determinism(batch latency instrumentation; dt/waited_ms are volatile-stripped)
        p.t0 = time.monotonic()
        try:
            if p.rows == 1 and self._host_fallback:
                # singleton divert: a padded 1-row device dispatch costs
                # more than one native recover — keep the device for
                # real batches and verifier.singleton_batches at zero
                p.results[0] = self._host_recover(p.keys[0])
                with self._lock:
                    self._stats["host_diverted"] += 1
                    lane.stats["host_diverted"] += 1
                p.computed = True
                return p
            use_device, p.probing = self._breaker_admits(lane)
            if not use_device:
                # breaker open: this lane's device is presumed dead
                # — the whole window takes the host recover path so
                # consensus keeps committing (other lanes are
                # unaffected: the breaker is lane-scoped)
                p.results = [self._host_recover(k) for k in p.keys]
                p.diverted = True
                with self._lock:
                    self._stats["breaker_diverted"] += p.rows
                    lane.stats["breaker_diverted"] += p.rows
                p.computed = True
                return p
            sigs = np.zeros((p.rows, 65), np.uint8)
            hashes = np.zeros((p.rows, 32), np.uint8)
            for i, (h, sig) in enumerate(p.keys):
                sigs[i] = np.frombuffer(sig, np.uint8)
                hashes[i] = np.frombuffer(h, np.uint8)
            stage = getattr(lane.target, "stage_recover", None)
            from eges_tpu_torch.utils import devstats
            # an armed device trace starts before this window's device
            # work is queued; _finish_batch steps it when the window is
            # done
            p.traced = devstats.DEFAULT.trace.claim()
            try:
                hook = self.failure_hook
                if hook is not None:
                    hook(p.rows)
                if callable(stage):
                    # split-phase: fill + H2D + async device dispatch
                    # now; the blocking collect happens in
                    # _finish_batch — possibly after the NEXT window's
                    # stage (that concurrency is the pipeline)
                    p.staged = lane.target.commit_recover(
                        stage(sigs, hashes))
                    with self._lock:
                        self._stats["pipeline_windows"] += 1
                        lane.stats["pipeline_windows"] += 1
                else:
                    with profiler.phase("verify_compute"):
                        addrs, ok = lane.target.recover_addresses(
                            sigs, hashes)
                    p.results = [bytes(addrs[i]) if ok[i] else None
                                 for i in range(p.rows)]
                    if p.probing:
                        self._breaker_close(lane)
                    p.computed = True
            # analysis: allow-swallow(a device exception diverts
            # exactly this window to the host model — the queued
            # futures still resolve correctly — and trips this
            # lane's circuit breaker for the windows after it)
            except Exception:
                if not self._host_fallback:
                    # no host fallback: the window fails
                    self._device_error(lane)
                    raise
                self._breaker_trip(lane, p.probing)
                p.results = [self._host_recover(k) for k in p.keys]
                p.diverted = True
                p.computed = True
        except BaseException as exc:
            p.failure = exc
        if p.t_dispatch is None:
            # flight-recorder stamp: dispatch phase done (device call
            # issued, inline compute complete, or host divert served)
            # analysis: allow-determinism(flight recorder timestamps are wall-clock by design and never journaled)
            p.t_dispatch = time.monotonic()
        return p

    def _finish_batch(self, lane: _DeviceLane, p: _PendingWindow) -> None:
        """Phase 2 of one window: collect the staged device result (if
        split-phase), insert into the cache, record stats/metrics/
        journal, and — always, in the ``finally`` — resolve the
        window's futures.  Re-raises the window's failure after
        resolution, matching the old ``_run_batch`` contract."""
        batch, keys, rows = p.batch, p.keys, p.rows
        mesh = len(self._lanes) > 1
        try:
            if p.failure is None and p.staged is not None and not p.computed:
                try:
                    with profiler.phase("verify_collect"):
                        addrs, ok = lane.target.collect_recover(p.staged)
                    p.results = [bytes(addrs[i]) if ok[i] else None
                                 for i in range(rows)]
                    if p.probing:
                        self._breaker_close(lane)
                # analysis: allow-swallow(a device exception surfacing
                # at collect diverts exactly this window to the host
                # model and trips the lane breaker, like a synchronous
                # dispatch failure would)
                except Exception:
                    if not self._host_fallback:
                        self._device_error(lane)
                        raise
                    self._breaker_trip(lane, p.probing)
                    p.results = [self._host_recover(k) for k in keys]
                    p.diverted = True
                p.computed = True
                # analysis: allow-determinism(flight recorder timestamps are wall-clock by design and never journaled)
                p.t_collect = time.monotonic()
            if p.failure is None and p.computed:
                won = True
                tk = p.ticket
                if tk is not None:
                    hedge_won = False
                    with self._lock:
                        if tk.winner is None:
                            # first dispatch to finish claims the window
                            tk.winner = lane.index
                            self._tickets.discard(tk)
                            if tk.hedged and lane.index == tk.hedge_lane:
                                self._stats["hedge_wins"] += 1
                                hedge_won = True
                        else:
                            # the sibling dispatch won while we computed:
                            # discard these (bit-identical) results —
                            # skipping _record_window keeps stats,
                            # journal, flights and ledger charges
                            # exactly-once per window
                            won = False
                            self._stats["hedge_wasted"] += 1
                    if hedge_won:
                        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
                        metrics.counter("verifier.hedge_wins").inc()
                    elif not won:
                        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
                        metrics.counter("verifier.hedge_wasted").inc()
                        # a loser window burned a full padded bucket on
                        # its lane for nothing — bill the waste to the
                        # device-efficiency ledger at the padded size
                        from eges_tpu_torch.utils import devstats
                        pad = getattr(lane.target, "_pad", None) \
                            or getattr(self._verifier, "_pad", None) \
                            or bucket_round
                        devstats.DEFAULT.observe_hedge_waste(
                            lane.index, p.rows,
                            pad(p.rows) if p.rows > 1
                            or not self._host_fallback else 1)
                if won:
                    self._record_window(lane, p, mesh)
        except BaseException as exc:
            if p.failure is None:
                p.failure = exc
        finally:
            # futures resolve even if the instrumentation path raises —
            # a blocked recover_signers caller is a wedged consensus
            # node.  If the batch died before results were computed,
            # its futures FAIL with that error rather than masquerading
            # as None ("invalid signature").  A hedge loser runs this
            # loop too: the winner resolved everything already, so the
            # done() guard makes it a no-op (and both dispatches compute
            # the same batch, so the results are bit-identical anyway).
            p.finished = True
            if p.traced:
                from eges_tpu_torch.utils import devstats
                devstats.DEFAULT.trace.step()
            for (_, row), r in zip(batch, p.results):
                for f in row[0]:
                    if f.done():
                        continue
                    if p.computed:
                        f.set_result(r)
                    else:
                        f.set_exception(p.failure or RuntimeError(
                            "verifier batch dispatch failed"))
        if p.failure is not None:
            raise p.failure

    def _record_window(self, lane: _DeviceLane, p: _PendingWindow,
                       mesh: bool) -> None:
        """Cache inserts + stats + metrics + tracing + journal for one
        computed window — the bookkeeping tail shared by the inline and
        pipelined paths (errors here propagate to ``_finish_batch``,
        which still resolves the futures in its ``finally``)."""
        from eges_tpu_torch.utils import tracing
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        batch, keys, rows = p.batch, p.keys, p.rows
        # analysis: allow-determinism(batch latency instrumentation; dt/waited_ms are volatile-stripped)
        done = time.monotonic()
        dt = done - p.t0
        pad = getattr(lane.target, "_pad", None) \
            or getattr(self._verifier, "_pad", None) or bucket_round
        # a singleton served by the host pads nothing (where host fallback
        # is off, it went to the device)
        singleton_host = rows == 1 and self._host_fallback
        host_served = p.diverted or singleton_host
        bucket = 1 if singleton_host else pad(rows)
        oldest = min(row[1] for _, row in batch)
        waited = p.t0 - oldest
        tk = p.ticket
        klass = ("consensus" if any(row[2] == "consensus"
                                    for _, row in batch) else "bulk")
        # one flight-recorder entry per computed window: lifecycle phase
        # boundaries + lane attribution (the thw_flight RPC surface)
        t_dispatch = p.t_dispatch if p.t_dispatch is not None else done
        t_collect = p.t_collect if p.t_collect is not None else t_dispatch
        flight = {
            "device": lane.index, "rows": rows, "bucket": bucket,
            "reason": p.reason, "diverted": bool(p.diverted),
            "probing": bool(p.probing),
            "pipelined": p.staged is not None,
            "t_submit": round(oldest, 6), "t_begin": round(p.t0, 6),
            "t_dispatch": round(t_dispatch, 6),
            "t_collect": round(t_collect, 6), "t_done": round(done, 6),
            "wait_ms": round(waited * 1e3, 3),
            "stage_ms": round((t_dispatch - p.t0) * 1e3, 3),
            "compute_ms": round((t_collect - t_dispatch) * 1e3, 3),
            "total_ms": round((done - oldest) * 1e3, 3),
            "klass": klass,
            "hedged": bool(tk is not None and tk.hedged),
            "hedge_win": bool(tk is not None and tk.hedged
                              and lane.index == tk.hedge_lane),
            "traces": [],
        }
        flight_evicts = False
        with self._lock:
            # blk/trace linkage: distinct submitter trace ids riding this
            # window (txpool ingest spans, quorum verifies) — popped here
            # so the map never outlives its window
            traces = sorted({t for t in (self._pending_trace.pop(k, None)
                                         for k in keys) if t})
            # ingress provenance: rows per captured (ledger, origin) —
            # tallied under the lock, charged after release (the ledger
            # emits metrics; fail-under-lock hygiene)
            origin_rows: dict[tuple, int] = {}
            for k in keys:
                rec = self._pending_origin.pop(k, None)
                if rec is not None:
                    origin_rows[rec] = origin_rows.get(rec, 0) + 1
            cache_rows = self._cache_rows_pending
            self._cache_rows_pending = 0
            dedup_rows = self._dedup_rows_pending
            self._dedup_rows_pending = 0
            for k, r in zip(keys, p.results):
                self._cache_put(k, r)
            self._stats["batches"] += 1
            self._stats["rows"] += rows
            self._stats["bucket_rows"] += bucket
            lane.stats["batches"] += 1
            lane.stats["rows"] += rows
            lane.stats["bucket_rows"] += bucket
            if p.diverted and mesh:
                self._stats["straggler_diverts"] += 1
                lane.stats["straggler_diverts"] += 1
            windows = self._stats["pipeline_windows"]
            overlapped = self._stats["pipeline_overlapped"]
            flight["traces"] = traces[:4]
            flight["trace_count"] = len(traces)
            # cache-served rows since the previous window: the warm-path
            # volume that never forms a window of its own (the
            # under-count bug this field closes)
            flight["cache_rows"] = cache_rows
            # in-flight-deduped rows merged into this window's rows —
            # the free-work companion the goodput decomposition renders
            flight["dedup_rows"] = dedup_rows
            flight["window"] = self._flight_seq
            self._flight_seq += 1
            if (self._flights.maxlen is not None
                    and len(self._flights) >= self._flights.maxlen):
                # the ring is full: this append evicts the oldest entry
                # — the silent-loss signal the flight_dropped counter
                # and observatory surface
                self._stats["flight_dropped"] += 1
                flight_evicts = True
            self._flights.append(flight)
            # per-class queue-wait samples behind stats()'s percentiles
            for _k, row in batch:
                self._class_waits[row[2]].append(
                    (p.t0 - row[1]) * 1e3)
        # per-origin window cost: each captured origin gets its row
        # count plus its row-share of the window's wall-clock interior,
        # booked as host-ms when the rows were host-served (singleton
        # or breaker/straggler divert) and device-ms otherwise
        if origin_rows:
            win_ms = (done - p.t0) * 1e3
            for (led, origin), n in origin_rows.items():
                ms = win_ms * (n / rows)
                led.charge(origin, rows=n,
                           host_ms=ms if host_served else 0.0,
                           device_ms=0.0 if host_served else ms)
        metrics.counter("verifier.flight_windows").inc()
        if flight_evicts:
            metrics.counter("verifier.flight_dropped").inc()
        for _, row in batch:
            w = p.t0 - row[1]
            metrics.histogram("verifier.sched_queue_wait_seconds") \
                .observe(w)
            # per-class queue-wait: the priority-preemption deliverable
            # is visible as a class-labeled histogram split
            metrics.histogram(
                "verifier.sched_queue_wait_seconds;class=%s"
                % row[2]).observe(w)
        metrics.histogram("verifier.sched_batch_rows").observe(rows)
        metrics.histogram("verifier.sched_occupancy") \
            .observe(rows / bucket)
        if windows:
            metrics.gauge("verifier.pipeline_overlap_ratio") \
                .set(round(overlapped / windows, 4))
        if mesh:
            metrics.counter(
                f"verifier.mesh_rows;device={lane.index}").inc(rows)
            metrics.histogram(
                f"verifier.mesh_occupancy;device={lane.index}") \
                .observe(rows / bucket)
            if p.diverted:
                metrics.counter(
                    f"verifier.mesh_straggler_diverts"
                    f";device={lane.index}").inc()
        # device-efficiency ledger (utils/devstats.py): deterministic
        # count deltas only — the goodput numerator/denominator this
        # window contributed, journaled on the next devstats tick.
        # Host-served windows (singleton or breaker/straggler divert)
        # padded no device bucket, so they land in the rescue column.
        from eges_tpu_torch.utils import devstats
        devstats.DEFAULT.observe_window(
            lane.index, rows, bucket,
            cache_rows=cache_rows, dedup_rows=dedup_rows,
            diverted=bool(host_served),
            hedged=flight["hedged"])
        tracing.DEFAULT.record_span(
            "verifier.sched_dispatch", dt, rows=rows, bucket=bucket,
            reason=p.reason, occupancy=round(rows / bucket, 4),
            device=lane.index, waited_ms=round(waited * 1e3, 3))
        journal = self.journal
        if journal is not None:
            journal.record("verifier_flush", rows=rows, reason=p.reason,
                           occupancy=round(rows / bucket, 4),
                           waited_ms=round(waited * 1e3, 3))
            # commit-anatomy verify-window interior: the wall-clock
            # wait/stage/compute split plus lane and trace linkage, so
            # the critical-path assembler can attribute the admission
            # leg to scheduler queueing vs device time.  The wall-clock
            # attrs (and the race-placed lane) are volatile-stripped by
            # the chaos canonical dump; rows/reason/diverted are pinned
            # by kick-driven batching and stay in it.
            journal.record("commit_anatomy", stage="verify_window",
                           rows=rows, reason=p.reason,
                           diverted=bool(p.diverted), lane=lane.index,
                           wait_ms=round(waited * 1e3, 3),
                           stage_ms=flight["stage_ms"],
                           compute_ms=flight["compute_ms"],
                           traces=len(traces))
            if mesh:
                journal.record("verifier_mesh_dispatch",
                               device=lane.index, rows=rows,
                               occupancy=round(rows / bucket, 4),
                               diverted=p.diverted,
                               queue_wait_ms=round(waited * 1e3, 3))
        if self._adaptive:
            # one controller step per RECORDED window (hedge losers
            # never get here), after the window's own journal events so
            # a sched_adapt decision always follows the flush it saw
            self._adapt_step()


    # -- adaptive windowing (closed-loop controller) ----------------------

    def _adapt_step(self) -> None:  # hot-path-entry
        """One closed-loop controller step: telemetry in, window policy
        out.

        Inputs are the flight recorder's recent wait/stage/compute/total
        timings plus the SLO engine's commit-latency burn rate (via the
        injectable :attr:`burn_probe`; without one, burn derives from
        the recent window p99 against ``config.slo_p99_ms``).  Output is
        the flush deadline (``_window_s``) and target bucket
        (``_target_rows``) the NEXT windows coalesce under: burning the
        p99 objective shrinks both (deadline-biased small buckets, less
        queueing ahead of each dispatch); a calm burn grows them back
        toward occupancy.  Every decision journals as ``sched_adapt``
        with its inputs — the measured value attrs are wall-clock
        derived and volatile-stripped by the chaos canonical dump, while
        the event COUNT stays pinned by kick-driven batching, so
        determinism checks still byte-match under the virtual clock.
        """
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        from eges_tpu_torch.utils.metrics import percentile

        cfg = self.config
        probe = self.burn_probe
        burn_fast = burn_slow = None
        if probe is not None:
            try:
                burn_fast, burn_slow = probe()
            # analysis: allow-swallow(a torn-down SLO engine must not
            # take the verify hot path down with it — the controller
            # falls back to the flight-derived burn)
            except Exception:
                burn_fast = burn_slow = None
        decision = None
        with self._lock:
            self._adapt_windows += 1
            if self._adapt_windows % max(1, cfg.adapt_every):
                return
            recent = list(self._flights)[-max(1, cfg.adapt_recent):]
            totals = sorted(f["total_ms"] for f in recent)
            waits = sorted(f["wait_ms"] for f in recent)
            p99 = percentile(totals, 99.0)
            if burn_fast is None:
                derived = (p99 / cfg.slo_p99_ms
                           if cfg.slo_p99_ms > 0 else 0.0)
                burn_fast = burn_slow = derived
            burn = max(burn_fast, burn_slow)
            window_ms = self._window_s * 1e3
            target = self._target_rows
            if burn >= cfg.burn_shrink:
                # the p99 objective is burning: bias to latency —
                # shorter deadline, smaller bucket
                window_ms = max(cfg.min_window_ms,
                                window_ms * cfg.shrink_gain)
                target = max(cfg.min_target_rows, target // 2)
                why = "shrink"
            elif burn <= cfg.burn_relax:
                # calm: trade latency headroom back for occupancy
                window_ms = min(cfg.max_window_ms,
                                window_ms * cfg.grow_gain)
                target = min(cfg.max_batch, target * 2)
                why = "grow"
            else:
                why = "hold"
            self._window_s = window_ms / 1e3
            self._target_rows = target
            self._stats["adapt_decisions"] += 1
            decision = {
                "window_ms": round(window_ms, 4),
                "target_rows": target,
                "burn_fast": round(float(burn_fast), 4),
                "burn_slow": round(float(burn_slow), 4),
                "p99_ms": round(p99, 3),
                "wait_p50_ms": round(percentile(waits, 50.0), 3),
                "decision": why,
            }
        # gauges + journal OUTSIDE the condition (fail-under-lock)
        metrics.gauge("verifier.sched_window_ms").set(
            decision["window_ms"])
        metrics.gauge("verifier.sched_target_rows").set(
            decision["target_rows"])
        metrics.counter("verifier.adapt_decisions").inc()
        journal = self.journal
        if journal is not None:
            journal.record("sched_adapt", **decision)

    # -- hedged re-dispatch (straggler speculation) -----------------------

    def _ensure_hedge_thread(self) -> None:
        # caller holds self._lock; the monitor starts lazily on the
        # first mesh placement so single-lane schedulers (and meshes
        # with hedging disabled) never spawn it
        if self._hedge_thread is None or not self._hedge_thread.is_alive():
            self._hedge_thread = threading.Thread(
                target=self._hedge_loop, name="verifier-hedge",
                daemon=True)
            self._hedge_thread.start()

    def _lane_threshold_ms(self, lane_index: int) -> float:
        """Straggler threshold for one lane: the median window total
        over this lane's recent flights × ``hedge_factor`` — the
        all-lane median until the lane has ``hedge_min_windows`` of its
        own history — floored at ``hedge_floor_ms`` so an idle mesh
        never hedges on noise.  Caller holds ``self._lock``."""
        from eges_tpu_torch.utils.metrics import percentile

        cfg = self.config
        lane_tot = sorted(f["total_ms"] for f in self._flights
                          if f["device"] == lane_index)
        if len(lane_tot) >= cfg.hedge_min_windows:
            base = percentile(lane_tot, 50.0)
        else:
            all_tot = sorted(f["total_ms"] for f in self._flights)
            base = percentile(all_tot, 50.0) if all_tot else 0.0
        return max(cfg.hedge_floor_ms, cfg.hedge_factor * base)

    def _hedge_scan(self) -> list:
        """One straggler-monitor pass (caller holds ``self._lock``):
        every live, un-hedged ticket whose wall-clock age exceeds its
        lane's flight-derived threshold is speculatively re-placed on
        the least-loaded OTHER lane with a closed breaker.  Returns the
        tickets hedged this pass (for post-lock metrics emission)."""
        if not self._tickets:
            return []
        # Straggler aging is wall-clock by nature — a stuck lane freezes
        # the sim's virtual clock exactly when hedging must fire; hedged
        # windows journal nothing, so determinism holds.
        # analysis: allow-determinism(hedge aging; hedges journal nothing)
        now = time.monotonic()
        picks = []
        for tk in list(self._tickets):
            if tk.hedged or tk.winner is not None:
                continue
            age_ms = (now - tk.t_placed) * 1e3
            if age_ms < self._lane_threshold_ms(tk.lane):
                continue
            sibs = [L for L in self._lanes
                    if L.index != tk.lane and L.breaker == "closed"]
            if not sibs:
                continue
            sib = min(sibs, key=lambda L: (L.load(), L.index))
            tk.hedged = True
            tk.hedge_lane = sib.index
            # the duplicate rides the sibling's queue like any other
            # window (consensus class still preempts); first result
            # wins — the loser is cancelled at pop or wasted at finish
            if tk.klass == "consensus":
                sib.queue.appendleft(tk)
            else:
                sib.queue.append(tk)
            sib.queued_rows += tk.rows
            sib.max_queue_depth = max(sib.max_queue_depth,
                                      len(sib.queue))
            self._stats["hedges"] += 1
            self._ensure_lane_thread(sib)
            picks.append(tk)
        if picks:
            self._lock.notify_all()
        return picks

    def _hedge_loop(self) -> None:  # hot-path-entry
        """Straggler monitor: while any window ticket is live, poll its
        age against the lane's flight-derived threshold and re-place
        stragglers on a sibling lane.  Polling is REAL time on purpose
        (see ``_hedge_scan``): the injectable virtual clock freezes
        while a stuck window blocks the sim's clock thread, which is
        precisely when hedging has to fire.  Hedges touch stats,
        metrics and the flight ring only — never the journal — so chaos
        determinism is unaffected by when (or whether) they happen."""
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        while True:
            with self._lock:
                if self._closed and self._admission_done:
                    return
                if not self._tickets:
                    # nothing in flight: sleep until a placement (or
                    # close) notifies the condition
                    self._lock.wait()
                    continue
                # analysis: allow-determinism(hedge polling is real-time
                # by contract; hedged windows journal nothing)
                self._lock.wait(self._hedge_poll_s)
                picks = self._hedge_scan()
            for _tk in picks:
                metrics.counter("verifier.hedges").inc()


def scheduler_for(verifier, **kwargs) -> VerifierScheduler | None:
    """Attach (or reuse) the scheduler for a verifier object.

    The scheduler rides as an attribute on the verifier itself, so every
    component holding the same device facade — all sim-cluster nodes,
    the chain, the txpool — shares one coalescing window and one
    recovery cache (and, for mesh verifiers, one set of device lanes),
    and the pair is garbage-collected together.  ``None`` (host-fallback
    mode) passes through: those nodes keep the per-entry host path.
    """
    if verifier is None:
        return None
    if isinstance(verifier, VerifierScheduler):
        return verifier
    sched = getattr(verifier, "_eges_scheduler", None)
    if sched is None or sched.closed:
        sched = VerifierScheduler(verifier, **kwargs)
        verifier._eges_scheduler = sched
    return sched
