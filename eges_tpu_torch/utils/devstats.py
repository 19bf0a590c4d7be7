"""Device-efficiency observatory: goodput, roofline, memory, traces.

The port's copy of ``eges_tpu/utils/devstats.py``: the goodput ledger
(:class:`GoodputLedger`, ``DEFAULT``) and the collector-side assembler
(:class:`DevstatsAssembler`, :func:`assemble`) as the reference has
them; memory and traces read the card through torch, and the roofline
is the port's own bound.  The reference's sim selftest waits for the
port's copy of ``sim/cluster.py``.

Role: the device-side half of the observability plane.  The sampling
profiler (``utils/profiler.py``) answers "which host *functions* burn
the time"; this module answers the symmetric device question — "how
many of the rows we paid device time for were useful, and how close is
each lane to its ceiling".  Three surfaces:

* the **goodput ledger** — every recorded scheduler window already
  knows its rows, padded bucket, cache-served/deduped companions and
  hedge outcome (``crypto/scheduler.py`` ``_record_window`` + the
  flight recorder).  :class:`GoodputLedger` folds those into per-lane,
  per-bucket counters whose headline is ``goodput_ratio`` = useful
  rows / padded device rows, and ``fraction_of_roofline`` = achieved
  rows/s / the per-bucket ceiling.  The ceilings are the port's own
  bound of a recovery batch (the least time the card could take:
  ``chip_smoke.py`` ``bound`` over ``ops/opcount.py``'s counts), set
  with :func:`set_roofline` by whoever measured them; a TPU's numbers
  never anchor it.  Unset, the fraction goes unreported.

* **device memory telemetry** — :func:`sample_memory` reads each
  card's ``torch.cuda.memory_stats`` (bytes in use, peak, the card's
  total) and publishes them as ``devstats.mem_*;device=N`` gauges.
  Without a CUDA card it returns ``{}``: absent, never fake zeros.

* **on-demand device traces** — :class:`DeviceTraceArmer` runs
  ``torch.profiler`` (CPU and CUDA activity) over the next N dispatched
  windows, from the first one's dispatch to the last one's record, and writes a Chrome trace into a versioned
  ``device_trace.NNN`` directory.

Determinism contract: like the profiler plane, only aggregate *count*
deltas are journaled — one ``device_efficiency`` event per device per
tick, into a dedicated ``"devstats"`` stream in sims (the chaos
determinism checks never enable it).  Live-push and ``--replay``
collector folds therefore agree byte-for-byte on everything derived
from counts; memory watermarks ride the events as point-in-time
readings and are absent on host-only runs.  Nothing in this module
reads a wall clock — rates come from journaled event timestamps.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import deque

SNAP_RING = 64          # delta snapshots kept for the thw_devices RPC

# The closed per-device counter vocabulary: journaled verbatim in each
# device_efficiency event and summed verbatim by the assembler, so the
# two ends cannot drift.
_COUNTERS = (
    "windows", "rows", "bucket_rows", "cache_rows", "dedup_rows",
    "diverted_windows", "diverted_rows",
    "hedge_windows", "hedge_wasted_windows", "hedge_wasted_rows",
)

# -- roofline anchoring ---------------------------------------------------

# the ceilings in force: bucket -> rows/s, and where they came from
_ROOFLINE: dict = {"source": None, "ceilings": {}}
_ROOFLINE_LOCK = threading.Lock()


def roofline_from_bounds(bound_ms: dict[int, float]) -> dict[int, float]:
    """Per-bucket ceilings (rows/s) from the least time the card could
    take for one recovery batch of each bucket, in ms: ``bucket /
    bound``."""
    return {int(b): int(b) / (ms / 1e3) for b, ms in bound_ms.items()
            if ms > 0}


def set_roofline(ceilings: dict[int, float], source: str) -> dict:
    """Anchor ``fraction_of_roofline`` to these per-bucket ceilings
    (rows/s) and name their source; an empty dict disables it again.
    Returns the roofline now in force."""
    with _ROOFLINE_LOCK:
        _ROOFLINE["ceilings"] = {int(b): float(c)
                                 for b, c in ceilings.items()}
        _ROOFLINE["source"] = source if ceilings else None
    return load_roofline()


def load_roofline() -> dict:
    """The ceilings in force: ``{"source", "ceilings"}`` where
    ``ceilings`` maps bucket -> rows/s; empty until
    :func:`set_roofline` anchors them — fraction-of-roofline then goes
    unreported rather than anchoring to a guess."""
    with _ROOFLINE_LOCK:
        return {"source": _ROOFLINE["source"],
                "ceilings": dict(_ROOFLINE["ceilings"])}


def roofline_ceiling(ceilings: dict[int, float],
                     bucket: int) -> float | None:
    """The rows/s ceiling for one bucket: exact when given,
    log2-interpolated between given buckets, linearly scaled below the
    smallest, clamped at the largest."""
    import math

    if not ceilings or bucket <= 0:
        return None
    exact = ceilings.get(bucket)
    if exact is not None:
        return exact
    pts = sorted(ceilings.items())
    b0, c0 = pts[0]
    if bucket < b0:
        return c0 * bucket / b0
    bn, cn = pts[-1]
    if bucket > bn:
        return cn
    for (lo, clo), (hi, chi) in zip(pts, pts[1:]):
        if lo < bucket < hi:
            t = ((math.log2(bucket) - math.log2(lo))
                 / (math.log2(hi) - math.log2(lo)))
            return clo + t * (chi - clo)
    return None


# -- on-demand device traces ----------------------------------------------

class DeviceTraceArmer:
    """Arms a ``torch.profiler`` device trace over the next N windows.

    The scheduler calls :meth:`claim` when a window is dispatched,
    before its device work is queued, and :meth:`step` when a claimed
    window is done (recorded, or failed).  The first armed dispatch
    starts the capture, so it holds the device work of every claimed
    window; the last claimed window's step stops it and writes the
    Chrome trace ``trace.json`` into a versioned ``device_trace.NNN``
    directory under ``dir`` (a tempdir when unset).  ``torch.profiler``
    keeps its session on the thread that started it, so only that
    thread claims windows and stops the capture (a scheduler lane
    dispatches and finishes its windows on one thread).  Where torch or
    its profiler is missing the armer degrades to an ``error:*`` state
    instead of tracing — arming is always safe."""

    def __init__(self):
        self._lock = threading.Lock()
        # artifact directory; set by the node service, else tempdir
        self.dir: str | None = None
        # guarded-by: _lock  (windows still to claim)
        self._remaining = 0
        # guarded-by: _lock  (claimed windows not yet done)
        self._claimed = 0
        # guarded-by: _lock  (the thread that started the capture)
        self._owner: int | None = None
        # guarded-by: _lock
        self._active = False
        # guarded-by: _lock
        self._captures = 0
        # guarded-by: _lock  (idle | armed | tracing | captured | error:*)
        self._state = "idle"
        # guarded-by: _lock
        self._path: str | None = None
        # guarded-by: _lock  (the running torch.profiler session)
        self._prof = None

    def arm(self, windows: int, outdir: str | None = None) -> dict:
        """Arm a capture spanning the next ``windows`` dispatched
        windows (already clamped by the RPC layer); returns status."""
        windows = max(1, int(windows))
        with self._lock:
            if outdir:
                self.dir = str(outdir)
            self._remaining = windows
            if not self._active:
                self._state = "armed"
        return self.status()

    def disarm(self) -> dict:
        """Cancel the windows still to claim.  A capture stops now when
        called on its thread between windows, else at its owner's next
        claim or step (and counts as captured — the artifact is
        real)."""
        captured = False
        with self._lock:
            self._remaining = 0
            if not self._active:
                self._state = "idle"
            elif self._claimed == 0 and self._owner == threading.get_ident():
                captured = self._stop_locked()
        if captured:
            self._count_capture()
        return self.status()

    def claim(self) -> bool:
        """A window is about to be dispatched: start the capture if it
        is armed, and say whether this window is one of the armed ones
        (the caller then calls :meth:`step` once it is done).  Cheap
        (one lock round) when idle, so it sits on the dispatch path
        safely."""
        captured = False
        me = threading.get_ident()
        with self._lock:
            if self._active and self._owner != me:
                return False
            if self._remaining <= 0:
                if self._active and self._claimed == 0:
                    captured = self._stop_locked()  # disarmed meanwhile
                claimed = False
            else:
                if not self._active:
                    self._start_locked()
                claimed = self._active
                if claimed:
                    self._owner = me
                    self._remaining -= 1
                    self._claimed += 1
        if captured:
            self._count_capture()
        return claimed

    def step(self) -> None:
        """A claimed window is done — the last one stops the capture."""
        captured = False
        with self._lock:
            if not self._active:
                return
            self._claimed -= 1
            if self._claimed <= 0 and self._remaining <= 0:
                captured = self._stop_locked()
        if captured:
            self._count_capture()

    @staticmethod
    def _count_capture() -> None:
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.counter("devstats.trace_captures").inc()

    def _start_locked(self) -> None:
        # lazy import: the hot path never pays for torch.profiler unless
        # a capture is actually armed
        try:
            import tempfile

            from torch.profiler import ProfilerActivity, profile

            base = self.dir or tempfile.gettempdir()
            path = os.path.join(base,
                                "device_trace.%03d" % self._captures)
            os.makedirs(path, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            import torch

            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        # analysis: allow-swallow(backends without torch.profiler report an error state instead of tracing)
        except Exception as exc:
            self._remaining = 0
            self._state = f"error:{type(exc).__name__}"
            return
        self._prof = prof
        self._active = True
        self._path = path
        self._state = "tracing"

    def _stop_locked(self) -> bool:
        try:
            prof, self._prof = self._prof, None
            prof.stop()
            prof.export_chrome_trace(os.path.join(self._path,
                                                  "trace.json"))
        # analysis: allow-swallow(a failed trace stop leaves the error visible in the armer state)
        except Exception as exc:
            self._active = False
            self._claimed = 0
            self._owner = None
            self._state = f"error:{type(exc).__name__}"
            return False
        self._active = False
        self._claimed = 0
        self._owner = None
        self._captures += 1
        self._state = "captured"
        return True

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "armed_windows": self._remaining,
                "active": self._active,
                "captures": self._captures,
                "path": self._path,
                "dir": self.dir,
            }


# -- the goodput ledger ---------------------------------------------------

class GoodputLedger:
    """Per-device window/row accounting fed by the scheduler's
    ``_record_window`` tail.  Counters only — no wall clock, no stacks
    — so the journaled deltas sit inside the determinism contract the
    collector fold relies on."""

    def __init__(self, *, snapshots: int = SNAP_RING):
        self._lock = threading.Lock()
        # guarded-by: _lock  (device -> cumulative counter dict)
        self._dev: dict[int, dict] = {}
        # guarded-by: _lock  ((device, bucket) -> [windows, rows, bucket_rows])
        self._buckets: dict[tuple[int, int], list[int]] = {}
        # guarded-by: _lock  (delta baselines for snap())
        self._base_dev: dict[int, dict] = {}
        # guarded-by: _lock
        self._base_buckets: dict[tuple[int, int], list[int]] = {}
        # guarded-by: _lock  (latest memory_stats watermarks per device)
        self._mem: dict[int, dict] = {}
        # guarded-by: _lock
        self._snaps: deque[dict] = deque(maxlen=max(1, snapshots))
        # guarded-by: _lock
        self._snap_seq = 0
        self.trace = DeviceTraceArmer()

    def _dev_locked(self, device: int) -> dict:
        d = self._dev.get(device)
        if d is None:
            d = {k: 0 for k in _COUNTERS}
            self._dev[device] = d
        return d

    # -- ingestion (scheduler hooks) --------------------------------------
    def observe_window(self, device: int, rows: int, bucket: int, *,
                       cache_rows: int = 0, dedup_rows: int = 0,
                       diverted: bool = False,
                       hedged: bool = False) -> None:  # hot-path-entry
        """One recorded (winner) scheduler window.  Host-served windows
        (singletons and breaker/straggler diverts) never padded a
        device bucket, so their rows stay out of the goodput
        denominator and land in the ``diverted_rows`` rescue column
        instead."""
        device, rows, bucket = int(device), int(rows), int(bucket)
        with self._lock:
            d = self._dev_locked(device)
            d["windows"] += 1
            d["cache_rows"] += int(cache_rows)
            d["dedup_rows"] += int(dedup_rows)
            if hedged:
                d["hedge_windows"] += 1
            if diverted:
                d["diverted_windows"] += 1
                d["diverted_rows"] += rows
            else:
                d["rows"] += rows
                d["bucket_rows"] += bucket
                bk = self._buckets.get((device, bucket))
                if bk is None:
                    bk = [0, 0, 0]
                    self._buckets[(device, bucket)] = bk
                bk[0] += 1
                bk[1] += rows
                bk[2] += bucket

    def observe_hedge_waste(self, device: int, rows: int,
                            bucket: int) -> None:
        """A hedge LOSER ran a full padded window the winner made
        redundant — pure device waste, billed at the padded size."""
        with self._lock:
            d = self._dev_locked(int(device))
            d["hedge_wasted_windows"] += 1
            d["hedge_wasted_rows"] += int(bucket)

    def note_memory(self, by_device: dict) -> None:
        """Stash the latest :func:`sample_memory` watermarks so the
        next journaled delta carries them."""
        with self._lock:
            for dev, rec in by_device.items():
                self._mem[int(dev)] = dict(rec)

    # -- snapshots --------------------------------------------------------
    def _rebase_locked(self) -> None:
        self._base_dev = {d: dict(v) for d, v in self._dev.items()}
        self._base_buckets = {k: list(v)
                              for k, v in self._buckets.items()}

    def rebase(self) -> None:
        """Reset the delta baseline to the current totals WITHOUT
        recording a snapshot — called when a sim or the node service
        enables the plane, so windows recorded by earlier runs in the
        same process never leak into the first tick (the
        ``RegistrySampler`` baseline-at-attach discipline)."""
        with self._lock:
            self._rebase_locked()

    def snap(self) -> dict:
        """One delta report since the previous ``snap()`` — per-device
        counters plus their per-bucket split, the unit the
        ``thw_devices`` RPC pages through and the sim devstats plane
        journals.  Appended to a bounded ring."""
        with self._lock:
            devices: dict[int, dict] = {}
            for dev in sorted(self._dev):
                cur = self._dev[dev]
                base = self._base_dev.get(dev, {})
                delta = {k: cur[k] - base.get(k, 0) for k in _COUNTERS}
                if not any(delta.values()):
                    continue
                buckets: dict[str, list[int]] = {}
                for (bdev, bucket), bk in self._buckets.items():
                    if bdev != dev:
                        continue
                    bb = self._base_buckets.get((bdev, bucket),
                                                (0, 0, 0))
                    row = [bk[0] - bb[0], bk[1] - bb[1], bk[2] - bb[2]]
                    if any(row):
                        buckets[str(bucket)] = row
                delta["buckets"] = {k: buckets[k]
                                    for k in sorted(buckets, key=int)}
                mem = self._mem.get(dev)
                if mem:
                    delta["mem"] = dict(mem)
                devices[dev] = delta
            snap = {
                "seq": self._snap_seq,
                "devices": {str(d): devices[d] for d in sorted(devices)},
            }
            self._snap_seq += 1
            self._rebase_locked()
            self._snaps.append(snap)
            ratios = {d: (v["rows"], v["bucket_rows"])
                      for d, v in devices.items() if v["bucket_rows"]}
        # emitted after release: gauges take the registry lock
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        for dev, (r, br) in ratios.items():
            metrics.gauge(f"devstats.goodput_ratio;device={dev}") \
                .set(round(r / br, 4))
        return snap

    def snapshots(self, limit: int = 0) -> list[dict]:
        """Oldest-first delta snapshots (RPC callers reverse for the
        newest-first wire contract, like ``thw_profile``)."""
        with self._lock:
            out = list(self._snaps)
        if limit and limit > 0:
            out = out[-limit:]
        return out

    def journal_snapshot(self, journal) -> int:
        """Take a :meth:`snap` and journal one ``device_efficiency``
        event PER device with a non-empty delta, in device order (so
        event order is deterministic).  Returns the number of events
        recorded; an all-idle tick records nothing — unlike
        ``profiler_report`` there is no meaningful empty payload."""
        snap = self.snap()
        n = 0
        for dev_str, d in snap["devices"].items():
            attrs = {k: d[k] for k in _COUNTERS}
            attrs["device"] = int(dev_str)
            attrs["pad_rows"] = d["bucket_rows"] - d["rows"]
            attrs["buckets"] = d["buckets"]
            mem = d.get("mem")
            if mem:
                # point-in-time HBM watermarks ride the count event but
                # are volatile by nature; absent on backends without
                # memory_stats() (the CPU fallback stays green)
                attrs["mem"] = mem
            journal.record("device_efficiency", **attrs)
            n += 1
        return n

    def stats(self) -> dict:
        """The ``thw_health`` block: cumulative volume, goodput, trace
        armer state."""
        with self._lock:
            windows = sum(d["windows"] for d in self._dev.values())
            rows = sum(d["rows"] for d in self._dev.values())
            bucket_rows = sum(d["bucket_rows"]
                              for d in self._dev.values())
            snaps = len(self._snaps)
            mem_devices = len(self._mem)
            ndev = len(self._dev)
        return {
            "devices": ndev,
            "windows": windows,
            "rows": rows,
            "bucket_rows": bucket_rows,
            "goodput_ratio": (round(rows / bucket_rows, 4)
                              if bucket_rows else None),
            "snapshots": snaps,
            "mem_devices": mem_devices,
            "trace": self.trace.status(),
        }


# The process-wide ledger the scheduler feeds and the RPC/health
# surfaces read.  NOT baselined here — sims and the node service call
# rebase() when they enable the plane.
DEFAULT = GoodputLedger()


# -- HBM/memory telemetry -------------------------------------------------

def sample_memory(ledger: GoodputLedger | None = None,
                  devices=None) -> dict:
    """Read each CUDA card's ``torch.cuda.memory_stats`` watermarks
    (bytes allocated now and at peak; the card's total memory as the
    limit) and publish them as ``devstats.mem_*;device=N`` gauges.
    ``devices`` are card indices (all cards by default).  Degrades to
    ``{}`` — publishing nothing — when torch was never imported, no
    CUDA card is present, or a card has allocated nothing yet: the host
    fallback stays green by being absent, not by faking zeros.  Never
    imports torch itself: if nothing else in the process paid the
    import cost, there is no device to meter."""
    led = DEFAULT if ledger is None else ledger
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    try:
        if not torch.cuda.is_available():
            return {}
        if devices is None:
            devices = range(torch.cuda.device_count())
    # analysis: allow-swallow(an uninitializable backend means no devices to meter)
    except Exception:
        return {}
    out: dict[int, dict] = {}
    from eges_tpu_torch.utils.metrics import DEFAULT as metrics
    for i in devices:
        try:
            ms = torch.cuda.memory_stats(i)
            limit = torch.cuda.get_device_properties(i).total_memory
        # analysis: allow-swallow(a card erroring on memory_stats simply has no watermarks)
        except Exception:
            continue
        if not ms:
            continue  # nothing allocated on this card yet
        rec: dict[str, int] = {}
        val = ms.get("allocated_bytes.all.current")
        if val is not None:
            rec["bytes_in_use"] = int(val)
            metrics.gauge(f"devstats.mem_bytes_in_use;device={i}") \
                .set(int(val))
        val = ms.get("allocated_bytes.all.peak")
        if val is not None:
            rec["peak_bytes"] = int(val)
            metrics.gauge(f"devstats.mem_peak_bytes;device={i}") \
                .set(int(val))
        if rec:
            rec["limit_bytes"] = int(limit)
            metrics.gauge(f"devstats.mem_limit_bytes;device={i}") \
                .set(int(limit))
            out[int(i)] = rec
    if out:
        led.note_memory(out)
    return out


# -- collector-plane assembler --------------------------------------------

class DevstatsAssembler:
    """Incremental fold of journaled ``device_efficiency`` events into
    one cluster-wide device-efficiency report — the devstats analog of
    ``ProfileAssembler``.  Pure function of the event stream, so the
    live-push and ``--replay`` collector paths agree byte-for-byte on
    everything derived from counts."""

    def __init__(self):
        self._nodes: dict[str, int] = {}
        self._dev: dict[int, dict] = {}
        self._buckets: dict[tuple[int, int], list[int]] = {}
        self._mem: dict[int, dict] = {}
        self._first_ts: dict[int, float] = {}
        self._last_ts: dict[int, float] = {}

    def ingest(self, ev: dict) -> None:
        if ev.get("type") != "device_efficiency":
            return
        node = str(ev.get("node", "?"))
        self._nodes[node] = self._nodes.get(node, 0) + 1
        dev = int(ev.get("device", 0) or 0)
        d = self._dev.get(dev)
        if d is None:
            d = {k: 0 for k in _COUNTERS}
            self._dev[dev] = d
        for k in _COUNTERS:
            d[k] += int(ev.get(k, 0) or 0)
        for bucket_s, row in (ev.get("buckets") or {}).items():
            key = (dev, int(bucket_s))
            bk = self._buckets.get(key)
            if bk is None:
                bk = [0, 0, 0]
                self._buckets[key] = bk
            bk[0] += int(row[0])
            bk[1] += int(row[1])
            bk[2] += int(row[2])
        mem = ev.get("mem")
        if isinstance(mem, dict):
            # last write wins — the collector feeds events in
            # (ts, node, seq) order, so this is the newest watermark
            self._mem[dev] = dict(mem)
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            self._first_ts.setdefault(dev, float(ts))
            self._last_ts[dev] = float(ts)
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.counter("devstats.reports").inc()

    def report(self) -> dict:
        roof = load_roofline()
        ceilings = roof["ceilings"]
        devices: dict[str, dict] = {}
        for dev in sorted(self._dev):
            d = self._dev[dev]
            span = (self._last_ts.get(dev, 0.0)
                    - self._first_ts.get(dev, 0.0))
            rows_per_s = (round(d["rows"] / span, 3)
                          if span > 0 and d["rows"] else None)
            buckets: dict[str, dict] = {}
            for (bdev, bucket) in sorted(self._buckets):
                if bdev != dev:
                    continue
                w, r, br = self._buckets[(bdev, bucket)]
                ceil = roofline_ceiling(ceilings, bucket)
                buckets[str(bucket)] = {
                    "windows": w, "rows": r, "bucket_rows": br,
                    "goodput_ratio": round(r / br, 4) if br else None,
                    "ceiling_rows_per_s": (round(ceil, 1)
                                           if ceil else None),
                }
            entry = {k: d[k] for k in _COUNTERS}
            entry["pad_rows"] = d["bucket_rows"] - d["rows"]
            entry["goodput_ratio"] = (round(d["rows"] / d["bucket_rows"],
                                            4)
                                      if d["bucket_rows"] else None)
            entry["rows_per_s"] = rows_per_s
            # achieved rows/s against the ceiling of the device's
            # row-weighted mean bucket — the single-number headline the
            # per-bucket table decomposes
            frac = None
            dev_windows = d["windows"] - d["diverted_windows"]
            if rows_per_s and dev_windows > 0 and d["bucket_rows"]:
                ceil = roofline_ceiling(
                    ceilings, round(d["bucket_rows"] / dev_windows))
                if ceil:
                    frac = round(rows_per_s / ceil, 4)
            entry["fraction_of_roofline"] = frac
            entry["buckets"] = buckets
            if dev in self._mem:
                entry["mem"] = self._mem[dev]
            devices[str(dev)] = entry
        tot = {k: sum(d[k] for d in self._dev.values())
               for k in _COUNTERS}
        tot["pad_rows"] = tot["bucket_rows"] - tot["rows"]
        tot["goodput_ratio"] = (round(tot["rows"] / tot["bucket_rows"], 4)
                                if tot["bucket_rows"] else None)
        return {
            "reports": sum(self._nodes.values()),
            "nodes": {k: self._nodes[k] for k in sorted(self._nodes)},
            "roofline_source": roof["source"] if ceilings else None,
            "totals": tot,
            # where potential device rows went instead of useful work:
            # padding burned, cache served free, dedup merged, hedge
            # losers burned, host rescues
            "waste": {
                "pad_rows": tot["pad_rows"],
                "cache_rows": tot["cache_rows"],
                "dedup_rows": tot["dedup_rows"],
                "hedge_wasted_rows": tot["hedge_wasted_rows"],
                "diverted_rows": tot["diverted_rows"],
            },
            "devices": devices,
        }


def assemble(by_node: dict[str, list[dict]]) -> dict:
    """Batch-mode fold over per-stream event lists (the observatory
    ``--replay`` path); mirrors ``profiler.assemble``."""
    from eges_tpu_torch.utils.ledger import _order_key

    asm = DevstatsAssembler()
    merged: list[dict] = []
    for events in by_node.values():
        merged.extend(e for e in events
                      if e.get("type") == "device_efficiency")
    merged.sort(key=_order_key)
    for ev in merged:
        asm.ingest(ev)
    return asm.report()
