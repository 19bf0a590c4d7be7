"""Bounded time-series sampling over the metrics registry.

The port's copy of ``eges_tpu/utils/timeseries.py``: it samples the port's
metrics registry.

The registry (``utils/metrics.py``) holds *aggregates* — a counter's
lifetime total, a histogram's reservoir.  This module turns those
aggregates into a *stream*: :class:`RegistrySampler` periodically
snapshots a :class:`~eges_tpu_torch.utils.metrics.Registry` on an injectable
clock and emits one flat sample payload per step — counters and meter
counts as DELTAS since the previous step, numeric gauges and histogram
percentiles as point-in-time values — while retaining the last N steps
per metric family in a bounded ring (:class:`SeriesStore`).

The sample payload is what rides the telemetry push channel as a
``telemetry_sample`` journal event (see ``harness/collector.py``):
deltas make per-step payloads small and make cluster aggregation a
plain sum, and the injectable clock keeps sim-driven sampling on
virtual time so chaos runs stay byte-deterministic.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from eges_tpu_torch.utils.metrics import (Counter, DEFAULT, Gauge, Histogram,
                                    Meter, Registry, Timer)


class Series:
    """One bounded (ts, value) ring for a single metric name."""

    __slots__ = ("name", "_points")

    def __init__(self, name: str, capacity: int = 512):
        self.name = name
        self._points: deque[tuple[float, float]] = deque(maxlen=capacity)

    def add(self, ts: float, value: float) -> None:
        self._points.append((ts, value))

    def points(self) -> list[tuple[float, float]]:
        return list(self._points)

    def latest(self) -> tuple[float, float] | None:
        return self._points[-1] if self._points else None

    def __len__(self) -> int:
        return len(self._points)


class SeriesStore:
    """Named bounded series, deterministic iteration order."""

    def __init__(self, capacity: int = 512):
        self._capacity = capacity
        self._series: dict[str, Series] = {}
        self._lock = threading.Lock()

    def add(self, name: str, ts: float, value: float) -> None:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = Series(name, self._capacity)
                self._series[name] = s
        s.add(ts, value)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str) -> Series | None:
        with self._lock:
            return self._series.get(name)

    def as_dict(self) -> dict[str, list[list[float]]]:
        """``{name: [[ts, value], ...]}`` with sorted names — the
        JSON-stable shape the collector's report embeds."""
        with self._lock:
            items = sorted(self._series.items())
        return {name: [[ts, v] for ts, v in s.points()]
                for name, s in items}


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class RegistrySampler:
    """Periodic registry snapshotter: deltas for monotone aggregates,
    points for gauges/percentiles, last N steps per family retained.

    ``clock`` is injected (sim clusters pass virtual time); the default
    is only for standalone/real-node use.  ``sample()`` returns the flat
    payload for this step and folds every value into the bounded
    :class:`SeriesStore` reachable as :attr:`store`.
    """

    def __init__(self, registry: Registry | None = None, *,
                 clock=time.monotonic, capacity: int = 512):
        self._registry = registry if registry is not None else DEFAULT
        self._clock = clock
        self.store = SeriesStore(capacity)
        self.steps = 0
        # previous monotone readings, flat name -> value, for deltas —
        # baselined NOW so the first sample reports deltas since the
        # sampler was created, not registry lifetime totals (the
        # registry is process-global: without the baseline, back-to-back
        # sim runs in one process would leak the first run's counts into
        # the second run's first sample and break byte-determinism)
        self._prev: dict[str, float] = {}
        self._lock = threading.Lock()
        with self._registry._lock:
            items = list(self._registry._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                self._prev[name] = m.value
            elif isinstance(m, (Meter, Timer, Histogram)):
                self._prev[name] = m.count

    # -- one step -------------------------------------------------------
    def sample(self) -> dict:
        """Take one step: returns the flat payload for this step.

        Counters and Meter/Timer/Histogram counts appear as deltas
        (omitted when zero — an absent key IS a zero delta); numeric
        gauges always appear as points; histogram percentiles appear as
        points whenever the distribution saw new observations.
        """
        now = float(self._clock())
        metrics = self._registry
        # the sampler's own heartbeat: a delta of exactly 1 every step,
        # so an otherwise-idle node still produces a non-empty payload
        metrics.counter("telemetry.samples").inc()
        with self._registry._lock:
            items = sorted(self._registry._metrics.items())
        payload: dict[str, object] = {}
        with self._lock:
            self.steps += 1
            for name, m in items:
                if isinstance(m, Counter):
                    d = m.value - self._prev.get(name, 0)
                    self._prev[name] = m.value
                    if d:
                        payload[name] = d
                        self.store.add(name, now, d)
                elif isinstance(m, Gauge):
                    if _numeric(m.value):
                        payload[name] = m.value
                        self.store.add(name, now, float(m.value))
                elif isinstance(m, Meter):
                    d = m.count - self._prev.get(name, 0)
                    self._prev[name] = m.count
                    if d:
                        payload[name] = d
                        self.store.add(name, now, d)
                elif isinstance(m, Timer):
                    d = m.count - self._prev.get(name, 0)
                    self._prev[name] = m.count
                    if d:
                        payload[name] = {"count": d,
                                         "mean_s": round(m.mean, 6)}
                        self.store.add(name + ".count", now, d)
                        self.store.add(name + ".mean_s", now,
                                       round(m.mean, 6))
                elif isinstance(m, Histogram):
                    d = m.count - self._prev.get(name, 0)
                    self._prev[name] = m.count
                    if d:
                        ps = m.percentiles()
                        payload[name] = {"count": d,
                                         "p50": round(ps[50.0], 6),
                                         "p95": round(ps[95.0], 6),
                                         "p99": round(ps[99.0], 6)}
                        self.store.add(name + ".count", now, d)
                        for q in (50, 95, 99):
                            self.store.add("%s.p%d" % (name, q), now,
                                           round(ps[float(q)], 6))
        return payload


def fold_payload(store: SeriesStore, ts: float, payload: dict) -> None:
    """Fold one ``telemetry_sample`` payload (as produced by
    :meth:`RegistrySampler.sample`) into a :class:`SeriesStore` — the
    collector-side mirror of the sampler's own store, so a replay from
    journal events reconstructs identical series."""
    for name in sorted(payload):
        v = payload[name]
        if _numeric(v):
            store.add(name, ts, float(v))
        elif isinstance(v, dict):
            for sub in sorted(v):
                if _numeric(v[sub]):
                    store.add("%s.%s" % (name, sub), ts, float(v[sub]))
