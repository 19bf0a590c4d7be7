"""Span-based tracing: ids, parent links, attributes, ring-buffer export.

The port's copy of ``eges_tpu/utils/tracing.py``, with its own
``DEFAULT`` tracer (the facade's ``verifier.batch`` and the scheduler's
``verifier.sched_dispatch`` spans land here).

Role: the distributed half of the observability layer.  The metrics
registry (``utils/metrics.py``) answers "how long does phase X take in
aggregate"; this module answers "what happened to *this* transaction" by
stitching one trace id through tx ingest -> txpool admit -> verifier
batch -> election -> chain commit, across simnet and socket transports.

Wire format: trace context rides in front of the existing gossip/direct
payloads as a fixed 28-byte header::

    MAGIC (4B, b"\\xD7TRC") | trace_id (16B) | span_id (8B)

``inject_current`` prepends it when a span is active, ``extract`` strips
it on receipt, and ``payload_of`` lets protocol muxes peek the real RLP
payload without caring whether a header is present.  Nodes that predate
this header simply never see MAGIC and pass payloads through untouched.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass

from eges_tpu_torch.utils import profiler

MAGIC = b"\xd7TRC"
_HEADER_LEN = len(MAGIC) + 16 + 8

_UNSET = object()


def _new_trace_id() -> str:
    # analysis: allow-determinism(trace ids are observability-only, never journaled)
    return os.urandom(16).hex()


def _new_span_id() -> str:
    # analysis: allow-determinism(span ids are observability-only, never journaled)
    return os.urandom(8).hex()


@dataclass(frozen=True)
class SpanContext:
    """Immutable (trace_id, span_id) pair — what crosses process/node
    boundaries and what children parent themselves to."""

    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars


class Span:
    """One timed operation.  Finished spans land in the tracer's ring
    buffer; unfinished ones are invisible to exporters."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "end_s", "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str | None, start_s: float, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.start_s = start_s
        self.end_s: float | None = None
        self.attrs = attrs

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def end(self) -> None:
        if self.end_s is not None:
            return
        self.end_s = self._tracer._clock()
        self._tracer._finish(self)

    @property
    def duration_s(self) -> float:
        if self.end_s is None:
            return 0.0
        return self.end_s - self.start_s

    def to_dict(self) -> dict:
        return {"name": self.name, "trace": self.trace_id,
                "span": self.span_id, "parent": self.parent_id,
                "start_s": round(self.start_s, 6),
                "duration_s": round(self.duration_s, 6),
                "attrs": dict(self.attrs)}


class Tracer:
    """Span factory + bounded in-memory exporter.

    Finished spans go into a deque ring buffer (oldest dropped first, a
    dropped counter keeps the loss observable).  The "current" span is a
    contextvar, so nesting works across ``await`` points but — by design
    — not across ``SimClock.call_later`` hops; callers that cross a
    scheduler boundary carry a ``SpanContext`` explicitly (see
    ``core/txpool.py``).
    """

    def __init__(self, clock=time.monotonic, capacity: int = 4096):
        self._clock = clock
        self._lock = threading.Lock()
        self._finished: deque[dict] = deque(maxlen=capacity)
        self._current: ContextVar[SpanContext | None] = ContextVar(
            "geec_trace_ctx", default=None)
        self.started = 0
        self.dropped = 0

    # -- span lifecycle -------------------------------------------------
    def start_span(self, name: str, parent=_UNSET, **attrs) -> Span:
        """Open a span.  ``parent`` may be a SpanContext, None (force a
        new root), or omitted (inherit the current context)."""
        if parent is _UNSET:
            parent = self._current.get()
        if isinstance(parent, Span):
            parent = parent.context()
        if parent is None:
            trace_id, parent_id = _new_trace_id(), None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        with self._lock:
            self.started += 1
        return Span(self, name, trace_id, parent_id, self._clock(), attrs)

    @contextmanager
    def span(self, name: str, parent=_UNSET, **attrs):
        """Start a span, make it current for the body, end it on exit.

        Span names in ``profiler.SPAN_PHASES`` also tag the calling
        thread with the matching pipeline phase for the span body — the
        bridge that lets the continuous sampling profiler attribute
        CPU samples to ``pool_admit`` etc. without its own hooks on
        every ingest path (one dict probe per span when unmapped)."""
        sp = self.start_span(name, parent, **attrs)
        token = self._current.set(sp.context())
        ptok = profiler.tag_span(name)
        try:
            yield sp
        finally:
            if ptok is not None:
                profiler.pop_phase(ptok)
            self._current.reset(token)
            sp.end()

    def record_span(self, name: str, duration_s: float, parent=_UNSET,
                    **attrs) -> Span:
        """Record an already-measured duration as a finished span (used
        by virtual-clock phases where wall time is meaningless)."""
        sp = self.start_span(name, parent, **attrs)
        sp.start_s -= duration_s
        sp.end_s = sp.start_s + duration_s
        self._finish(sp)
        return sp

    def _finish(self, span: Span) -> None:
        with self._lock:
            if len(self._finished) == self._finished.maxlen:
                self.dropped += 1
            self._finished.append(span.to_dict())

    # -- context plumbing -----------------------------------------------
    def current_context(self) -> SpanContext | None:
        return self._current.get()

    @contextmanager
    def activate(self, ctx: SpanContext | None):
        """Make ``ctx`` the current context for the body (no-op if
        None — receivers call this unconditionally on every message)."""
        if ctx is None:
            yield
            return
        token = self._current.set(ctx)
        try:
            yield
        finally:
            self._current.reset(token)

    # -- export ---------------------------------------------------------
    def finished(self, limit: int = 0, trace: str | None = None) -> list[dict]:
        """Most-recent-last finished spans, optionally filtered by trace
        id and capped to the newest ``limit``."""
        with self._lock:
            spans = list(self._finished)
        if trace:
            spans = [s for s in spans if s["trace"] == trace]
        if limit and limit > 0:
            spans = spans[-limit:]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()

    def dump(self, path: str, drain: bool = True) -> int:
        """Append finished spans to ``path`` as JSONL; returns the number
        written.  ``drain`` empties the buffer so periodic dumps don't
        duplicate rows."""
        with self._lock:
            spans = list(self._finished)
            if drain:
                self._finished.clear()
        if not spans:
            return 0
        with open(path, "a", encoding="utf-8") as fh:
            for s in spans:
                fh.write(json.dumps(s, sort_keys=True) + "\n")
        return len(spans)

    def stats(self) -> dict:
        with self._lock:
            return {"started": self.started, "buffered": len(self._finished),
                    "dropped": self.dropped,
                    "capacity": self._finished.maxlen}


# -- wire-format helpers -----------------------------------------------

def inject(ctx: SpanContext | None, data: bytes) -> bytes:
    """Prepend the trace header for ``ctx`` (pass-through when None)."""
    if ctx is None:
        return data
    return (MAGIC + bytes.fromhex(ctx.trace_id)
            + bytes.fromhex(ctx.span_id) + data)


def inject_current(data: bytes, tracer: "Tracer | None" = None) -> bytes:
    """Prepend the *active* trace context, if any."""
    return inject((tracer or DEFAULT).current_context(), data)


def extract(data: bytes) -> tuple[SpanContext | None, bytes]:
    """Split an incoming payload into (context-or-None, real payload)."""
    if data[:4] == MAGIC and len(data) >= _HEADER_LEN:
        ctx = SpanContext(data[4:20].hex(), data[20:28].hex())
        return ctx, data[_HEADER_LEN:]
    return None, data


def payload_of(data: bytes) -> bytes:
    """The RLP payload regardless of a trace header — for protocol muxes
    that peek at message codes before dispatch."""
    if data[:4] == MAGIC and len(data) >= _HEADER_LEN:
        return data[_HEADER_LEN:]
    return data


DEFAULT = Tracer()
