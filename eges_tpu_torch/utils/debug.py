"""Runtime debugging for long-running node processes.

The port's copy of ``eges_tpu/utils/debug.py``, unchanged but for its
imports.

Role parity with the reference's ``internal/debug`` (ref:
internal/debug/flags.go:37-83 — pprof HTTP server, cpuprofile, runtime
tracer, all runtime-togglable via the ``debug_*`` RPC namespace,
internal/debug/api.go).  Python equivalents:

* :func:`install_sigusr1` — ``kill -USR1 <pid>`` dumps every thread's
  stack and all asyncio tasks to stderr (the Go SIGQUIT-dump idiom) —
  the first tool for a wedged node.
* :class:`DebugController` — start/stop a cProfile CPU profile, dump
  stacks, snapshot GC/memory counters; surfaced over JSON-RPC as
  ``debug_startProfile`` / ``debug_stopProfile`` / ``debug_stacks`` /
  ``debug_stats`` (internal/debug/api.go's StartCPUProfile role).
"""

from __future__ import annotations

import signal
import sys
import threading
import traceback


def dump_stacks() -> str:
    """All thread stacks + pending asyncio tasks as one text blob."""
    out = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(l.rstrip() for l in traceback.format_stack(frame))
    try:
        import asyncio

        loop = asyncio.get_running_loop()
        tasks = [t for t in asyncio.all_tasks(loop) if not t.done()]
        out.append(f"--- {len(tasks)} pending asyncio tasks ---")
        for t in tasks:
            out.append(repr(t))
    # analysis: allow-swallow(best-effort diagnostic dump; partial output ok)
    except Exception:
        pass
    return "\n".join(out)


def install_sigusr1() -> None:
    """SIGUSR1 -> stack dump on stderr (safe to call multiple times)."""

    def handler(signum, frame):
        sys.stderr.write("\n=== SIGUSR1 stack dump ===\n")
        sys.stderr.write(dump_stacks())
        sys.stderr.write("\n=== end dump ===\n")
        sys.stderr.flush()

    try:
        signal.signal(signal.SIGUSR1, handler)
    except (ValueError, OSError):
        pass  # not the main thread / unsupported platform


class DebugController:
    """Runtime-togglable profiling (the debug_* RPC surface)."""

    def __init__(self):
        self._profiler = None

    def start_profile(self) -> bool:
        """Begin a cProfile capture; False if one is already running."""
        import cProfile

        if self._profiler is not None:
            return False
        self._profiler = cProfile.Profile()
        self._profiler.enable()
        return True

    def stop_profile(self, top: int = 30) -> str:
        """Stop the capture and return a text report (top functions by
        cumulative time)."""
        import io
        import pstats

        if self._profiler is None:
            return "no profile running"
        self._profiler.disable()
        buf = io.StringIO()
        pstats.Stats(self._profiler, stream=buf).sort_stats(
            "cumulative").print_stats(top)
        self._profiler = None
        return buf.getvalue()

    def stacks(self) -> str:
        return dump_stacks()

    def stats(self) -> dict:
        """GC + interpreter counters (MemStats role)."""
        import gc

        counts = gc.get_count()
        out = {
            "gc_counts": list(counts),
            "gc_objects": len(gc.get_objects()),
            "threads": threading.active_count(),
        }
        try:
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF)
            out["max_rss_kb"] = ru.ru_maxrss
            out["user_cpu_s"] = round(ru.ru_utime, 3)
            out["sys_cpu_s"] = round(ru.ru_stime, 3)
        # analysis: allow-swallow(resource module optional; stats best-effort)
        except Exception:
            pass
        return out
