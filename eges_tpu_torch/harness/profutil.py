"""Shared timing and provenance for the port's profiling harness: the
counterpart of ``harness/profutil.py``.

Every artifact leads with the same one-line header as the reference's::

    # eges-profile-v1 {"git_rev": ..., "platform_detail": ..., ...}

which here records the ``torch`` and CUDA versions and, where a card is
present, its name and power limit (the card may be set below its 700 W
maximum, and then runs slower under load), in place of ``jax`` and
``jaxlib``.

The reference's three timing protocols live here once, with the same
meaning: :func:`timeit` (one warm-up call, then repeated calls on the
same operands), :func:`timeit_sets` (pre-built argument sets, set 0 the
warm-up) and :func:`timeit_unique` (fresh operands for every call).
Each timed call ends in ``torch.cuda.synchronize(device)`` on the card,
so a time is the host's wall time until the card is done.  The
reference's caveats about its TPU tunnel (``block_until_ready``
returning early, repeat content served from a cache) do not apply on
CUDA; the protocols stay so that the numbers answer the same questions.
:func:`cuda_event_ms` times the card alone, with CUDA events (with
``cold=True`` each call alone, its inputs out of L2), and
:func:`profile_window` lists what the card ran, with ``torch.profiler``.

Stdlib only at import time: ``torch`` is imported inside the helpers
that need it.
"""

from __future__ import annotations

import json
import os
import platform
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def git_rev() -> str | None:
    """Current commit hash straight from ``.git`` (no subprocess; a
    checkout without ``.git`` gives None)."""
    try:
        head = os.path.join(REPO, ".git", "HEAD")
        with open(head, "r", encoding="utf-8") as fh:
            ref = fh.read().strip()
        if ref.startswith("ref: "):
            with open(os.path.join(REPO, ".git", *ref[5:].split("/")),
                      "r", encoding="utf-8") as fh:
                return fh.read().strip()[:40] or None
        return ref[:40] or None
    except OSError:
        return None


def _mod_version(name: str) -> str | None:
    """Version of an already-imported module: provenance never imports
    torch into a process that has not."""
    mod = sys.modules.get(name)
    if mod is None:
        return None
    v = getattr(mod, "__version__", None)
    return str(v) if v is not None else None


def _card() -> dict:
    """The card's name and power limit as nvidia-smi gives them, when
    torch is loaded and sees a card; else empty."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return {}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, check=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"card": torch.cuda.get_device_name(0), "power_limit": limit}


def artifact_header(**extra) -> dict:
    """The shared provenance stamp: platform detail, git revision,
    python, torch and CUDA versions (when torch is loaded), the card's
    name and power limit (when present), plus caller extras."""
    torch = sys.modules.get("torch")
    hdr = {
        "platform_detail": "%s-%s" % (sys.platform, platform.machine()),
        "python": platform.python_version(),
        "git_rev": git_rev(),
        "torch": _mod_version("torch"),
        "cuda": getattr(getattr(torch, "version", None), "cuda", None),
        **_card(),
    }
    hdr.update(extra)
    return hdr


def header_line(**extra) -> str:
    """The header as the one-line ``# eges-profile-v1`` comment every
    profiling artifact leads with."""
    return ("# eges-profile-v1 "
            + json.dumps(artifact_header(**extra), sort_keys=True))


def median_ms(xs: list[float]) -> float:
    """Median of seconds, in ms to 0.1 us (the reference kept 10 us,
    coarser than a launch on the card)."""
    return round(statistics.median(xs) * 1e3, 4)


def sync(device) -> None:
    """Wait for the card (a CPU device computes synchronously)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, *args, reps: int = 10, device=None) -> float:
    """Steady-state per-call seconds: one warm-up call, then ``reps``
    timed calls over the same operands, each synchronized."""
    from eges_tpu_torch import resolve_device

    dev = resolve_device(device)
    fn(*args)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
        sync(dev)
    return (time.perf_counter() - t0) / reps


def timeit_sets(fn, sets, device=None) -> float:
    """Per-call seconds over pre-built argument sets; ``sets[0]`` is the
    warm-up, the rest are timed, each synchronized."""
    from eges_tpu_torch import resolve_device

    dev = resolve_device(device)
    fn(*sets[0])
    sync(dev)
    t0 = time.perf_counter()
    for args in sets[1:]:
        fn(*args)
        sync(dev)
    return (time.perf_counter() - t0) / (len(sets) - 1)


def timeit_unique(fn, gen, reps: int = 6, device=None) -> float:
    """Per-call seconds with fresh operands from ``gen()`` for the
    warm-up and for each of ``reps`` timed calls (all made before the
    timed region)."""
    from eges_tpu_torch import resolve_device

    dev = resolve_device(device)
    fn(*gen())
    argsets = [gen() for _ in range(reps)]
    sync(dev)
    t0 = time.perf_counter()
    for args in argsets:
        fn(*args)
        sync(dev)
    return (time.perf_counter() - t0) / reps


# bytes written before each cold call: ten times the H100's 50 MB L2,
# and at the card's 3.35 TB/s some 160 us, longer than a wrapper takes to
# enqueue its kernel
FLUSH_BYTES = 512 << 20


def cuda_event_ms(fn, *args, reps: int = 10, device=None,
                  cold: bool = False) -> float:
    """Mean ms of the card's work for one call of ``fn(*args)``, by CUDA
    events, after one warm-up call.  By default the events enclose
    ``reps`` calls back to back: the host's time to enqueue shows where
    it is longer than the card's work, and inputs that fit stay in L2
    from call to call.  With ``cold`` each call is timed alone after
    ``FLUSH_BYTES`` are written, so its inputs come from device memory,
    and the card is still writing when the host has enqueued the call:
    the events then time the kernel and the card's few microseconds from
    event to kernel, not the host; the median of the ``reps`` calls is
    returned, since a call whose host enqueue stalls past the flush
    times the host too (seen as single calls of 0.2-0.5 ms among 0.01 ms
    ones).  Raises for a device that is not a card."""
    import torch

    from eges_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("cuda_event_ms times the card: give a CUDA device")
    if cold:
        return cold_event_ms([(fn, args)], reps=reps, device=dev)[0]
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def cold_event_ms(calls, reps: int = 10, device=None) -> list[float]:
    """:func:`cuda_event_ms` with ``cold`` for several ``(fn, args)``
    calls at once: each warmed up once, then ``reps`` rounds in which
    every call is timed alone after ``FLUSH_BYTES`` are written, one call
    after another; the median of each call's rounds, in order.  The calls
    share every stretch of the run, so a slow stretch of the card or the
    host moves them all and not one alone.  Raises for a device that is
    not a card."""
    import torch

    from eges_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("cold_event_ms times the card: give a CUDA device")
    for fn, args in calls:
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    times = [[] for _ in calls]
    for _ in range(reps):
        for t, (fn, args) in zip(times, calls):
            flush.zero_()
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
            t.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def profile_window(fn, *args, reps: int = 1, device=None):
    """``reps`` synchronized calls of ``fn(*args)`` under ``torch.profiler``
    with CUDA activity: ``([(name, device us)] of every kernel, copy and
    memset they ran, in the order they started, wall seconds of the
    calls)``.  One call before them
    is the profiler's warm-up step, whose events are dropped, so that
    the profiler's start-up lies outside the window.  Raises for a device
    that is not a card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from eges_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_window traces the card: give a CUDA "
                           "device")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn(*args)
        torch.cuda.synchronize(dev)
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        prof.step()
    ran = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in ran], wall
