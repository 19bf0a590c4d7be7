"""Shared request-limit clamping for the telemetry RPC surface.

The port's copy of ``eges_tpu/utils/limits.py``, unchanged.

``thw_journal`` / ``thw_traces`` / ``thw_flight`` each accept a caller
``limit`` and each used to hand-roll the same ``max(1, min(limit,
4096))`` clamp.  One helper keeps the bounds in one place (and one
test), so a future RPC can't silently ship a different ceiling.
"""

from __future__ import annotations

RPC_LIMIT_MIN = 1
RPC_LIMIT_MAX = 4096


def clamp_rpc_limit(limit) -> int:
    """Clamp a caller-supplied row limit into ``[RPC_LIMIT_MIN,
    RPC_LIMIT_MAX]``; non-numeric input falls back to the minimum."""
    try:
        n = int(limit)
    except (TypeError, ValueError):
        return RPC_LIMIT_MIN
    return max(RPC_LIMIT_MIN, min(n, RPC_LIMIT_MAX))
