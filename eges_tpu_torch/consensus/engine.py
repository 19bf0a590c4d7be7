"""Consensus-engine seam — re-export of :mod:`eges_tpu_torch.core.engine`.

The port's copy of ``eges_tpu/consensus/engine.py``: it re-exports the
port's engines, whose PoW sweep runs on the card.

The interface definition lives in ``core`` (the chain layer consumes
it, and L1 must not import L2 — see the architecture manifest in
``harness/analysis/layermap.py``); this module keeps the historical
``eges_tpu_torch.consensus.engine`` import path working for the consensus
layer and external callers.  Importing core from consensus is the
legal direction, so the shim itself is layer-clean.
"""

from eges_tpu_torch.core.engine import (  # noqa: F401
    DevEngine,
    Engine,
    EngineError,
    GeecEngine,
    PowEngine,
)

__all__ = ["DevEngine", "Engine", "EngineError", "GeecEngine",
           "PowEngine"]
