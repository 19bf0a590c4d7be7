"""The port's static-analysis gate: AST rules over ``eges_tpu_torch`` and
``chip_smoke.py``, the counterpart of the JAX repo's ``harness/analysis``.

Run with ``python -m eges_tpu_torch.harness.analysis``.  See core.py for
the finding/waiver/baseline model and the checker modules (jit_purity,
host_sync, transfer, dtypes, layers) for the rules.  Stdlib only: it
reads source files and never imports them, so it has no device.
"""

from eges_tpu_torch.harness.analysis.core import (  # noqa: F401
    DEFAULT_BASELINE,
    DEFAULT_PATHS,
    BaselineError,
    Finding,
    Project,
    Report,
    run,
)
