"""eges-tpu on PyTorch and CUDA: batched sender recovery, classic ECDSA
verify and Keccak-256 on an NVIDIA H100 (the three model families of
``models``).

The JAX package ``eges_tpu`` stays the reference.  This package holds its
own copy of what each ported slice needs and never imports ``jax`` or any
module of ``eges_tpu``.  Every Pallas kernel of the ported path has a CUDA
C++ kernel for ``sm_90a`` (``ops/csrc``) and a plain PyTorch version of
the same function beside it (``ops/kernels.py``); the plain version runs
only for tensors that lie on the CPU, as the tests use it.

Entry points run on the card unless the caller asks for the CPU.  The
static-analysis gate (``harness.analysis``) reads source files and has
no device; so that it runs without loading torch, this module imports
torch only when a device is resolved.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: ``cuda`` by default,
    which raises when no CUDA card is present; ``"cpu"`` only when the
    caller asks for it (the plain versions of the kernels then run)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
