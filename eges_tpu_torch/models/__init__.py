"""The model registry of the port: the three verification workload
families the card runs, as in ``eges_tpu.models``.

* ``ecrecover`` (flagship): batched sender recovery,
  ``(sigs [N, 65], hashes [N, 32]) -> (addrs, pubs, ok)``.
* ``classic_verify``: batched ECDSA verify against known public keys,
  ``(sigs [N, 64 or 65], hashes [N, 32], pubs [N, 64]) -> ok``.
* ``keccak256``: batched fixed-length Keccak-256,
  ``data [..., L] -> digests [..., 32]``.

``model(name)`` returns the forward step on the card (``device="cpu"``
asks for the plain versions on the CPU): it takes numpy arrays or
tensors, moves them to the device and returns tensors there.
"""

from __future__ import annotations

from eges_tpu_torch.models.flagship import (  # noqa: F401
    example_batch, flagship_forward, on_device,
)

MODELS = ("ecrecover", "classic_verify", "keccak256")


def model(name: str, device=None):
    """The named forward step on ``device``; raises ``KeyError`` for an
    unknown name and ``RuntimeError`` without a card unless
    ``device="cpu"``."""
    if name in ("ecrecover", "flagship"):
        return flagship_forward(device)
    if name == "classic_verify":
        from eges_tpu_torch.crypto.verifier import verify_batch

        return on_device(verify_batch, device)
    if name == "keccak256":
        from eges_tpu_torch.ops.keccak import keccak256_fixed

        return on_device(keccak256_fixed, device)
    raise KeyError(f"unknown model {name!r}")
