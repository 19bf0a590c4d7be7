"""Batched sender recovery on the card: ``ecrecover_batch`` and the
``BatchVerifier`` facade that the transaction pool, the block validator
and the consensus vote checks call.

The port of the fused path of ``eges_tpu/crypto/verifier.py``: 18 kernel
launches turn ``[N, 65]`` wire signatures and ``[N, 32]`` hashes into
20-byte addresses, 64-byte public keys and a validity mask, and nothing
leaves the device until the facade copies the results back.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from eges_tpu_torch import resolve_device
from eges_tpu_torch.crypto.bucketing import bucket_round
from eges_tpu_torch.ops import ec
from eges_tpu_torch.ops import kernels as K


def words_to_bytes(rows: torch.Tensor, B: int) -> torch.Tensor:
    """``[W, Bpad]`` little-endian 32-bit words -> ``[B, 4*W]`` uint8 byte
    stream (word LSB first: the keccak byte order both the digest and the
    packed qx || qy block use)."""
    wb = rows[:, :B].to(torch.int64)
    b = torch.stack([(wb >> (8 * j)) & 0xFF for j in range(4)], dim=1)
    return b.permute(2, 0, 1).reshape(B, 4 * rows.shape[0]).to(torch.uint8)


def addr_from_digest_rows(dig: torch.Tensor, B: int) -> torch.Tensor:
    """``[8, Bpad]`` keccak digest words -> ``[B, 20]`` addresses (digest
    bytes 12..31, i.e. words 3..7)."""
    return words_to_bytes(dig[3:8], B)


def ecrecover_batch(sigs: torch.Tensor, hashes: torch.Tensor):
    """Batched sender recovery.

    ``sigs [N, 65]`` uint8 wire signatures and ``hashes [N, 32]`` uint8
    message hashes, on one device.  Returns ``(addrs [N, 20] uint8,
    pubs [N, 64] uint8, ok [N] int32)``; invalid rows are zero with
    ``ok == 0``.  The finish kernel already packed the masked keccak
    block, whose first 16 words are the big-endian bytes of qx || qy.
    """
    B = sigs.shape[0]
    _qx, _qy, ok, words = ec.ecrecover_point_fused(sigs, hashes)
    addrs = addr_from_digest_rows(K.keccak_rows_pallas(words), B)
    pubs = words_to_bytes(words[:16], B)
    return addrs * ok[:, None].to(torch.uint8), pubs, ok


class BatchVerifier:
    """Host facade over :func:`ecrecover_batch`.

    Pads each request up to a power-of-two bucket, stages it through a
    pool of host buffers (pinned when the device is a card), runs the
    batch and returns numpy.  Runs on the card unless ``device="cpu"``
    is asked for, and raises when there is no card.
    """

    def __init__(self, device=None, min_bucket: int = 16):
        self.device = resolve_device(device)
        self._min_bucket = min_bucket
        self._pinned = self.device.type == "cuda"
        # per-bucket pool of host staging buffers; the lock covers only
        # the pop and push, so concurrent callers overlap
        self._stage_bufs: dict[int, list[dict[str, torch.Tensor]]] = {}
        self._staging_lock = threading.Lock()
        # injectable device-failure hook: called with the row count at
        # the head of every device entry point (fault injection)
        self.failure_hook = None

    def _maybe_fail(self, n: int) -> None:
        hook = self.failure_hook
        if hook is not None:
            hook(n)

    @property
    def device_kind(self) -> str:
        """Platform plus hardware name, e.g. ``cuda:NVIDIA H100 80GB
        HBM3`` or ``cpu:cpu``."""
        if self.device.type == "cuda":
            return f"cuda:{torch.cuda.get_device_name(self.device)}"
        return "cpu:cpu"

    def _pad(self, n: int) -> int:
        return bucket_round(max(n, 1), self._min_bucket)

    def _stage_acquire(self, b: int) -> dict[str, torch.Tensor]:
        """A host staging buffer set from the per-bucket pool."""
        with self._staging_lock:
            pool = self._stage_bufs.setdefault(b, [])
            st = pool.pop() if pool else None
        if st is None:
            st = {"sigs": torch.zeros((b, 65), dtype=torch.uint8,
                                      pin_memory=self._pinned),
                  "hashes": torch.zeros((b, 32), dtype=torch.uint8,
                                        pin_memory=self._pinned)}
        return st

    def _stage_release(self, b: int, st: dict[str, torch.Tensor]) -> None:
        # only after the results are back: the upload has been consumed
        with self._staging_lock:
            self._stage_bufs.setdefault(b, []).append(st)

    def ecrecover(self, sigs: np.ndarray, hashes: np.ndarray):
        """``sigs [N, 65]`` u8, ``hashes [N, 32]`` u8 -> ``(addrs [N, 20]
        u8, pubs [N, 64] u8, ok [N] bool)`` as numpy, after the device
        has finished."""
        n = sigs.shape[0]
        if n == 0:
            return (np.zeros((0, 20), np.uint8), np.zeros((0, 64), np.uint8),
                    np.zeros((0,), bool))
        self._maybe_fail(n)
        b = self._pad(n)
        # a batch that lands exactly on its bucket in uint8-contiguous
        # arrays is uploaded as it is, with no staging copy
        direct = (n == b and sigs.dtype == np.uint8
                  and hashes.dtype == np.uint8
                  and sigs.flags.c_contiguous and hashes.flags.c_contiguous)
        st = None if direct else self._stage_acquire(b)
        try:
            if direct:
                hs, hh = torch.from_numpy(sigs), torch.from_numpy(hashes)
            else:
                hs, hh = st["sigs"], st["hashes"]
                hs[:n] = torch.from_numpy(np.asarray(sigs, np.uint8))
                hs[n:] = 0
                hh[:n] = torch.from_numpy(np.asarray(hashes, np.uint8))
                hh[n:] = 0
            async_copy = st is not None and self._pinned
            ds = hs.to(self.device, non_blocking=async_copy)
            dh = hh.to(self.device, non_blocking=async_copy)
            addrs, pubs, ok = ecrecover_batch(ds, dh)
            # copying back waits for the device: the staging buffers are
            # free for the next batch after this
            out = (addrs[:n].cpu().numpy(), pubs[:n].cpu().numpy(),
                   ok[:n].cpu().numpy().astype(bool))
        finally:
            if st is not None:
                self._stage_release(b, st)
        return out

    def recover_addresses(self, sigs: np.ndarray, hashes: np.ndarray):
        """``(addrs [N, 20] u8, ok [N] bool)``."""
        addrs, _, ok = self.ecrecover(sigs, hashes)
        return addrs, ok


@functools.lru_cache(maxsize=1)
def default_verifier() -> BatchVerifier:
    """The process-wide verifier on the default card."""
    return BatchVerifier()
