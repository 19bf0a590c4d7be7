"""Batched sender recovery and classic verify on the card:
``ecrecover_batch``, ``verify_batch`` and the ``BatchVerifier`` facade
that the transaction pool, the block validator and the consensus vote
checks call.

The port of ``eges_tpu/crypto/verifier.py``.  On a ``[N, ...]`` batch
the fused path runs: 18 kernel launches turn ``[N, W]`` wire
signatures (W >= 65, bytes of any integer dtype) and ``[N, 32]``
hashes into 20-byte addresses, 64-byte public keys and a validity
mask; 26 turn signatures, hashes and known ``[N, 64]`` public keys
into a validity mask.  A single row (``[65]``)
or a stacked window (``[K, N, 65]``) takes the un-fused path of
``ops/ec.py`` (about 8,400 launches, whatever the rows), as the
reference does for every shape but 2-D.  Nothing leaves the device
until the caller copies the results back.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from eges_tpu_torch import resolve_device
from eges_tpu_torch.crypto.bucketing import bucket_round
from eges_tpu_torch.ops import ec, field, keccak
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import limbs_to_bytes_be


def _limbs(rows: torch.Tensor, *offsets: int) -> list[torch.Tensor]:
    """The big-endian 32-byte values at ``offsets`` of ``[..., n]`` uint8
    rows (any layout: the limbs come out contiguous, as the kernels take
    them) -> ``[..., 16]`` int32 limb tensors."""
    wide = rows.to(torch.int32).contiguous()
    return [field.unpack_be(wide, off) for off in offsets]


def _unpack(sigs: torch.Tensor, hashes: torch.Tensor):
    """``sigs [..., 65 or more]`` u8 (r || s || v, then any bytes),
    ``hashes [..., 32]`` u8 ->
    ``(z, r, s)`` limbs ``[..., 16]`` and ``v [...]``, all int32."""
    z, r, s = _limbs(torch.cat([hashes, sigs[..., :64]], -1), 0, 32, 64)
    return z, r, s, sigs[..., 64].to(torch.int32)


def _check_rows(sigs: torch.Tensor, hashes: torch.Tensor,
                narrowest: int = 65, widest: int | None = 65) -> None:
    """Rows of ``narrowest`` to ``widest`` bytes (no upper bound for
    ``None``) with ``[..., 32]`` hashes beside them, else ValueError."""
    width = sigs.shape[-1] if sigs.dim() else 0
    if width < narrowest or (widest is not None and width > widest):
        want = (f"{narrowest}" if widest == narrowest
                else f"{narrowest} or more")
        raise ValueError(f"sigs must be [..., {want}], got "
                         f"{tuple(sigs.shape)}")
    if tuple(hashes.shape) != (*sigs.shape[:-1], 32):
        raise ValueError(f"hashes must be [..., 32] beside sigs "
                         f"{tuple(sigs.shape)}, got {tuple(hashes.shape)}")


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


@torch.inference_mode()
def ecrecover_batch(sigs: torch.Tensor, hashes: torch.Tensor):
    """Batched sender recovery.

    ``sigs [..., W]`` wire signatures for any ``W >= 65`` (r, s and v
    from bytes 0..64, as the reference's ``_unpack`` reads them; bytes
    after them are ignored) and ``hashes [..., 32]`` message hashes, byte
    values of any integer dtype (cast to uint8 once), on one device.
    Returns ``(addrs [..., 20] uint8, pubs [..., 64] uint8, ok [...]
    int32)``; invalid rows are zero with ``ok == 0``.  A ``[N, W]`` batch
    takes the fused path, whose prelude reads the rows where they lie and
    whose finish kernel already packed the masked keccak block (its first
    16 words are the big-endian bytes of qx || qy); any other shape the
    un-fused ``ecrecover_point``, then keccak of the key bytes.  A
    ``[0, W]`` batch gives empty outputs after the width checks and
    launches nothing.
    """
    sigs = keccak.as_bytes(sigs, "sigs")
    hashes = keccak.as_bytes(hashes, "hashes")
    _check_rows(sigs, hashes, 65, None)
    if sigs.dim() == 2:
        B = sigs.shape[0]
        if B == 0:  # the kernels take 1..Bpad rows
            return (sigs.new_zeros(0, 20), sigs.new_zeros(0, 64),
                    sigs.new_zeros(0, dtype=torch.int32))
        _qx, _qy, ok, words = ec.ecrecover_point_fused(sigs, hashes)
        addrs = addr_from_digest_rows(K.keccak_rows_pallas(words), B)
        pubs = words_to_bytes(words[:16], B)
        return addrs * ok[:, None].to(torch.uint8), pubs, ok
    z, r, s, v = _unpack(sigs, hashes)
    qx, qy, ok = ec.ecrecover_point(z, r, s, v)
    qx_b, qy_b = limbs_to_bytes_be(qx), limbs_to_bytes_be(qy)
    mask = ok[..., None].to(torch.uint8)
    addrs = keccak.pubkey_to_address(qx_b, qy_b)
    pubs = torch.cat([qx_b, qy_b], -1) * mask
    return addrs * mask, pubs, ok


@torch.inference_mode()
def verify_batch(sigs: torch.Tensor, hashes: torch.Tensor,
                 pubs: torch.Tensor) -> torch.Tensor:
    """Batched classic ECDSA verify against known public keys.

    ``sigs [..., W]`` uint8 for any ``W >= 64`` (r || s from bytes
    0..63; byte 64, the recovery byte, and any bytes after it are
    ignored, as the reference's ``_unpack`` reads them), ``hashes [...,
    32]`` uint8, ``pubs [..., 64]`` uint8 (x || y, big-endian), on one
    device.  Returns ``ok [...]`` int32.  Narrower rows raise
    ValueError, where the reference fails to reshape them.  A ``[N,
    ...]`` batch takes the fused path, any other shape the un-fused one;
    a ``[0, W]`` batch gives an empty ``ok`` after the width checks and
    launches nothing.
    """
    _check_rows(sigs, hashes, 64, None)
    if tuple(pubs.shape) != (*sigs.shape[:-1], 64):
        raise ValueError(f"pubs must be [..., 64] beside sigs, got "
                         f"{tuple(pubs.shape)}")
    if sigs.dim() == 2 and sigs.shape[0] == 0:  # as ecrecover_batch
        return sigs.new_zeros(0, dtype=torch.int32)
    if sigs.shape[-1] == 64:
        sigs = F.pad(sigs, (0, 1))
    z, r, s, _ = _unpack(sigs, hashes)
    return ec.ecdsa_verify_point(z, r, s, *_limbs(pubs, 0, 32))


class BatchVerifier:
    """Host facade over :func:`ecrecover_batch` and :func:`verify_batch`.

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

    def _stage_acquire(self, b: int,
                       with_pubs: bool = False) -> dict[str, torch.Tensor]:
        """A host staging buffer set from the per-bucket pool; with
        ``with_pubs`` it also holds a ``[b, 64]`` public-key buffer."""
        with self._staging_lock:
            pool = self._stage_bufs.setdefault(b, [])
            st = pool.pop() if pool else None
        if st is None:
            st = {"sigs": self._host_buf(b, 65),
                  "hashes": self._host_buf(b, 32)}
        if with_pubs and "pubs" not in st:
            st["pubs"] = self._host_buf(b, 64)
        return st

    def _host_buf(self, b: int, width: int) -> torch.Tensor:
        return torch.zeros((b, width), dtype=torch.uint8,
                           pin_memory=self._pinned)

    def _stage_release(self, b: int, st: dict[str, torch.Tensor]) -> None:
        # only after the results are back: the upload has been consumed
        with self._staging_lock:
            self._stage_bufs.setdefault(b, []).append(st)

    def ecrecover(self, sigs: np.ndarray, hashes: np.ndarray):
        """``sigs [N, W]`` u8, ``hashes [N, 32]`` u8 -> ``(addrs [N, 20]
        u8, pubs [N, 64] u8, ok [N] bool)`` as numpy, after the device
        has finished.  A batch on its bucket in uint8-contiguous arrays
        goes up as it is, any ``W >= 65``; the others are staged 65 bytes
        wide, so other widths raise ValueError there, as the reference's
        staging copy does."""
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
        if not direct and sigs.shape[1:] != (65,):
            raise ValueError(f"sigs: staged rows are 65 bytes wide, got "
                             f"{tuple(sigs.shape)} ({n} rows, bucket {b})")
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

    def verify(self, sigs: np.ndarray, hashes: np.ndarray,
               pubs: np.ndarray) -> np.ndarray:
        """Classic verify: ``sigs [N, W]`` u8 of any width, ``hashes [N,
        32]`` u8, ``pubs [N, 64]`` u8 -> ``ok [N]`` bool as numpy, after
        the device has finished.  Rows are staged 65 bytes wide: wider
        ones are cut, narrower ones zero-padded, as the reference's
        facade does (``eges_tpu/crypto/verifier.py`` ``verify``).
        Bucketed and staged like :meth:`ecrecover`; the padded rows of
        every staging buffer are zeroed, so no row of an earlier batch
        reaches this one."""
        n = sigs.shape[0]
        if n == 0:
            return np.zeros((0,), bool)
        self._maybe_fail(n)
        b = self._pad(n)
        w = min(sigs.shape[1], 65)
        st = self._stage_acquire(b, with_pubs=True)
        try:
            hs, hh, hq = st["sigs"], st["hashes"], st["pubs"]
            hs[:n, :w] = torch.from_numpy(np.asarray(sigs[:, :w], np.uint8))
            hs[:n, w:] = 0
            hs[n:] = 0
            hh[:n] = torch.from_numpy(np.asarray(hashes, np.uint8))
            hh[n:] = 0
            hq[:n] = torch.from_numpy(np.asarray(pubs, np.uint8))
            hq[n:] = 0
            ds, dh, dq = (t.to(self.device, non_blocking=self._pinned)
                          for t in (hs, hh, hq))
            ok = verify_batch(ds, dh, dq)
            # copying back waits for the device: the staging buffers are
            # free for the next batch after this
            out = ok[:n].cpu().numpy().astype(bool)
        finally:
            self._stage_release(b, st)
        return out


@functools.lru_cache(maxsize=1)
def default_verifier() -> BatchVerifier:
    """The process-wide verifier on the default card."""
    return BatchVerifier()
