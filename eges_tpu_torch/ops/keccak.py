"""Batched Keccak-256 of fixed-length messages on the tensors' device.

The port of ``eges_tpu/ops/keccak_tpu.py``.  ``keccak256_fixed`` pads
``[..., L]`` byte messages with Ethereum's legacy Keccak padding (domain
byte 0x01, not NIST SHA-3's 0x06) and absorbs them block by block.  A
1-D batch of single-block messages (L < 136: transaction hashes, the
64-byte public keys of address derivation) goes through the one-block
kernel ``keccak_block_pallas``, as the reference's fused path does.
Longer messages and other batch shapes run ``_keccak_f``, a port of the
reference's XLA loop in PyTorch operations: the state is two ``[..., 25]``
tensors of 32-bit halves (held in int64) and each round is a handful of
whole-state operations.  The reference runs that case without a Pallas
kernel, so the port has none there either.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.field import KECCAK_RC, KECCAK_ROT, M32

RATE = 136  # bytes, Keccak-256 (capacity 512)

# pi: destination lane y + 5*((2x + 3y) % 5) takes lane x + 5y rotated
# by KECCAK_ROT[x][y]
_PI_SRC = [0] * 25
_PI_ROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _PI_ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = KECCAK_ROT[_x][_y]


def _rotl_pairs(lo, hi, amounts):
    """Rotate the 64-bit lanes (lo, hi) left by per-lane constants."""
    r = amounts % 64
    swap = r >= 32
    rr = r % 32
    l0 = torch.where(swap, hi, lo)
    h0 = torch.where(swap, lo, hi)
    inv = (32 - rr) % 32
    nz = rr != 0
    nl = torch.where(nz, ((l0 << rr) & M32) | (h0 >> inv), l0)
    nh = torch.where(nz, ((h0 << rr) & M32) | (l0 >> inv), h0)
    return nl, nh


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device):
    """The pi gather, the rho rotations and the byte shifts on
    ``device``, made once (the permutation only reads them)."""
    return (torch.tensor(_PI_SRC, device=device),
            torch.tensor(_PI_ROT, dtype=torch.int64, device=device),
            torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=device))


def _keccak_f(lo: torch.Tensor, hi: torch.Tensor):
    """Keccak-f[1600] over ``[..., 25]`` states of (lo, hi) halves."""
    src, rot, _ = _consts(lo.device)
    shape = lo.shape
    for rc in KECCAK_RC:
        # theta: column parities, then D[x] = C[x-1] ^ rot(C[x+1], 1)
        g_lo = lo.reshape(*shape[:-1], 5, 5)      # [..., y, x]
        g_hi = hi.reshape(*shape[:-1], 5, 5)
        c_lo = g_lo[..., 0, :] ^ g_lo[..., 1, :] ^ g_lo[..., 2, :] \
            ^ g_lo[..., 3, :] ^ g_lo[..., 4, :]
        c_hi = g_hi[..., 0, :] ^ g_hi[..., 1, :] ^ g_hi[..., 2, :] \
            ^ g_hi[..., 3, :] ^ g_hi[..., 4, :]
        r_lo = ((c_lo << 1) & M32) | (c_hi >> 31)
        r_hi = ((c_hi << 1) & M32) | (c_lo >> 31)
        d_lo = torch.roll(c_lo, 1, -1) ^ torch.roll(r_lo, -1, -1)
        d_hi = torch.roll(c_hi, 1, -1) ^ torch.roll(r_hi, -1, -1)
        lo = lo ^ d_lo.repeat(*([1] * (d_lo.dim() - 1)), 5)
        hi = hi ^ d_hi.repeat(*([1] * (d_hi.dim() - 1)), 5)
        # rho and pi: a constant gather and constant rotations
        b_lo, b_hi = _rotl_pairs(lo[..., src], hi[..., src], rot)
        # chi along each row of 5: A[x] = B[x] ^ (~B[x+1] & B[x+2])
        g_lo = b_lo.reshape(*shape[:-1], 5, 5)
        g_hi = b_hi.reshape(*shape[:-1], 5, 5)
        lo = (g_lo ^ ((torch.roll(g_lo, -1, -1) ^ M32)
                      & torch.roll(g_lo, -2, -1))).reshape(shape)
        hi = (g_hi ^ ((torch.roll(g_hi, -1, -1) ^ M32)
                      & torch.roll(g_hi, -2, -1))).reshape(shape)
        # iota
        lo = lo.clone()
        hi = hi.clone()
        lo[..., 0] ^= rc & M32
        hi[..., 0] ^= rc >> 32
    return lo, hi


def as_bytes(t: torch.Tensor, what: str) -> torch.Tensor:
    """A byte tensor of any integer dtype as uint8, cast once (values
    past 255 wrap; nothing checks them, which would wait for the card);
    a float, complex or bool tensor raises TypeError."""
    if t.dtype == torch.uint8:
        return t
    if (t.dtype.is_floating_point or t.dtype.is_complex
            or t.dtype == torch.bool):
        raise TypeError(f"{what}: expected an integer dtype, got {t.dtype}")
    return t.to(torch.uint8)


def _words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """``[..., 8]`` little-endian 32-bit digest words -> ``[..., 32]``
    uint8."""
    w = words.to(torch.int64) & M32
    shifts = _consts(w.device)[2]
    return ((w[..., :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(
        *w.shape[:-1], 32)


@torch.inference_mode()
def keccak256_fixed(data: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of each ``[..., L]`` byte message (L fixed; bytes of
    any integer dtype, cast to uint8 once by :func:`as_bytes`): returns
    ``[..., 32]`` uint8 digests on the same device."""
    data = as_bytes(data, "data")
    L = data.shape[-1]
    batch = data.shape[:-1]
    nblocks = L // RATE + 1  # the last block holds the padding
    padded_len = nblocks * RATE
    buf = F.pad(data, (0, padded_len - L)).to(torch.int64)
    buf[..., L] = 0x01
    buf[..., padded_len - 1] |= 0x80
    b4 = buf.reshape(*batch, nblocks, RATE // 4, 4)
    lanes = (b4[..., 0] | (b4[..., 1] << 8) | (b4[..., 2] << 16)
             | (b4[..., 3] << 24))          # [..., nblocks, 34]
    if nblocks == 1 and len(batch) == 1:
        words = lanes[:, 0, :].to(torch.int32).contiguous()
        return _words_to_bytes(K.keccak_block_pallas(words))
    lo = torch.zeros(*batch, 25, dtype=torch.int64, device=data.device)
    hi = torch.zeros_like(lo)
    for blk in range(nblocks):
        w = lanes[..., blk, :]
        lo[..., :17] ^= w[..., 0::2]
        hi[..., :17] ^= w[..., 1::2]
        lo, hi = _keccak_f(lo, hi)
    out = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1],
                       lo[..., 2], hi[..., 2], lo[..., 3], hi[..., 3]], -1)
    return _words_to_bytes(out)


def pubkey_to_address(qx_bytes: torch.Tensor,
                      qy_bytes: torch.Tensor) -> torch.Tensor:
    """Ethereum addresses ``keccak256(x || y)[12:]`` of ``[..., 32]``
    key halves (bytes of any integer dtype): ``[..., 20]`` uint8."""
    return keccak256_fixed(torch.cat([as_bytes(qx_bytes, "qx_bytes"),
                                      as_bytes(qy_bytes, "qy_bytes")],
                                     -1))[..., 12:]
