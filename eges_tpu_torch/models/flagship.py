"""Flagship model: batched secp256k1 sender recovery.

One definition of the forward step and its example inputs, as in
``eges_tpu.models.flagship``; ``example_batch`` draws its keys and
messages from the caller's ``numpy.random.Generator``, so a seed fixes
every byte.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from eges_tpu_torch import resolve_device


def on_device(fn, device=None):
    """``fn`` with every argument moved to ``device`` (the card unless
    ``"cpu"``; raises without a card)."""
    dev = resolve_device(device)

    @functools.wraps(fn)
    def forward(*args):
        return fn(*(torch.as_tensor(a).to(dev) for a in args))

    return forward


def flagship_forward(device=None):
    """The forward step: ``(sigs [N, 65] u8, hashes [N, 32] u8) ->
    (addrs [N, 20] u8, pubs [N, 64] u8, ok [N] int32)`` on ``device``."""
    from eges_tpu_torch.crypto.verifier import ecrecover_batch

    return on_device(ecrecover_batch, device)


def example_batch(n: int, rng: np.random.Generator, invalid_every: int = 0,
                  n_keys: int = 64):
    """An ``n``-row workload of real signatures (plus an invalid row
    every ``invalid_every``) with the expected addresses.

    Returns ``(sigs [n, 65] u8, hashes [n, 32] u8, valid [n] bool,
    expect list[bytes | None])``: ``expect[i]`` is None for rows whose
    recovered address is defined but differs (corrupted-s rows).
    """
    from eges_tpu_torch.crypto import secp256k1 as host

    n_keys = min(n_keys, max(n, 1))
    msgs = [rng.bytes(32) for _ in range(n_keys)]
    privs = [rng.bytes(32) for _ in range(n_keys)]
    sig_cache = [np.frombuffer(host.ecdsa_sign(m, p), np.uint8)
                 for m, p in zip(msgs, privs)]
    addr_cache = [host.pubkey_to_address(host.privkey_to_pubkey(p))
                  for p in privs]

    sigs = np.zeros((n, 65), np.uint8)
    hashes = np.zeros((n, 32), np.uint8)
    valid = np.ones(n, bool)
    expect: list = [b""] * n
    for i in range(n):
        k = i % n_keys
        sigs[i] = sig_cache[k]
        hashes[i] = np.frombuffer(msgs[k], np.uint8)
        expect[i] = addr_cache[k]
        if invalid_every and i % invalid_every == 5:
            valid[i] = False
            if i % 2:
                sigs[i, 40] ^= 0xFF  # corrupt s: recovers a wrong address
                expect[i] = None
            else:
                sigs[i, 64] = 9       # invalid recovery id: masked row
                expect[i] = b"\0" * 20
    return sigs, hashes, valid, expect
