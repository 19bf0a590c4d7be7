"""Node identity keys.

The port's copy of ``eges_tpu/crypto/keys.py``, over the port's host
models.

The reference keeps scrypt-JSON keystores (ref: accounts/keystore/); the
permissioned Geec chain only ever needs a stable per-node secp256k1 keypair
and its derived address, so this build uses a minimal deterministic keystore:
a 32-byte private key file per node plus helpers to derive pubkey/address.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from eges_tpu_torch.crypto.keccak import keccak256
from eges_tpu_torch.crypto.secp256k1 import N, ecdsa_sign, privkey_to_pubkey, pubkey_to_address


@dataclass(frozen=True)
class KeyPair:
    priv: bytes  # 32 bytes
    pub: bytes   # 64 bytes (x || y)
    address: bytes  # 20 bytes

    def sign(self, msg_hash: bytes) -> bytes:
        return ecdsa_sign(msg_hash, self.priv)


def keypair_from_priv(priv: bytes) -> KeyPair:
    pub = privkey_to_pubkey(priv)
    return KeyPair(priv=priv, pub=pub, address=pubkey_to_address(pub))


def generate_keypair(seed: bytes | None = None) -> KeyPair:
    """Generate a keypair; with ``seed`` the key is deterministic (used by the
    test harness to give each simulated node a stable identity)."""
    while True:
        # analysis: allow-determinism(entropy only on the seedless path; sims always seed)
        raw = keccak256(seed) if seed is not None else os.urandom(32)
        d = int.from_bytes(raw, "big")
        if 1 <= d < N:
            return keypair_from_priv(raw)
        seed = raw  # re-hash until in range


def load_or_create(path: str, seed: bytes | None = None) -> KeyPair:
    if os.path.exists(path):
        with open(path, "rb") as fh:
            raw = fh.read()
        if len(raw) != 32:
            raise ValueError(f"key file {path} must be exactly 32 raw bytes, got {len(raw)}")
        return keypair_from_priv(raw)
    kp = generate_keypair(seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # O_EXCL closes the exists-check race; 0600 keeps the raw key private.
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "wb") as fh:
        fh.write(kp.priv)
    return kp


def deterministic_node_key(i: int) -> bytes:
    """Deterministic 32-byte dev/test key for node index ``i`` — the ONE
    scheme shared by the simulator and the real-socket harness, valid
    for any cluster size (a single-byte pattern overflows at index 255)."""
    return (i + 1).to_bytes(4, "big") * 8
