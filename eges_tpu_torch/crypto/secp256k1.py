"""secp256k1 ECDSA in pure Python: the host model of the port.

As in the reference, ``ecdsa_sign``, ``ecdsa_recover``, ``ecdsa_verify``
and ``privkey_to_pubkey`` dispatch to the native library
(``crypto/native.py``) when it is built; the pure-Python functions stay
under ``*_py`` names, and ``native.self_check`` holds the library
against them.  It builds the fixed-base window tables of ``ops/ec.py`` and is the
oracle ``chip_smoke.py`` holds the card's results against.  Signatures
use the Ethereum 65-byte wire format ``r[32] || s[32] || v[1]`` with
``v`` the recovery id.  Nonces are deterministic (RFC 6979 with
HMAC-SHA256), so every run signs the same bytes.
"""

from __future__ import annotations

import hashlib
import hmac

from eges_tpu_torch.crypto.keccak import keccak256

# Curve parameters: y^2 = x^3 + 7 over F_P, group order N.
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)

Point = tuple[int, int] | None  # None = point at infinity


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def point_add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_mul(k: int, p: Point) -> Point:
    acc: Point = None
    add = p
    while k:
        if k & 1:
            acc = point_add(acc, add)
        add = point_add(add, add)
        k >>= 1
    return acc


def ecdh_shared(priv: bytes, peer_pub: bytes) -> bytes:
    """ECDH shared secret: keccak256 of the x-coordinate of
    ``priv * peer_pub`` (the RLPx-handshake role, ref: p2p/rlpx.go
    secp256k1 ECDH; keccak in place of its NIST KDF), as the reference's
    (the gossip plane's v3 handshake, ``net/transports.py``).
    ``peer_pub`` is a 64-byte uncompressed public key; raises ValueError
    off-curve."""
    if len(peer_pub) != 64:
        raise ValueError("pubkey must be 64 bytes")
    x = int.from_bytes(peer_pub[:32], "big")
    y = int.from_bytes(peer_pub[32:], "big")
    if x >= P or y >= P or (y * y - (x * x * x + 7)) % P != 0:
        raise ValueError("point not on curve")
    d = int.from_bytes(priv, "big")
    if not 1 <= d < N:
        raise ValueError("private key out of range")
    s = point_mul(d, (x, y))
    if s is None:
        raise ValueError("degenerate shared point")
    return keccak256(s[0].to_bytes(32, "big"))


def privkey_to_pubkey(priv: bytes) -> bytes:
    """64-byte uncompressed public key (x || y) of a 32-byte private key."""
    d = int.from_bytes(priv, "big")
    if not 1 <= d < N:
        raise ValueError("private key out of range")
    pub = point_mul(d, G)
    return pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")


def pubkey_to_address(pub: bytes) -> bytes:
    """Ethereum address: the last 20 bytes of keccak256 of the 64-byte
    public key."""
    if len(pub) == 65 and pub[0] == 4:
        pub = pub[1:]
    if len(pub) != 64:
        raise ValueError("expected 64-byte public key")
    return keccak256(pub)[12:]


def _rfc6979_nonce(msg_hash: bytes, priv: bytes) -> int:
    """Deterministic nonce per RFC 6979 (HMAC-SHA256, qlen = 256)."""
    x = priv.rjust(32, b"\x00")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + msg_hash, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + msg_hash, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        t = int.from_bytes(v, "big")
        if 1 <= t < N:
            return t
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def ecdsa_sign(msg_hash: bytes, priv: bytes) -> bytes:
    """Sign a 32-byte hash; 65 bytes ``r || s || v`` with low-s
    normalisation and ``v`` the recovery id."""
    if len(msg_hash) != 32:
        raise ValueError("message hash must be 32 bytes")
    if len(priv) != 32:
        raise ValueError("private key must be 32 bytes")
    d = int.from_bytes(priv, "big")
    if not 1 <= d < N:
        raise ValueError("private key out of range")
    z = int.from_bytes(msg_hash, "big")
    while True:
        k = _rfc6979_nonce(msg_hash, priv)
        R = point_mul(k, G)
        r = R[0] % N
        if r == 0:
            msg_hash = hashlib.sha256(msg_hash).digest()
            continue
        s = _inv(k, N) * (z + r * d) % N
        if s == 0:
            msg_hash = hashlib.sha256(msg_hash).digest()
            continue
        # recid = (overflow << 1) | (R.y & 1)
        v = (R[1] & 1) | (2 if R[0] >= N else 0)
        if s > N // 2:  # low-s normalisation flips the recovery parity
            s = N - s
            v ^= 1
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])


def ecdsa_recover(msg_hash: bytes, sig: bytes) -> bytes:
    """Recover the 64-byte public key from a 65-byte ``r||s||v``
    signature; raises ValueError for every invalid class."""
    if len(sig) != 65:
        raise ValueError("signature must be 65 bytes")
    if len(msg_hash) != 32:
        raise ValueError("message hash must be 32 bytes")
    r = int.from_bytes(sig[0:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    v = sig[64]
    if v >= 4:
        raise ValueError("invalid recovery id")
    if not (1 <= r < N and 1 <= s < N):
        raise ValueError("r/s out of range")
    x = r + N if v & 2 else r
    if x >= P:
        raise ValueError("invalid r for this recovery id")
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        raise ValueError("r does not correspond to a curve point")
    if (y & 1) != (v & 1):
        y = P - y
    z = int.from_bytes(msg_hash, "big")
    r_inv = _inv(r, N)
    u1 = (-z * r_inv) % N
    u2 = (s * r_inv) % N
    q = point_add(point_mul(u1, G), point_mul(u2, (x, y)))
    if q is None:
        raise ValueError("recovered point at infinity")
    return q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def ecdsa_verify(msg_hash: bytes, sig: bytes, pub: bytes) -> bool:
    """Classic ECDSA verify of ``r||s`` (the first 64 bytes of ``sig``)
    against a 64-byte public key ``x || y``.  Rejects r or s out of
    range, malleable high-s signatures (s > N // 2, as libsecp256k1's
    verify does), keys off the curve and a result at infinity."""
    if len(msg_hash) != 32:
        return False
    try:
        r = int.from_bytes(sig[0:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        if not (1 <= r < N and 1 <= s <= N // 2):
            return False
        qx = int.from_bytes(pub[-64:-32], "big")
        qy = int.from_bytes(pub[-32:], "big")
        if (qy * qy - qx * qx * qx - 7) % P != 0:
            return False
        z = int.from_bytes(msg_hash, "big")
        s_inv = _inv(s, N)
        u1 = z * s_inv % N
        u2 = r * s_inv % N
        pt = point_add(point_mul(u1, G), point_mul(u2, (qx, qy)))
        if pt is None:
            return False
        return pt[0] % N == r
    except (ValueError, AssertionError):
        return False


def recover_address(msg_hash: bytes, sig: bytes) -> bytes:
    """Sender recovery: a 65-byte signature -> the signer's 20-byte
    address (raises ValueError for every invalid class), the per-row
    result that the batched path computes on the card."""
    return pubkey_to_address(ecdsa_recover(msg_hash, sig))


# ---------------------------------------------------------------------------
# native dispatch: prefer the C++ library when built (the reference's
# cgo-vs-pure-Go split, crypto/signature_cgo.go:17); the pure-Python
# implementations above remain the golden model and are kept under
# ``*_py`` names for cross-checking.
# ---------------------------------------------------------------------------

ecdsa_sign_py = ecdsa_sign
ecdsa_recover_py = ecdsa_recover
ecdsa_verify_py = ecdsa_verify
privkey_to_pubkey_py = privkey_to_pubkey

try:
    from eges_tpu_torch.crypto import native as _native

    if _native.available():
        def ecdsa_sign(msg_hash: bytes, priv: bytes) -> bytes:  # noqa: F811
            if len(msg_hash) != 32 or len(priv) != 32:
                raise ValueError("hash and key must be 32 bytes")
            return _native.ec_sign(bytes(msg_hash), bytes(priv))

        def ecdsa_recover(msg_hash: bytes, sig: bytes) -> bytes:  # noqa: F811
            if len(sig) != 65 or len(msg_hash) != 32:
                raise ValueError("need 32-byte hash and 65-byte signature")
            return _native.ec_recover(bytes(msg_hash), bytes(sig))

        def ecdsa_verify(msg_hash: bytes, sig: bytes, pub: bytes) -> bool:  # noqa: F811
            if len(msg_hash) != 32 or len(sig) < 64:
                return False
            try:
                pub64 = pub[-64:] if len(pub) in (64, 65) else pub
                if len(pub64) != 64:
                    return False
                return _native.ec_verify(bytes(msg_hash), bytes(sig[:64]),
                                         bytes(pub64))
            except Exception:
                return False

        def privkey_to_pubkey(priv: bytes) -> bytes:  # noqa: F811
            if len(priv) != 32:
                raise ValueError("private key must be 32 bytes")
            return _native.ec_pubkey(bytes(priv))
# analysis: allow-swallow(optional native-accel probe; pure-python defs stand)
except Exception:  # pragma: no cover - native lib absent
    pass
