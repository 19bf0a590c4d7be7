"""ctypes bindings for the native C++ crypto library.

The port's copy of ``eges_tpu/crypto/native.py``: the same library
(``native/libgeec_native.so`` at the repo root, optional as there), its
self check held against the port's own host models.

The reference reaches its C crypto through cgo
(crypto/secp256k1/secp256.go:70,105,126); here the boundary is ctypes
over a plain C ABI (``native/libgeec_native.so``).  The library is
optional: :func:`available` gates use, and the pure-Python golden model
stays authoritative for tests.  Build with ``make -C native``.
"""

from __future__ import annotations

import ctypes
import os

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "native", "libgeec_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.geec_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_char_p]
    lib.geec_ec_recover.argtypes = [ctypes.c_char_p] * 3
    lib.geec_ec_recover.restype = ctypes.c_int
    lib.geec_ec_verify.argtypes = [ctypes.c_char_p] * 3
    lib.geec_ec_verify.restype = ctypes.c_int
    lib.geec_ec_sign.argtypes = [ctypes.c_char_p] * 3
    lib.geec_ec_sign.restype = ctypes.c_int
    lib.geec_ec_pubkey.argtypes = [ctypes.c_char_p] * 2
    lib.geec_ec_pubkey.restype = ctypes.c_int
    lib.geec_ec_recover_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_char_p]
    try:  # variable-length keccak batch; absent in old builds
        lib.geec_keccak256_multi.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_char_p]
    except AttributeError:
        pass
    try:  # election component (native/election.cpp); absent in old builds
        lib.geec_window_check.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_char_p]
        lib.geec_window_check.restype = ctypes.c_int
        lib.geec_elect_winner.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.geec_elect_winner.restype = ctypes.c_int64
    except AttributeError:
        pass
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def keccak256(data: bytes) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(32)
    lib.geec_keccak256(data, len(data), out)
    return out.raw


def keccak256_multi(data: bytes, offsets) -> bytes:
    """``n`` variable-length messages packed back-to-back in ``data``
    (message ``i`` spans ``offsets[i]..offsets[i+1]``; ``offsets`` has
    n+1 entries) -> flat ``n*32`` digest bytes, ONE library call.  The
    columnar ingest decoder's whole-window digest path; raises
    AttributeError on libraries built before the entry existed (callers
    fall back to per-message :func:`keccak256`)."""
    lib = _load()
    n = len(offsets) - 1
    out = ctypes.create_string_buffer(32 * n)
    offs = (ctypes.c_uint64 * (n + 1))(*offsets)
    lib.geec_keccak256_multi(data, offs, n, out)
    return out.raw


def ec_recover(msg_hash: bytes, sig: bytes) -> bytes:
    """65-byte sig -> 64-byte pubkey; raises ValueError on invalid input."""
    lib = _load()
    out = ctypes.create_string_buffer(64)
    rc = lib.geec_ec_recover(msg_hash, sig, out)
    if rc != 0:
        raise ValueError(f"invalid signature (native rc={rc})")
    return out.raw


def ec_verify(msg_hash: bytes, sig_rs: bytes, pub: bytes) -> bool:
    lib = _load()
    return bool(lib.geec_ec_verify(msg_hash, sig_rs[:64], pub))


def ec_sign(msg_hash: bytes, priv: bytes) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(65)
    rc = lib.geec_ec_sign(msg_hash, priv, out)
    if rc != 0:
        raise ValueError(f"sign failed (native rc={rc})")
    return out.raw


def ec_pubkey(priv: bytes) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(64)
    rc = lib.geec_ec_pubkey(priv, out)
    if rc != 0:
        raise ValueError("invalid private key")
    return out.raw


def ec_recover_batch(hashes: bytes, sigs: bytes, n: int) -> tuple[bytes, bytes]:
    """Flat n*32 hashes + n*65 sigs -> (n*64 pubs, n ok-bytes)."""
    lib = _load()
    pubs = ctypes.create_string_buffer(64 * n)
    ok = ctypes.create_string_buffer(n)
    lib.geec_ec_recover_batch(hashes, sigs, n, pubs, ok)
    return pubs.raw, ok.raw


def window_check(flat_sorted_addrs: bytes, size: int, start: int, n: int,
                 addr: bytes) -> bool:
    """Native committee/acceptor window membership (election.cpp)."""
    lib = _load()
    return bool(lib.geec_window_check(flat_sorted_addrs, size, start, n,
                                      addr))


def elect_winner(records: bytes, m: int) -> int:
    """Winner index among ``m`` 28-byte (addr20 || rand8be) records."""
    lib = _load()
    return int(lib.geec_elect_winner(records, m))


def has_election() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "geec_window_check")


def self_check() -> None:
    """Cross-check native vs the Python golden model."""
    from eges_tpu_torch.crypto import keccak as pk
    from eges_tpu_torch.crypto import secp256k1 as ps

    assert keccak256(b"") == pk.keccak256_py(b"")
    assert keccak256(b"abc" * 100) == pk.keccak256_py(b"abc" * 100)
    priv = bytes(range(1, 33))
    msg = pk.keccak256_py(b"native self check")
    assert ec_pubkey(priv) == ps.privkey_to_pubkey_py(priv)
    sig = ec_sign(msg, priv)
    assert sig == ps.ecdsa_sign_py(msg, priv), "sign mismatch vs golden model"
    assert ec_recover(msg, sig) == ps.ecdsa_recover_py(msg, sig)
    assert ec_verify(msg, sig[:64], ps.privkey_to_pubkey_py(priv))
