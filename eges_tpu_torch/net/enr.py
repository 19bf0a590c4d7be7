"""Signed node records (the p2p/enr role, EIP-778 shaped).

The port's copy of ``eges_tpu/net/enr.py``, unchanged but for its
imports; the records are byte-equal to the reference's for the same key
and seq.

The reference carries node identity + endpoint claims as Ethereum Node
Records (ref: p2p/enr/enr.go — RLP ``[sig, seq, k, v, ...]`` with
strictly sorted keys, a sequence number bumped on every change, and a
secp256k1 signature over the content).  This is the same design with
two deliberate divergences, both documented here:

- the signature is the 65-byte *recoverable* form our whole stack uses
  (ref uses 64-byte compact + a mandatory ``secp256k1`` pair to carry
  the pubkey; with recovery the identity is derivable from the
  signature itself, so the pubkey pair is optional redundancy), and
- the identity scheme tag is ``gv4`` to mark that difference on the
  wire.

Records ride the discovery plane (net/discovery.py codes 4-6): a node
announces its record, the bootnode keeps the highest-``seq`` copy per
identity, and lookups return full verified records so joiners learn
endpoints from a *signed* statement by the peer itself rather than
from whatever the bootnode claims.

Well-known pairs (all optional except ``id``):
    id     -> b"gv4"           identity scheme (required, checked)
    ip     -> 4-byte IPv4      gossip/consensus address
    tcp    -> uint             gossip (TCP) port
    udp    -> uint             consensus (UDP) port
    cip    -> 4-byte IPv4      consensus address, when != ip
    secp256k1 -> 64-byte pub   optional redundant pubkey (checked
                               against the recovered signer if present)
"""

from __future__ import annotations

import socket
import struct

from eges_tpu_torch.core import rlp
from eges_tpu_torch.crypto.keccak import keccak256

ID_SCHEME = b"gv4"
MAX_RECORD_SIZE = 300  # ref p2p/enr/enr.go SizeLimit


class ENRError(ValueError):
    pass


def _content(seq: int, pairs: dict[bytes, bytes]) -> list:
    items: list = [seq]
    for k in sorted(pairs):
        items.append(k)
        items.append(pairs[k])
    return items


def ip_to_bytes(ip: str) -> bytes:
    return socket.inet_aton(ip)


def ip_from_bytes(b: bytes) -> str:
    if len(b) != 4:
        raise ENRError("bad ip length")
    return socket.inet_ntoa(b)


class Record:
    """An immutable, signature-verified node record."""

    def __init__(self, seq: int, pairs: dict[bytes, bytes],
                 signature: bytes, signer: bytes):
        self.seq = seq
        self.pairs = dict(pairs)
        self.signature = signature
        self.addr = signer  # 20-byte identity derived from the signature

    # -- construction -----------------------------------------------------

    @classmethod
    def sign(cls, priv: bytes, seq: int, *, ip: str | None = None,
             tcp: int | None = None, udp: int | None = None,
             cip: str | None = None,
             extra: dict[bytes, bytes] | None = None) -> "Record":
        from eges_tpu_torch.crypto import secp256k1 as secp

        pairs: dict[bytes, bytes] = {b"id": ID_SCHEME}
        if ip is not None:
            pairs[b"ip"] = ip_to_bytes(ip)
        if cip is not None and cip != ip:
            pairs[b"cip"] = ip_to_bytes(cip)
        if tcp is not None:
            pairs[b"tcp"] = _uint(tcp)
        if udp is not None:
            pairs[b"udp"] = _uint(udp)
        if extra:
            pairs.update(extra)
        pairs = {k: v for k, v in pairs.items() if v != b""}
        h = keccak256(rlp.encode(_content(seq, pairs)))
        sig = secp.ecdsa_sign(h, priv)
        signer = secp.pubkey_to_address(secp.privkey_to_pubkey(priv))
        rec = cls(seq, pairs, sig, signer)
        if len(rec.encode()) > MAX_RECORD_SIZE:
            raise ENRError("record exceeds %d bytes" % MAX_RECORD_SIZE)
        return rec

    def encode(self) -> bytes:
        return rlp.encode([self.signature] + _content(self.seq, self.pairs))

    @classmethod
    def decode(cls, data: bytes) -> "Record":
        from eges_tpu_torch.crypto import secp256k1 as secp

        if len(data) > MAX_RECORD_SIZE:
            raise ENRError("oversize record")
        try:
            items = rlp.decode(data)
        except Exception as e:
            raise ENRError("bad rlp: %s" % e) from None
        if not isinstance(items, list) or len(items) < 2 or len(items) % 2:
            raise ENRError("bad record shape")
        # everything below handles attacker-shaped input: nested lists
        # where byte strings belong, non-canonical ints, wrong-length
        # values — all must surface as ENRError, never TypeError, so
        # every caller's `except ENRError` guard is airtight
        try:
            sig = bytes(items[0])
            seq = rlp.decode_uint(bytes(items[1]))
            pairs: dict[bytes, bytes] = {}
            prev = None
            for i in range(2, len(items), 2):
                k = bytes(items[i])
                if prev is not None and k <= prev:
                    raise ENRError("keys not strictly sorted")
                prev = k
                pairs[k] = bytes(items[i + 1])
        except ENRError:
            raise
        except Exception as e:
            raise ENRError("malformed record: %s" % e) from None
        if pairs.get(b"id") != ID_SCHEME:
            raise ENRError("unknown identity scheme")
        for key in (b"ip", b"cip"):
            if key in pairs and len(pairs[key]) != 4:
                raise ENRError("bad %s length" % key.decode())
        for key in (b"tcp", b"udp"):
            if key in pairs and int.from_bytes(pairs[key], "big") > 0xFFFF:
                raise ENRError("bad %s port" % key.decode())
        h = keccak256(rlp.encode(_content(seq, pairs)))
        try:
            signer = secp.recover_address(h, sig)
        except Exception:
            raise ENRError("unrecoverable signature") from None
        if b"secp256k1" in pairs:
            redundant = secp.pubkey_to_address(pairs[b"secp256k1"])
            if redundant != signer:
                raise ENRError("secp256k1 pair does not match signer")
        return cls(seq, pairs, sig, signer)

    # -- accessors --------------------------------------------------------

    def ip(self) -> str | None:
        b = self.pairs.get(b"ip")
        return ip_from_bytes(b) if b else None

    def consensus_ip(self) -> str | None:
        b = self.pairs.get(b"cip")
        return ip_from_bytes(b) if b else self.ip()

    def tcp(self) -> int | None:
        b = self.pairs.get(b"tcp")
        return int.from_bytes(b, "big") if b is not None else None

    def udp(self) -> int | None:
        b = self.pairs.get(b"udp")
        return int.from_bytes(b, "big") if b is not None else None

    def gossip_endpoint(self) -> tuple[str, int] | None:
        ip, port = self.ip(), self.tcp()
        return (ip, port) if ip and port else None

    def consensus_endpoint(self) -> tuple[str, int] | None:
        ip, port = self.consensus_ip(), self.udp()
        return (ip, port) if ip and port else None

    def __eq__(self, other) -> bool:
        return (isinstance(other, Record) and self.seq == other.seq
                and self.pairs == other.pairs
                and self.signature == other.signature)

    def __repr__(self) -> str:
        return "Record(addr=%s seq=%d %s)" % (
            self.addr.hex()[:8], self.seq,
            ",".join(k.decode() for k in sorted(self.pairs)))


_uint = rlp.encode_uint
