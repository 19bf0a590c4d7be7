"""Chain data model: blocks, headers, transactions, Geec wire types.

The port's copy of ``eges_tpu/core/types.py``: sender recovery goes to the
port's host model or the port's verifier.

Capability-parity port of the reference's ``core/types`` layer with the
Geec fork's extensions:

* Header carries ``regs`` (membership registrations confirmed by this
  block) and ``trust_rand`` (the committee seed for the *next* block)
  (ref: core/types/block.go:87-89).
* Block carries ``geec_txns`` / ``fake_txns`` / ``confirm`` outside the
  transaction root (ref: core/types/block.go:154-159, extblock 187-194 —
  note they are deliberately NOT under ``TxHash``; the validator only
  roots ``transactions``, core/block_validator.go:72).
* Transaction has the ``is_geec`` marker (ref: core/types/transaction.go:66)
  and EIP155/Homestead signing with cached sender
  (ref: core/types/transaction_signing.go:72-88).
* Geec wire records ``Registration`` / ``ConfirmBlockMsg`` /
  ``QueryBlockMsg`` and the sentinel addresses
  (ref: core/types/geec.go:13-44; the reference misspells
  "Registratoin" — the name, not the semantics, is fixed here).

Sender recovery delegates to the batched TPU verifier when one is
installed (see :mod:`eges_tpu_torch.crypto.verifier`); single host-side
recovery is the fallback, mirroring the reference's cgo-vs-nocgo split
(crypto/signature_cgo.go vs signature_nocgo.go).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from eges_tpu_torch.core import rlp
from eges_tpu_torch.core.trie import derive_sha, EMPTY_ROOT
from eges_tpu_torch.crypto import secp256k1 as _secp
from eges_tpu_torch.crypto.keccak import keccak256

# Sentinels (ref: core/types/geec.go:13-16)
REG_ADDR = bytes([0xFF] * 20)
EMPTY_ADDR = bytes([0xFF, 0x00] * 10)
FAKE_SIGNATURE = bytes([0x00, 0x01, 0x02, 0x03, 0x04])

EMPTY_UNCLE_HASH = keccak256(rlp.encode([]))
ZERO_HASH = bytes(32)
ZERO_ADDR = bytes(20)


def _addr(b: bytes) -> bytes:
    if len(b) != 20:
        raise ValueError("address must be 20 bytes")
    return bytes(b)


@dataclass(frozen=True)
class Registration:
    """Membership join request (ref: core/types/geec.go:19-28)."""

    account: bytes
    referee: bytes = ZERO_ADDR
    ip: str = ""
    port: str = ""
    signature: bytes = FAKE_SIGNATURE
    renew: int = 0

    def to_rlp(self) -> list:
        return [self.account, self.referee, self.ip.encode(), self.port.encode(),
                self.signature, self.renew]

    @classmethod
    def from_rlp(cls, item: list) -> "Registration":
        acc, ref, ip, port, sig, renew = item
        return cls(_addr(acc), _addr(ref), ip.decode(), port.decode(),
                   bytes(sig), rlp.decode_uint(renew))


@dataclass(frozen=True)
class ConfirmBlockMsg:
    """Leader's confirmation broadcast (ref: core/types/geec.go:30-36).

    This build's upgrade over the reference's trustedHW assumption: in
    signed-vote mode the confirm is a **quorum certificate** — beside the
    proposer's own ``sig``, ``supporter_sigs[i]`` is ``supporters[i]``'s
    signature over its ACK (``version == 0``) or query reply
    (``version > 0``, the timeout-recovery path), so ANY receiver can
    re-verify the whole quorum as one device batch without trusting the
    proposer.  All three extra fields are empty in unsigned deployments."""

    block_number: int
    hash: bytes
    confidence: int
    supporters: tuple[bytes, ...] = ()
    empty_block: bool = False
    sig: bytes = b""
    version: int = 0
    supporter_sigs: tuple[bytes, ...] = ()

    def to_rlp(self) -> list:
        return [self.block_number, self.hash, self.confidence,
                list(self.supporters), int(self.empty_block), self.sig,
                self.version, list(self.supporter_sigs)]

    @classmethod
    def from_rlp(cls, item: list) -> "ConfirmBlockMsg":
        # tolerate the shorter pre-signature wire forms (old stored blocks)
        num, h, conf, sup, empty = item[:5]
        return cls(rlp.decode_uint(num), bytes(h), rlp.decode_uint(conf),
                   tuple(_addr(a) for a in sup), bool(rlp.decode_uint(empty)),
                   sig=bytes(item[5]) if len(item) > 5 else b"",
                   version=rlp.decode_uint(item[6]) if len(item) > 6 else 0,
                   supporter_sigs=tuple(bytes(s) for s in item[7])
                   if len(item) > 7 else ())

    def signing_hash(self) -> bytes:
        return keccak256(b"geec/confirm" + rlp.encode(
            self.to_rlp()[:5] + [self.version]))


@dataclass(frozen=True)
class QueryBlockMsg:
    """Timeout-recovery block query (ref: core/types/geec.go:38-44)."""

    block_number: int
    version: int
    ip: str
    retry: int
    port: int

    def to_rlp(self) -> list:
        return [self.block_number, self.version, self.ip.encode(), self.retry, self.port]

    @classmethod
    def from_rlp(cls, item: list) -> "QueryBlockMsg":
        num, ver, ip, retry, port = item
        return cls(rlp.decode_uint(num), rlp.decode_uint(ver), ip.decode(),
                   rlp.decode_uint(retry), rlp.decode_uint(port))


@dataclass(frozen=True)
class Transaction:
    """A transaction; Geec txns are unsigned UDP-ingested payload carriers
    flagged ``is_geec`` (ref: core/types/transaction.go:52-80)."""

    nonce: int = 0
    gas_price: int = 0
    gas_limit: int = 0
    to: bytes | None = None  # None = contract creation
    value: int = 0
    payload: bytes = b""
    is_geec: bool = False
    v: int = 0
    r: int = 0
    s: int = 0

    _SENDER_CACHE: dict = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_SENDER_CACHE", {})

    def to_rlp(self) -> list:
        to = self.to if self.to is not None else b""
        return [self.nonce, self.gas_price, self.gas_limit, to, self.value,
                self.payload, int(self.is_geec), self.v, self.r, self.s]

    @classmethod
    def from_rlp(cls, item: list) -> "Transaction":
        nonce, price, gas, to, value, payload, is_geec, v, r, s = item
        # r/s must fit 256 bits and v 64 bits, like geth's typed decode
        # into uint256/uint64 fields — a wire blob can't smuggle wider
        # ints into the verify paths.
        if len(r) > 32 or len(s) > 32:
            raise rlp.RLPError("signature scalar wider than 256 bits")
        if len(v) > 8:
            raise rlp.RLPError("v wider than 64 bits")
        return cls(
            nonce=rlp.decode_uint(nonce), gas_price=rlp.decode_uint(price),
            gas_limit=rlp.decode_uint(gas), to=_addr(to) if to else None,
            value=rlp.decode_uint(value), payload=bytes(payload),
            is_geec=bool(rlp.decode_uint(is_geec)), v=rlp.decode_uint(v),
            r=rlp.decode_uint(r), s=rlp.decode_uint(s),
        )

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())

    @classmethod
    def decode(cls, data: bytes) -> "Transaction":
        return cls.from_rlp(rlp.decode(data))

    @property
    def hash(self) -> bytes:
        # memoized: admission touches the hash several times per row
        # (dedup keys, ledger billing, trace tags) and each recompute
        # is a full RLP re-encode + keccak.  The instance is frozen, so
        # the cached digest can never go stale; the columnar ingest
        # decoder seeds it straight from the wire frame's keccak
        # (keccak256(frame) == keccak256(encode()) because RLP is
        # strictly canonical) so window rows never re-encode at all.
        h = self._SENDER_CACHE.get("hash")
        if h is None:
            h = keccak256(self.encode())
            self._SENDER_CACHE["hash"] = h
        return h

    # -- signing ----------------------------------------------------------

    def sighash(self, chain_id: int | None = None) -> bytes:
        """EIP155 (chain_id) or Homestead (None) signing hash
        (ref: core/types/transaction_signing.go:146,207)."""
        to = self.to if self.to is not None else b""
        fields = [self.nonce, self.gas_price, self.gas_limit, to, self.value,
                  self.payload]
        if chain_id is not None:
            fields += [chain_id, 0, 0]
        return keccak256(rlp.encode(fields))

    @property
    def protected(self) -> bool:
        return self.v not in (27, 28) and self.v != 0

    @property
    def chain_id(self) -> int | None:
        if not self.protected:
            return None
        if self.v < 35:
            raise ValueError("invalid protected v (29..34 unassigned)")
        return (self.v - 35) // 2

    def signed(self, priv: bytes, chain_id: int | None = None) -> "Transaction":
        sig = _secp.ecdsa_sign(self.sighash(chain_id), priv)
        r = int.from_bytes(sig[0:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        recid = sig[64]
        v = recid + 27 if chain_id is None else recid + 35 + 2 * chain_id
        return dataclasses.replace(self, v=v, r=r, s=s)

    def signature_parts(self) -> tuple[bytes, bytes] | None:
        """(65-byte wire sig, 32-byte sighash) for the batch verifier, or
        ``None`` if the v/r/s values cannot form a wire signature (the
        batch contract is mask-don't-raise; a malformed remote txn must
        not take down a verify path)."""
        try:
            cid = self.chain_id
        except ValueError:
            return None
        recid = self.v - 27 if cid is None else self.v - 35 - 2 * cid
        if not (0 <= recid <= 3 and 0 < self.r < (1 << 256)
                and 0 < self.s < (1 << 256)):
            return None
        sig = (self.r.to_bytes(32, "big") + self.s.to_bytes(32, "big")
               + bytes([recid]))
        return sig, self.sighash(cid)

    def sender(self) -> bytes:
        """Host-side single recovery with per-tx cache
        (ref: transaction_signing.go:72-88).  Batch paths should use
        ``signature_parts`` + the TPU verifier instead."""
        if self.is_geec or (self.v == 0 and self.r == 0 and self.s == 0):
            return EMPTY_ADDR
        cached = self._SENDER_CACHE.get("from")
        if cached is not None:
            return cached
        parts = self.signature_parts()
        if parts is None:
            raise ValueError("invalid transaction v, r, s values")
        sig, h = parts
        addr = _secp.recover_address(h, sig)
        self._SENDER_CACHE["from"] = addr
        return addr


def geec_txn(payload: bytes) -> Transaction:
    """An unsigned Geec transaction as built from a UDP datagram
    (ref: consensus/geec/geec_api.go:28-41)."""
    return Transaction(to=REG_ADDR, payload=payload, is_geec=True)


def fake_txn(size: int, seq: int = 0) -> Transaction:
    """Throughput-test padding txn (ref: consensus/geec/geec.go:333-339)."""
    body = seq.to_bytes(8, "big")
    return Transaction(to=EMPTY_ADDR, payload=(body * (size // 8 + 1))[:size],
                       is_geec=True)


@dataclass(frozen=True)
class Header:
    """Block header with Geec extensions (ref: core/types/block.go:71-90)."""

    parent_hash: bytes = ZERO_HASH
    uncle_hash: bytes = EMPTY_UNCLE_HASH
    coinbase: bytes = ZERO_ADDR
    root: bytes = EMPTY_ROOT  # empty-state root (L3 checks it on insert)
    tx_hash: bytes = EMPTY_ROOT
    receipt_hash: bytes = EMPTY_ROOT
    bloom: bytes = bytes(256)
    difficulty: int = 1
    number: int = 0
    gas_limit: int = 0
    gas_used: int = 0
    time: int = 0
    extra: bytes = b""
    mix_digest: bytes = ZERO_HASH
    nonce: bytes = bytes(8)
    regs: tuple[Registration, ...] = ()
    trust_rand: int = 0

    def to_rlp(self) -> list:
        return [self.parent_hash, self.uncle_hash, self.coinbase, self.root,
                self.tx_hash, self.receipt_hash, self.bloom, self.difficulty,
                self.number, self.gas_limit, self.gas_used, self.time,
                self.extra, self.mix_digest, self.nonce,
                [r.to_rlp() for r in self.regs], self.trust_rand]

    @classmethod
    def from_rlp(cls, item: list) -> "Header":
        (parent, uncle, coin, root, txh, rch, bloom, diff, num, gl, gu, tm,
         extra, mix, nonce, regs, trand) = item
        return cls(
            parent_hash=bytes(parent), uncle_hash=bytes(uncle),
            coinbase=_addr(coin), root=bytes(root), tx_hash=bytes(txh),
            receipt_hash=bytes(rch), bloom=bytes(bloom),
            difficulty=rlp.decode_uint(diff), number=rlp.decode_uint(num),
            gas_limit=rlp.decode_uint(gl), gas_used=rlp.decode_uint(gu),
            time=rlp.decode_uint(tm), extra=bytes(extra),
            mix_digest=bytes(mix), nonce=bytes(nonce),
            regs=tuple(Registration.from_rlp(r) for r in regs),
            trust_rand=rlp.decode_uint(trand),
        )

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())

    @property
    def hash(self) -> bytes:
        """keccak256 of the RLP header (ref: core/types/block.go:105)."""
        return keccak256(self.encode())


@dataclass(frozen=True)
class Block:
    """Block = header + txs + Geec bodies (ref: core/types/block.go:146-159).

    ``geec_txns``/``fake_txns``/``confirm`` ride beside the rooted
    transaction list, exactly like the reference's extblock wire encoding
    (block.go:187-194) and ``WithGeecBody`` DB read path
    (core/database_util.go:243, block.go:383-403).
    """

    header: Header
    transactions: tuple[Transaction, ...] = ()
    uncles: tuple[Header, ...] = ()
    geec_txns: tuple[Transaction, ...] = ()
    fake_txns: tuple[Transaction, ...] = ()
    confirm: ConfirmBlockMsg | None = None

    @property
    def number(self) -> int:
        return self.header.number

    @property
    def hash(self) -> bytes:
        return self.header.hash

    def to_rlp(self) -> list:
        # extblock order: Header, FakeTxs, GeecTxs, Txs, Uncles, Confirm
        return [
            self.header.to_rlp(),
            [t.to_rlp() for t in self.fake_txns],
            [t.to_rlp() for t in self.geec_txns],
            [t.to_rlp() for t in self.transactions],
            [u.to_rlp() for u in self.uncles],
            [] if self.confirm is None else self.confirm.to_rlp(),
        ]

    @classmethod
    def from_rlp(cls, item: list) -> "Block":
        header, fakes, geecs, txs, uncles, confirm = item
        return cls(
            header=Header.from_rlp(header),
            transactions=tuple(Transaction.from_rlp(t) for t in txs),
            uncles=tuple(Header.from_rlp(u) for u in uncles),
            geec_txns=tuple(Transaction.from_rlp(t) for t in geecs),
            fake_txns=tuple(Transaction.from_rlp(t) for t in fakes),
            confirm=ConfirmBlockMsg.from_rlp(confirm) if confirm else None,
        )

    def encode(self) -> bytes:
        return rlp.encode(self.to_rlp())

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        return cls.from_rlp(rlp.decode(data))

    def with_confirm(self, confirm: ConfirmBlockMsg) -> "Block":
        return dataclasses.replace(self, confirm=confirm)


def new_block(header: Header, txs=(), uncles=(), geec_txns=(), fake_txns=(),
              confirm=None) -> Block:
    """Assemble a block, deriving the tx root into the header
    (ref: core/types/block.go NewBlock; only ``txs`` is rooted)."""
    txs = tuple(txs)
    header = dataclasses.replace(
        header,
        tx_hash=derive_sha([t.encode() for t in txs]) if txs else EMPTY_ROOT,
        uncle_hash=keccak256(rlp.encode([u.to_rlp() for u in uncles])),
    )
    return Block(header=header, transactions=txs, uncles=tuple(uncles),
                 geec_txns=tuple(geec_txns), fake_txns=tuple(fake_txns),
                 confirm=confirm)
