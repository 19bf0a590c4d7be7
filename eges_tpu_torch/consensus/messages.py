"""Consensus wire messages — both network planes.

The port's copy of ``eges_tpu/consensus/messages.py``, unchanged but for
its imports.

The reference splits Geec traffic over two planes (SURVEY §2.3):

* **gossip plane** (RLPx/TCP in the reference): ``ValidateReqMsg`` /
  ``QueryMsg`` / ``RegisterReqMsg`` / ``ConfirmBlockMsg``, devp2p codes
  0x11/0x12/0x14/0x15 (ref: eth/protocol.go:67-73), relayed to all peers
  with retry/version dedup gating.
* **direct plane** (raw UDP + RLP): election messages and validate/query
  replies sent point-to-point to ``ip:port`` carried inside the request
  (ref: consensus/geec/election/server.go:70-120,
  core/geec_state.go:584-591), wrapped in ``GeecUDPMsg`` envelopes with
  codes 0x01/0x02/0x03 (ref: core/geecCore/Types.go:59-63).

Every message is a frozen dataclass with RLP to/from, so the same bytes
flow over the in-process simulator, real sockets, and tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from eges_tpu_torch.core import rlp
from eges_tpu_torch.core.types import (
    Block, ConfirmBlockMsg, Header, QueryBlockMsg, Registration,
)
from eges_tpu_torch.crypto.keccak import keccak256

# Direct-plane (UDP envelope) codes (ref: core/geecCore/Types.go:59-63)
UDP_EXAMINE_REPLY = 0x01
UDP_ELECT = 0x02
UDP_QUERY_REPLY = 0x03
UDP_BLOCKS = 0x04      # backfill reply (this build; see BlockFetchReq)
UDP_GET_BLOCKS = 0x05  # peer-directed backfill request (sync protocol)
UDP_GET_HEADERS = 0x06  # header-first skeleton request (same req shape)
UDP_HEADERS = 0x07      # header+cert reply (see HeadersReply)
UDP_GET_STATE = 0x08    # fast-sync state page request (StateFetchReq)
UDP_STATE = 0x09        # fast-sync state page reply (StateChunkReply)

# Election sub-codes (ref: consensus/geec/election/election_go.go:15-18)
MSG_ELECT = 0x01
MSG_VOTE = 0x02

# Gossip-plane codes (ref: eth/protocol.go:67-73)
GOSSIP_VALIDATE_REQ = 0x11
GOSSIP_QUERY = 0x12
GOSSIP_REGISTER_REQ = 0x14
GOSSIP_CONFIRM_BLOCK = 0x15
GOSSIP_GET_BLOCKS = 0x16  # backfill request (broadcast fallback of the
#                           sync protocol; cf. the reference's downloader
#                           body sync, eth/downloader/queue.go:65-67)
GOSSIP_BLOCKS_REPLY = 0x18  # bulk backfill reply over TCP — block
#   batches exceed a UDP datagram at the 1000-txn operating point, so
#   sync replies ride the reliable plane (the reference ships blocks
#   over devp2p TCP too, eth/handler.go:562-590 body exchange)
GOSSIP_TXNS = 0x17  # transaction gossip (ref: TxMsg, eth/protocol.go:38 +
#                     eth/handler.go:742-759 -> TxPool.AddRemotes)
GOSSIP_GET_HEADERS = 0x19  # header-first skeleton request (broadcast
#                            fallback, cf. GetBlockHeadersMsg
#                            eth/protocol.go:67)
GOSSIP_HEADERS_REPLY = 0x1A  # header+cert batches over TCP
GOSSIP_GET_STATE = 0x1B      # fast-sync state request, broadcast fallback
GOSSIP_STATE_REPLY = 0x1C    # fast-sync state page over TCP (big chunks)


@dataclass(frozen=True)
class ElectMessage:
    """Election announce / vote (ref: election/election_go.go electMessage).

    ``code`` MSG_ELECT announces candidacy with ``rand``; MSG_VOTE carries a
    vote for ``author`` (on transfer, ``author`` stays the ORIGINAL voter —
    the vote-transfer semantics of election_go.go:276-310).

    ``sig`` signs :meth:`signing_hash` — the stable election content
    (code, height, author, rand, version) but NOT transport details
    (ip/port/retry), so retries and vote transfer keep the original
    signature valid."""

    code: int
    block_num: int
    author: bytes
    rand: int = 0
    version: int = 0
    retry: int = 0
    ip: str = ""
    port: int = 0
    sig: bytes = b""

    def to_rlp(self) -> list:
        return [self.code, self.block_num, self.author, self.rand,
                self.version, self.retry, self.ip.encode(), self.port,
                self.sig]

    @classmethod
    def from_rlp(cls, item: list) -> "ElectMessage":
        code, blk, author, rand, version, retry, ip, port = item[:8]
        return cls(code=rlp.decode_uint(code), block_num=rlp.decode_uint(blk),
                   author=bytes(author), rand=rlp.decode_uint(rand),
                   version=rlp.decode_uint(version),
                   retry=rlp.decode_uint(retry), ip=ip.decode(),
                   port=rlp.decode_uint(port),
                   sig=bytes(item[8]) if len(item) > 8 else b"")

    def signing_hash(self) -> bytes:
        return keccak256(b"geec/elect" + rlp.encode(
            [self.code, self.block_num, self.author, self.rand,
             self.version]))


@dataclass(frozen=True)
class ValidateRequest:
    """Proposer -> everyone: please ACK this block
    (ref: core/geecCore/Types.go:20-30).  Carries the full block plus the
    proposer's direct-plane return address and the empty-block numbers the
    proposer wants backfilled (``empty_list``)."""

    block_num: int
    author: bytes
    block: Block
    ip: str
    port: int
    retry: int = 0
    version: int = 0
    empty_list: tuple[int, ...] = ()
    sig: bytes = b""  # proposer's signature over signing_hash()

    def to_rlp(self) -> list:
        return [self.block_num, self.author, self.block.to_rlp(),
                self.ip.encode(), self.port, self.retry, self.version,
                list(self.empty_list), self.sig]

    @classmethod
    def from_rlp(cls, item: list) -> "ValidateRequest":
        blk_num, author, block, ip, port, retry, version, empties = item[:8]
        return cls(block_num=rlp.decode_uint(blk_num), author=bytes(author),
                   block=Block.from_rlp(block), ip=ip.decode(),
                   port=rlp.decode_uint(port), retry=rlp.decode_uint(retry),
                   version=rlp.decode_uint(version),
                   empty_list=tuple(rlp.decode_uint(e) for e in empties),
                   sig=bytes(item[8]) if len(item) > 8 else b"")

    def signing_hash(self) -> bytes:
        """Binds proposer, height, version and the exact proposed block
        (by hash) — retry and transport fields excluded so rebroadcasts
        reuse one signature."""
        return keccak256(b"geec/validate-req" + rlp.encode(
            [self.block_num, self.author, self.block.hash, self.version]))


@dataclass(frozen=True)
class ValidateReply:
    """Acceptor -> proposer ACK, direct plane
    (ref: core/geecCore/Types.go:32-38).  ``fill_blocks`` backfills the
    empty blocks the request asked for (geec_state.go:555-564)."""

    block_num: int
    author: bytes
    accepted: bool = True
    retry: int = 0
    fill_blocks: tuple[Block, ...] = ()
    block_hash: bytes = bytes(32)  # the exact proposal being ACKed
    sig: bytes = b""               # acceptor's signature over signing_hash()

    def to_rlp(self) -> list:
        return [self.block_num, self.author, int(self.accepted), self.retry,
                [b.to_rlp() for b in self.fill_blocks], self.block_hash,
                self.sig]

    @classmethod
    def from_rlp(cls, item: list) -> "ValidateReply":
        blk, author, acc, retry, fills = item[:5]
        return cls(block_num=rlp.decode_uint(blk), author=bytes(author),
                   accepted=bool(rlp.decode_uint(acc)),
                   retry=rlp.decode_uint(retry),
                   fill_blocks=tuple(Block.from_rlp(b) for b in fills),
                   block_hash=bytes(item[5]) if len(item) > 5 else bytes(32),
                   sig=bytes(item[6]) if len(item) > 6 else b"")

    def signing_hash(self) -> bytes:
        """An ACK binds (height, acceptor, verdict, block hash): a vote
        for proposal X must never count for proposal Y."""
        return keccak256(b"geec/ack" + rlp.encode(
            [self.block_num, self.author, int(self.accepted),
             self.block_hash]))


@dataclass(frozen=True)
class QueryReply:
    """Acceptor -> querier, direct plane (ref: core/geecCore/Types.go:42-49).
    ``empty=True`` means "I have no pending block at that height"."""

    block_num: int
    author: bytes
    version: int
    retry: int = 0
    empty: bool = True
    block_hash: bytes = bytes(32)
    sig: bytes = b""  # acceptor's signature over signing_hash()

    def to_rlp(self) -> list:
        return [self.block_num, self.author, self.version, self.retry,
                int(self.empty), self.block_hash, self.sig]

    @classmethod
    def from_rlp(cls, item: list) -> "QueryReply":
        blk, author, version, retry, empty, h = item[:6]
        return cls(block_num=rlp.decode_uint(blk), author=bytes(author),
                   version=rlp.decode_uint(version),
                   retry=rlp.decode_uint(retry),
                   empty=bool(rlp.decode_uint(empty)), block_hash=bytes(h),
                   sig=bytes(item[6]) if len(item) > 6 else b"")

    def signing_hash(self) -> bytes:
        return keccak256(b"geec/query-reply" + rlp.encode(
            [self.block_num, self.author, self.version, int(self.empty),
             self.block_hash]))


@dataclass(frozen=True)
class BlockFetchReq:
    """Backfill: "send me canonical blocks [start, start+count)".

    A node that learns (via a ConfirmBlockMsg) that the quorum is ahead of
    its head asks peers to stream the gap back on the direct plane.  This
    replaces the reference's downloader sync for the Geec capability path
    (SURVEY §5 checkpoint/resume: "full-sync + downloader backfill
    re-joins after downtime")."""

    start: int
    count: int
    ip: str
    port: int

    def to_rlp(self) -> list:
        return [self.start, self.count, self.ip.encode(), self.port]

    @classmethod
    def from_rlp(cls, item: list) -> "BlockFetchReq":
        start, count, ip, port = item
        return cls(start=rlp.decode_uint(start), count=rlp.decode_uint(count),
                   ip=ip.decode(), port=rlp.decode_uint(port))


@dataclass(frozen=True)
class BlocksReply:
    """Backfill payload: contiguous canonical blocks with their stored
    confirm messages attached."""

    blocks: tuple[Block, ...]

    def to_rlp(self) -> list:
        return [[b.to_rlp() for b in self.blocks]]

    @classmethod
    def from_rlp(cls, item: list) -> "BlocksReply":
        (blocks,) = item
        return cls(blocks=tuple(Block.from_rlp(b) for b in blocks))


@dataclass(frozen=True)
class HeadersReply:
    """Header-first sync payload: ``(header, confirm)`` pairs with no
    bodies (the reference's header skeleton,
    eth/downloader/downloader.go:931, with bodies filled by separate
    lanes, queue.go:65-67).  Quorum certificates ride along so a joiner
    batch-verifies the WHOLE gap's signatures in a few large device
    batches before any body arrives — bodies then only need to hash
    onto the pinned skeleton."""

    headers: tuple  # of (Header, ConfirmBlockMsg | None)

    def to_rlp(self) -> list:
        return [[[h.to_rlp(), [] if c is None else c.to_rlp()]
                 for h, c in self.headers]]

    @classmethod
    def from_rlp(cls, item: list) -> "HeadersReply":
        (pairs,) = item
        return cls(headers=tuple(
            (Header.from_rlp(h),
             ConfirmBlockMsg.from_rlp(c) if c else None)
            for h, c in pairs))


@dataclass(frozen=True)
class TxnsMsg:
    """Transaction gossip payload (ref: TxMsg eth/protocol.go:38)."""

    txns: tuple

    def to_rlp(self) -> list:
        return [[t.to_rlp() for t in self.txns]]

    @classmethod
    def from_rlp(cls, item: list) -> "TxnsMsg":
        from eges_tpu_torch.core.types import Transaction

        (txns,) = item
        return cls(txns=tuple(Transaction.from_rlp(t) for t in txns))


@dataclass(frozen=True)
class StateFetchReq:
    """Fast-sync state request (ref role: eth/downloader/statesync.go:1
    state download; GetNodeDataMsg in eth/protocol.go — redesigned at
    ACCOUNT granularity instead of trie-node granularity, since this
    build's snapshots are in-memory account maps, not a node database).

    ``block_num = 0`` lets the SERVER choose the pivot (its head minus a
    stability lag) — the first reply pins it and the joiner keeps asking
    for that block.  ``cursor`` indexes into the pivot snapshot's
    address-sorted account list."""

    block_num: int
    cursor: int
    ip: str
    port: int

    def to_rlp(self) -> list:
        return [self.block_num, self.cursor, self.ip.encode(), self.port]

    @classmethod
    def from_rlp(cls, item: list) -> "StateFetchReq":
        blk, cur, ip, port = item
        return cls(block_num=rlp.decode_uint(blk),
                   cursor=rlp.decode_uint(cur), ip=ip.decode(),
                   port=rlp.decode_uint(port))


@dataclass(frozen=True)
class StateChunkReply:
    """One page of the pivot state snapshot.

    ``accounts`` is a tuple of
    ``(addr, nonce, balance, code_hash, ((hashed_slot, value_rlp)…))``
    in address-sorted order starting at ``cursor``; ``codes`` carries the
    bytecode blobs for any code hashes first referenced in this page.
    Nothing in a reply is trusted: the joiner rebuilds the account and
    storage tries and verifies the final root against a
    quorum-CERTIFIED pivot header before adopting anything."""

    block_num: int
    root: bytes
    cursor: int
    total: int
    accounts: tuple
    codes: tuple

    def to_rlp(self) -> list:
        return [self.block_num, self.root, self.cursor, self.total,
                [[a, n, b, ch, [[k, v] for k, v in slots]]
                 for a, n, b, ch, slots in self.accounts],
                list(self.codes)]

    @classmethod
    def from_rlp(cls, item: list) -> "StateChunkReply":
        blk, root, cur, total, accounts, codes = item
        return cls(
            block_num=rlp.decode_uint(blk), root=bytes(root),
            cursor=rlp.decode_uint(cur), total=rlp.decode_uint(total),
            accounts=tuple(
                (bytes(a), rlp.decode_uint(n), rlp.decode_uint(b),
                 bytes(ch), tuple((bytes(k), bytes(v)) for k, v in slots))
                for a, n, b, ch, slots in accounts),
            codes=tuple(bytes(c) for c in codes))


@dataclass(frozen=True)
class UdpEnvelope:
    """Direct-plane envelope (ref: core/geecCore/Types.go:68-72)."""

    code: int
    author: bytes
    payload: bytes

    def encode(self) -> bytes:
        return rlp.encode([self.code, self.author, self.payload])

    @classmethod
    def decode(cls, data: bytes) -> "UdpEnvelope":
        code, author, payload = rlp.decode(data)
        return cls(code=rlp.decode_uint(code), author=bytes(author),
                   payload=bytes(payload))


_DIRECT_BODY = {
    UDP_EXAMINE_REPLY: ValidateReply,
    UDP_ELECT: ElectMessage,
    UDP_QUERY_REPLY: QueryReply,
    UDP_BLOCKS: BlocksReply,
    UDP_GET_BLOCKS: BlockFetchReq,
    UDP_GET_HEADERS: BlockFetchReq,
    UDP_HEADERS: HeadersReply,
    UDP_GET_STATE: StateFetchReq,
    UDP_STATE: StateChunkReply,
}


def pack_direct(code: int, author: bytes, msg) -> bytes:
    return UdpEnvelope(code=code, author=author,
                       payload=rlp.encode(msg.to_rlp())).encode()


def unpack_direct(data: bytes):
    """-> (code, author, message object)"""
    env = UdpEnvelope.decode(data)
    body = _DIRECT_BODY[env.code].from_rlp(rlp.decode(env.payload))
    return env.code, env.author, body


_GOSSIP_BODY = {
    GOSSIP_VALIDATE_REQ: ValidateRequest,
    GOSSIP_QUERY: QueryBlockMsg,
    GOSSIP_REGISTER_REQ: Registration,
    GOSSIP_CONFIRM_BLOCK: ConfirmBlockMsg,
    GOSSIP_GET_BLOCKS: BlockFetchReq,
    GOSSIP_BLOCKS_REPLY: BlocksReply,
    GOSSIP_TXNS: TxnsMsg,
    GOSSIP_GET_HEADERS: BlockFetchReq,
    GOSSIP_HEADERS_REPLY: HeadersReply,
    GOSSIP_GET_STATE: StateFetchReq,
    GOSSIP_STATE_REPLY: StateChunkReply,
}


def pack_gossip(code: int, msg) -> bytes:
    return rlp.encode([code, msg.to_rlp()])


def unpack_gossip(data: bytes):
    """-> (code, message object)"""
    code, body = rlp.decode(data)
    code = rlp.decode_uint(code)
    return code, _GOSSIP_BODY[code].from_rlp(body)
