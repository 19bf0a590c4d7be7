"""Canonical chain management.

The port's copy of ``eges_tpu/core/chain.py``: block bodies are recovered
through the port's ``crypto/verify_host.py`` and verifier.

Covers the reference's L4 for the Geec capability set: ordered insertion
with header verification, body validation, batched sender recovery, a
durable block store, and the new-block notification hook that drives the
consensus state machine (ref: core/blockchain.go:1096 InsertChain,
:526-527 insert -> GeecState.NotifyNewBlock).

Deliberate TPU-first redesign (SURVEY §7.5): the reference funnels all
blocks through the fetcher queue then verifies/recovers senders one tx at
a time via cgo (core/state_processor.go:93).  Here insertion is a single
ordered funnel too (``offer`` buffers out-of-order arrivals), but sender
recovery for an entire block is ONE device batch via
:class:`~eges_tpu_torch.crypto.verifier.BatchVerifier`, and verification of
header links is host-side (they are near-no-ops in Geec,
consensus/geec/geec.go:186-210).
"""

from __future__ import annotations

import os
import struct
import threading
from dataclasses import dataclass

from eges_tpu_torch.core import rlp
from eges_tpu_torch.core.types import (
    Block, Header, new_block, EMPTY_ADDR, ZERO_HASH,
)


class ChainError(Exception):
    pass


class MemoryStore:
    """In-memory block store (the reference's ethdb.MemDatabase role,
    ethdb/memory_database.go — used by all unit tests)."""

    def __init__(self):
        self._by_hash: dict[bytes, bytes] = {}
        self._hash_by_number: dict[int, bytes] = {}
        self._head: bytes | None = None
        # durable-lookup roles (ref: core/database_util.go
        # WriteReceipts + WriteTxLookupEntries): receipts by block hash,
        # txn hash -> block number — never pruned, unlike the chain's
        # in-memory state window
        self._receipts: dict[bytes, list[bytes]] = {}
        self._tx_loc: dict[bytes, int] = {}

    def put_block(self, block: Block) -> None:
        raw = block.encode()
        h = block.hash
        self._by_hash[h] = raw
        self._hash_by_number[block.number] = h

    def get_block(self, h: bytes) -> Block | None:
        raw = self._by_hash.get(h)
        return Block.decode(raw) if raw is not None else None

    def get_hash_by_number(self, n: int) -> bytes | None:
        return self._hash_by_number.get(n)

    def set_head(self, h: bytes) -> None:
        self._head = h

    def get_head(self) -> bytes | None:
        return self._head

    def put_receipts(self, block_hash: bytes, encoded: list[bytes],
                     tx_locs) -> None:
        self._receipts[block_hash] = list(encoded)
        for th, n in tx_locs:
            self._tx_loc[th] = n

    def get_receipts(self, block_hash: bytes) -> list[bytes] | None:
        return self._receipts.get(block_hash)

    def put_snapshot(self, payload: bytes) -> None:
        """Durable fast-sync state snapshot (one, latest wins) — what a
        fast-synced node restarts from in place of the ancestors it
        never downloaded (statesync sidecar; see core/statesync.py)."""
        self._snapshot = payload

    def get_snapshot(self) -> bytes | None:
        return getattr(self, "_snapshot", None)

    def tx_loc(self, txn_hash: bytes) -> int | None:
        return self._tx_loc.get(txn_hash)

    # -- fast-sync page staging (mid-sync crash resume) ----------------
    # One append-only slot of raw page blobs written as the live sync
    # accepts pages, cleared on adoption/abort.  A node that crashes
    # mid-download restarts, finds consistent staged pages, and resumes
    # the download from the staged cursor instead of from zero.

    def append_sync_page(self, blob: bytes) -> None:
        if not hasattr(self, "_sync_pages"):
            self._sync_pages: list[bytes] = []
        self._sync_pages.append(blob)

    def load_sync_pages(self) -> list[bytes]:
        return list(getattr(self, "_sync_pages", ()))

    def clear_sync_staging(self) -> None:
        self._sync_pages = []

    def close(self) -> None:
        pass


class FileStore(MemoryStore):
    """Append-only log + index — the durable store (the reference's
    LevelDB role, ethdb/database.go, for the write/read-back/restart
    paths Geec actually uses: blocks by hash/number + head tracking,
    core/database_util.go).

    Layout: ``blocks.log`` is a sequence of [u32 len][rlp block] records;
    ``HEAD`` holds the head hash.  Restart replays the log to rebuild the
    in-memory index (crash-safe: a torn tail record is truncated).
    """

    def __init__(self, path: str):
        super().__init__()
        os.makedirs(path, exist_ok=True)
        self._dir = path
        self._log_path = os.path.join(path, "blocks.log")
        self._head_path = os.path.join(path, "HEAD")
        self._replay()
        self._replay_receipts()
        self._log = open(self._log_path, "ab")
        self._rlog = open(os.path.join(path, "receipts.log"), "ab")

    def _replay(self) -> None:
        if not os.path.exists(self._log_path):
            return
        with open(self._log_path, "rb") as f:
            data = f.read()
        pos = 0
        good_end = 0
        while pos + 4 <= len(data):
            (n,) = struct.unpack("<I", data[pos : pos + 4])
            if pos + 4 + n > len(data):
                break  # torn tail
            raw = data[pos + 4 : pos + 4 + n]
            try:
                block = Block.decode(raw)
            except Exception:
                break
            self._by_hash[block.hash] = raw
            self._hash_by_number[block.number] = block.hash
            pos += 4 + n
            good_end = pos
        if good_end != len(data):
            with open(self._log_path, "r+b") as f:
                f.truncate(good_end)
        if os.path.exists(self._head_path):
            with open(self._head_path, "rb") as f:
                h = f.read()
            if h in self._by_hash:
                self._head = h

    def put_block(self, block: Block) -> None:
        if block.hash in self._by_hash:
            return
        raw = block.encode()
        self._log.write(struct.pack("<I", len(raw)) + raw)
        self._log.flush()
        os.fsync(self._log.fileno())
        self._by_hash[block.hash] = raw
        self._hash_by_number[block.number] = block.hash

    def put_snapshot(self, payload: bytes) -> None:
        # atomic tmp+rename: a crash mid-write must leave the previous
        # snapshot (or none), never a torn one
        tmp = os.path.join(self._dir, "snapshot.rlp.tmp")
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, "snapshot.rlp"))

    def get_snapshot(self) -> bytes | None:
        try:
            with open(os.path.join(self._dir, "snapshot.rlp"), "rb") as f:
                return f.read()
        except OSError:
            return None

    def set_head(self, h: bytes) -> None:
        super().set_head(h)
        tmp = self._head_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(h)
        os.replace(tmp, self._head_path)

    def put_receipts(self, block_hash: bytes, encoded: list[bytes],
                     tx_locs) -> None:
        """Durable receipts + txn-lookup entries (the LevelDB
        WriteReceipts/WriteTxLookupEntries role) — an append-only
        sidecar log so historical receipts survive the in-memory state
        window AND restarts.  Non-fsynced: derived data, rebuilt from
        block replay if a tail is torn."""
        if block_hash in self._receipts:
            return
        rec = rlp.encode([block_hash, list(encoded),
                          [[th, n] for th, n in tx_locs]])
        self._rlog.write(struct.pack("<I", len(rec)) + rec)
        self._rlog.flush()
        super().put_receipts(block_hash, encoded, tx_locs)

    def _replay_receipts(self) -> None:
        path = os.path.join(self._dir, "receipts.log")
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        good_end = 0
        while pos + 4 <= len(data):
            (n,) = struct.unpack("<I", data[pos : pos + 4])
            if pos + 4 + n > len(data):
                break  # torn tail
            try:
                bh, encoded, locs = rlp.decode(data[pos + 4 : pos + 4 + n])
            except Exception:
                break
            super().put_receipts(
                bytes(bh), [bytes(e) for e in encoded],
                [(bytes(th), rlp.decode_uint(num)) for th, num in locs])
            pos += 4 + n
            good_end = pos
        if good_end != len(data):
            # truncate the tear (mirror _replay): appends after a torn
            # record would be unreadable forever, and each restart would
            # re-append the whole post-tear suffix unboundedly
            with open(path, "r+b") as f:
                f.truncate(good_end)

    def append_sync_page(self, blob: bytes) -> None:
        """Durable sync-page staging: same [u32 len][blob] framing as
        blocks.log, torn-tail tolerant on load.  Non-fsynced — staging
        is an optimization; a lost tail just re-downloads those pages."""
        super().append_sync_page(blob)
        with open(os.path.join(self._dir, "sync_pages.log"), "ab") as f:
            f.write(struct.pack("<I", len(blob)) + blob)
            f.flush()

    def load_sync_pages(self) -> list[bytes]:
        path = os.path.join(self._dir, "sync_pages.log")
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return []
        out: list[bytes] = []
        pos = 0
        while pos + 4 <= len(data):
            (n,) = struct.unpack("<I", data[pos : pos + 4])
            if pos + 4 + n > len(data):
                break  # torn tail
            out.append(data[pos + 4 : pos + 4 + n])
            pos += 4 + n
        return out

    def clear_sync_staging(self) -> None:
        super().clear_sync_staging()
        try:
            os.remove(os.path.join(self._dir, "sync_pages.log"))
        except OSError:
            pass

    def close(self) -> None:
        self._log.close()
        self._rlog.close()


def make_genesis(extra: bytes = b"geec-genesis", time: int = 0,
                 alloc: dict[bytes, int] | None = None) -> Block:
    """Genesis block; the ``"thw"`` consensus config lives in the genesis
    JSON beside it (ref: core/genesis.go SetupGenesisBlock +
    params/config.go:124).  ``alloc`` (address -> balance) sets the
    genesis state root (ref: GenesisAlloc, core/genesis.go:228)."""
    from eges_tpu_torch.core.state import StateDB
    root = StateDB.from_alloc(alloc or {}).root()
    return new_block(Header(number=0, time=time, extra=extra,
                            parent_hash=ZERO_HASH, trust_rand=0, root=root))


class BlockChain:
    """Ordered canonical chain with an insert funnel.

    All block sources (proposer's own sealed block, confirmed pending
    blocks, synthesized empty blocks, sync backfill) converge here, the
    way every Geec path converges on fetcher.Enqueue -> insertChain in
    the reference (SURVEY §3.3, eth/fetcher/fetcher.go:647-684).  Blocks
    arriving out of order are buffered and inserted once their parent
    lands, preserving the reference's "blocks come in order" invariant
    (core/geec_state.go:962).
    """

    _MAX_CANDIDATES = 4  # buffered blocks per height (distinct hashes)

    # keep a state snapshot for this many recent blocks (older heights
    # are final many times over; restart replays from genesis anyway)
    _STATE_KEEP = 1024

    def __init__(self, store=None, genesis: Block | None = None,
                 verifier=None, listeners=(), alloc=None, engine=None):
        from eges_tpu_torch.core.state import StateDB

        self.store = store if store is not None else MemoryStore()
        self.verifier = verifier
        if engine is None:
            from eges_tpu_torch.core.engine import GeecEngine
            engine = GeecEngine()
        self.engine = engine
        self._listeners = list(listeners)
        self._lock = threading.RLock()
        # out-of-order buffer: up to _MAX_CANDIDATES first-seen distinct
        # blocks per height, so neither "stale block squats the slot" nor
        # "late conflicting offer displaces the good block" can stall the
        # funnel — insertion tries every candidate when the height opens
        self._future: dict[int, list[Block]] = {}
        self.bad_blocks = 0
        # owning GeecNode attaches its event journal (utils/journal.py)
        self.journal = None
        self.last_error: str | None = None
        self.alloc = dict(alloc or {})
        # state snapshots + receipts per canonical block hash (L3)
        self._states: dict[bytes, object] = {}
        self._state_height: dict[bytes, int] = {}
        self._receipts: dict[bytes, tuple] = {}
        # txn-hash -> (block number, index): the LevelDB txn-lookup
        # index role (ref: core/database_util.go WriteTxLookupEntries),
        # pruned in step with the state snapshots
        self._tx_index: dict[bytes, tuple[int, int]] = {}
        self._txs_by_height: dict[int, list[bytes]] = {}
        # sectioned bitsliced log-bloom index (core/bloombits role):
        # getLogs reads 3 index rows per filter value instead of walking
        # every header in range
        from eges_tpu_torch.core.bloomindex import BloomIndex
        self.bloom_index = BloomIndex()

        head_hash = self.store.get_head()
        if head_hash is None:
            self.genesis = genesis if genesis is not None else make_genesis(
                alloc=self.alloc)
            self.store.put_block(self.genesis)
            self.store.set_head(self.genesis.hash)
            self._head = self.genesis
        else:
            self._head = self.store.get_block(head_hash)
            g = self.store.get_block(self.store.get_hash_by_number(0))
            self.genesis = g if g is not None else genesis

        if self.genesis is None:
            raise ChainError("store has a head but no genesis block")
        gstate = StateDB.from_alloc(self.alloc)
        if self.genesis.header.root != gstate.root():
            raise ChainError("genesis state root does not match alloc")
        self._remember_state(self.genesis.hash, 0, gstate, ())
        self.bloom_index.add(0, self.genesis.header.bloom)
        # restart: rebuild state snapshots by replaying the stored chain
        # (the reference replays into StateDB from LevelDB; here states
        # are in-memory and derived, SURVEY §5 checkpoint/resume).  A
        # fast-synced node has no ancestors below its pivot — its replay
        # anchors on the durable snapshot sidecar instead (root-checked
        # against the pivot block it claims to be; see adopt_snapshot).
        start = 1
        snap_err = None
        # O(tail) restart surface read by the owning GeecNode: the
        # root-verified anchor height (0 = full replay) and the
        # checkpoint's consensus soft-state section, if any
        self.snapshot_anchor = 0
        self.snapshot_consensus: dict | None = None
        snap_raw = self.store.get_snapshot()
        if snap_raw is not None:
            from eges_tpu_torch.core import statesync as _ss

            try:
                sh, sstate, scons = _ss.decode_checkpoint(snap_raw)
                sblk = self.store.get_block(sh)
                if (sblk is not None and 0 < sblk.number <= self._head.number
                        and sstate.root() == sblk.header.root):
                    self._remember_state(sblk.hash, sblk.number, sstate, ())
                    self.bloom_index.add(sblk.number, sblk.header.bloom)
                    start = sblk.number + 1
                    self.snapshot_anchor = sblk.number
                    # consensus section only trusted on the verified path
                    self.snapshot_consensus = scons
                else:
                    snap_err = "snapshot does not match its pivot block"
            except Exception as exc:  # corrupt sidecar
                snap_err = f"snapshot sidecar unreadable ({exc!r})"
        for n in range(start, self._head.number + 1):
            blk = self.get_block_by_number(n)
            if blk is None:
                # a fast-synced store has no ancestors below its pivot:
                # with the sidecar invalid there is nothing to replay
                # from — fail LOUDLY with the reason, not an
                # AttributeError mid-init (r5 review finding)
                raise ChainError(
                    f"block {n} missing during restart replay"
                    + (f"; {snap_err}" if snap_err else "")
                    + "; wipe the datadir and resync")
            parent_state = self._states[blk.header.parent_hash]
            state, receipts, _ = self._process(blk, parent_state)
            self._remember_state(blk.hash, n, state, receipts)
            self._index_txns(blk, receipts)
            self.bloom_index.add(n, blk.header.bloom)

    # -- reads ------------------------------------------------------------

    def head(self) -> Block:
        return self._head

    def height(self) -> int:
        return self._head.number

    def get_block_by_number(self, n: int) -> Block | None:
        h = self.store.get_hash_by_number(n)
        return self.store.get_block(h) if h is not None else None

    def get_block(self, h: bytes) -> Block | None:
        return self.store.get_block(h)

    def has_block(self, h: bytes) -> bool:
        return self.store.get_block(h) is not None

    # -- listeners --------------------------------------------------------

    def add_listener(self, fn) -> None:
        """``fn(block)`` fires after each canonical insert — the
        NotifyNewBlock hook (ref: core/blockchain.go:526-527)."""
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    # -- verification -----------------------------------------------------

    def _verify_header(self, header: Header) -> None:
        """Ancestry checks plus the engine's own rules (the
        consensus.Engine seam — ref: consensus/consensus.go:57; Geec's
        check is intentionally minimal, geec.go:186-210)."""
        if header.number != self._head.number + 1:
            raise ChainError(
                f"non-sequential insert: {header.number} onto {self._head.number}")
        if header.parent_hash != self._head.hash:
            raise ChainError("unknown ancestor")
        from eges_tpu_torch.core.engine import EngineError
        try:
            self.engine.verify_header(self, header)
        except EngineError as e:
            raise ChainError(f"engine: {e}")

    def _verify_body(self, block: Block) -> None:
        """Uncle/tx-root checks (ref: core/block_validator.go:51-76;
        Geec/fake txns are outside TxHash by design)."""
        if block.uncles:
            raise ChainError("uncles not allowed")  # geec.go:215-219
        from eges_tpu_torch.core.trie import derive_sha, EMPTY_ROOT
        want = (derive_sha([t.encode() for t in block.transactions])
                if block.transactions else EMPTY_ROOT)
        if block.header.tx_hash != want:
            raise ChainError("transaction root mismatch")

    def _process(self, block: Block, parent_state):
        """Batched sender recovery (the TPU hot path, SURVEY §3.5) +
        transaction application; validates state/receipt/gas commitments
        (ref: core/block_validator.go:82-105 ValidateState)."""
        from eges_tpu_torch.core.state import (
            StateError, process_block, receipts_root, recover_senders,
        )
        try:
            senders = recover_senders(block.transactions, self.verifier)
            state, receipts, gas = process_block(parent_state, block,
                                                 senders, self.verifier)
        except StateError as e:
            raise ChainError(str(e))
        if block.header.root != state.root():
            raise ChainError("state root mismatch")
        if block.header.receipt_hash != receipts_root(receipts):
            raise ChainError("receipt root mismatch")
        if block.header.gas_used != gas:
            raise ChainError("gas used mismatch")
        from eges_tpu_torch.core.state import receipts_bloom
        if block.header.bloom != receipts_bloom(receipts):
            raise ChainError("log bloom mismatch")
        return state, receipts, gas

    def _remember_state(self, block_hash: bytes, height: int, state,
                        receipts) -> None:
        self._states[block_hash] = state
        self._state_height[block_hash] = height
        self._receipts[block_hash] = tuple(receipts)
        if len(self._states) > self._STATE_KEEP + 64:
            # prune relative to the height being remembered, NOT the
            # stored head: during restart replay the head is already at
            # its final height while replay is still early, and pruning
            # by the final head would delete the parent state the next
            # replay iteration needs
            floor = height - self._STATE_KEEP
            for h, n in list(self._state_height.items()):
                if 0 < n < floor:
                    self._states.pop(h, None)
                    self._state_height.pop(h, None)
                    self._receipts.pop(h, None)
            for n in [k for k in self._txs_by_height if 0 < k < floor]:
                for th in self._txs_by_height.pop(n):
                    self._tx_index.pop(th, None)

    def _index_txns(self, block: Block, receipts=()) -> None:
        if not block.transactions:
            return
        hashes = []
        for i, t in enumerate(block.transactions):
            self._tx_index[t.hash] = (block.number, i)
            hashes.append(t.hash)
        self._txs_by_height[block.number] = hashes
        # durable sidecar (the LevelDB receipts + tx-lookup role): the
        # in-memory window prunes, the store does not
        self.store.put_receipts(block.hash, [r.encode() for r in receipts],
                                [(h, block.number) for h in hashes])

    def lookup_txn(self, txn_hash: bytes):
        """``(block, index, receipt) | None`` via the txn index, falling
        back to the store for history outside the in-memory window."""
        loc = self._tx_index.get(txn_hash)
        if loc is None:
            n = self.store.tx_loc(txn_hash)
            if n is None:
                return None
            blk = self.get_block_by_number(n)
            if blk is None:
                return None
            for i, t in enumerate(blk.transactions):
                if t.hash == txn_hash:
                    receipts = self.receipts_of(blk.hash)
                    return blk, i, (receipts[i] if i < len(receipts)
                                    else None)
            return None
        n, i = loc
        blk = self.get_block_by_number(n)
        if blk is None or i >= len(blk.transactions) \
                or blk.transactions[i].hash != txn_hash:
            return None  # displaced by a reorg
        receipts = self.receipts_of(blk.hash)
        return blk, i, receipts[i] if i < len(receipts) else None

    # -- state reads (L3 surface for RPC / txpool / acceptors) ------------

    def state_at(self, block_hash: bytes):
        return self._states.get(block_hash)

    def head_state(self):
        return self._states[self._head.hash]

    def receipts_of(self, block_hash: bytes) -> tuple:
        got = self._receipts.get(block_hash)
        if got is not None:
            return got
        # outside the pruned window: the durable sidecar still has them
        stored = self.store.get_receipts(block_hash)
        if stored is None:
            return ()
        from eges_tpu_torch.core.state import Receipt
        return tuple(Receipt.from_rlp(rlp.decode(e)) for e in stored)

    def execute_preview(self, txs, coinbase: bytes = bytes(20),
                        ctx=None) -> tuple:
        """Proposer-side dry run on top of the head state: greedily apply
        ``txs``, dropping any that cannot execute, and return
        ``(kept_txs, root, receipt_root, gas_used)`` for the new header
        (the role of the worker's commitTransactions loop,
        ref: miner/worker.go:463-467).  ``coinbase`` is the PROPOSED
        block's fee recipient and ``ctx`` MUST carry the exact
        time/difficulty/number the sealed header will — validation
        re-executes with ``block_ctx(header)``, so any divergence (a
        contract reading TIMESTAMP, say) makes the committed state root
        unreproducible."""
        from eges_tpu_torch.core.evm import BlockCtx
        from eges_tpu_torch.core.state import (
            StateError, apply_txn, receipts_root, recover_senders,
        )
        with self._lock:
            state = self.head_state().copy()
            try:
                senders = recover_senders(txs, self.verifier)
            except StateError:
                senders = [None] * len(txs)
            kept, receipts, gas = [], [], 0
            if ctx is None:
                ctx = BlockCtx(coinbase=coinbase,
                               number=self._head.number + 1,
                               time=self._head.header.time + 1)
            for t, sender in zip(txs, senders):
                if sender is None:
                    continue
                try:
                    r = apply_txn(state, t, sender, coinbase, gas,
                                  ctx=ctx, verifier=self.verifier)
                except StateError:
                    continue
                gas = r.cumulative_gas_used
                receipts.append(r)
                kept.append(t)
            from eges_tpu_torch.core.state import receipts_bloom
            return (kept, state.root(), receipts_root(receipts), gas,
                    receipts_bloom(receipts))

    def validate_candidate(self, block: Block) -> bool:
        """Full acceptor-side validation of a proposed block WITHOUT
        inserting: ancestry, tx root, signatures, state/receipt/gas
        commitments — the checks the insert path will make, run before
        ACKing (the reference acceptor ACKs unconditionally,
        geec_state.go:545).  Falls back to body+signature checks when the
        parent state is unknown (we are behind)."""
        with self._lock:
            try:
                self._verify_body(block)
            except ChainError:
                return False
            parent_state = self._states.get(block.header.parent_hash)
            if parent_state is None:
                # parent unknown: we are behind — signature checks only
                from eges_tpu_torch.crypto.verify_host import batch_verify_txns
                return batch_verify_txns(block.transactions, self.verifier)
            # parent known: the proposal must extend OUR head, or the
            # insert path would reject what we ACKed ("non-sequential
            # insert") and the quorum round is wasted on a stale parent
            if (block.header.parent_hash != self._head.hash
                    or block.header.number != self._head.number + 1):
                return False
            try:
                self._process(block, parent_state)
            except ChainError:
                return False
            return True

    # -- insert funnel ----------------------------------------------------

    def offer(self, block: Block) -> list[Block]:
        """Submit a block from any source; inserts it (and any buffered
        successors) when in order.  Returns the blocks inserted.

        Never raises on a bad block: like the fetcher funnel it came from
        (eth/fetcher/fetcher.go:647-684 drops blocks that fail import), a
        block that fails verification is dropped and counted — an invalid
        or conflicting gossip block must not take down the caller's event
        loop.
        """
        with self._lock:
            inserted = []
            if block.number <= self._head.number:
                return inserted  # duplicate/old — fetcher-style dedup
            if block.number > self._head.number + 256:
                return inserted  # beyond the buffer window: sync, don't buffer
            cands = self._future.setdefault(block.number, [])
            if (len(cands) < self._MAX_CANDIDATES
                    and all(b.hash != block.hash for b in cands)):
                cands.append(block)
            while (cands := self._future.get(self._head.number + 1)):
                del self._future[self._head.number + 1]
                ok = None
                for cand in cands:
                    try:
                        self._insert(cand)
                        ok = cand
                        break
                    except ChainError as e:
                        self.bad_blocks += 1
                        self.last_error = str(e)
                        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
                        metrics.counter("chain.bad_blocks").inc()
                if ok is None:
                    break
                inserted.append(ok)
            # memory bound: 256-height window x _MAX_CANDIDATES per height
            return inserted

    def replace_suffix(self, blocks: list[Block]) -> bool:
        """Reorg: replace our chain suffix with a confirmed alternative.

        Geec forks arise one way only: a partitioned node forced local
        empty blocks (confidence 0, HandleBlockTimeout semantics) while
        the quorum confirmed real ones.  The quorum chain wins — but ONLY
        ever displacing locally-forced empty blocks; confirmed non-empty
        history is immutable.  (The reference leans on geth's
        total-difficulty reorg in core/blockchain.go:927+; Geec confidence
        replaces difficulty here.)

        ``blocks``: contiguous ascending, parented into our chain.
        Returns True if the reorg was applied.
        """
        with self._lock:
            if not blocks:
                return False
            first = blocks[0]
            if first.number > self._head.number:
                return False  # nothing to displace; use offer()
            anchor = self.get_block_by_number(first.number - 1)
            if anchor is None or first.header.parent_hash != anchor.hash:
                return False
            # every displaced block must be a local empty (EmptyAddr
            # coinbase) with no quorum confidence
            for n in range(first.number, self._head.number + 1):
                displaced = self.get_block_by_number(n)
                conf = displaced.confirm.confidence if displaced.confirm else 0
                if displaced.header.coinbase != EMPTY_ADDR or conf > 0:
                    return False
            # replacements must be confirmed and well-linked
            prev = anchor
            for b in blocks:
                if (b.number != prev.number + 1
                        or b.header.parent_hash != prev.hash
                        or b.confirm is None):
                    return False
                prev = b
            # rewind + replay (the bloom index rewinds too; each insert
            # re-adds its height with the replacement bloom)
            self._head = anchor
            self.bloom_index.truncate(first.number)
            for b in blocks:
                try:
                    self._insert(b)
                except ChainError as e:
                    self.bad_blocks += 1
                    self.last_error = str(e)
                    return False
            self._future.clear()
            return True

    def _insert(self, block: Block) -> None:
        import time

        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        # analysis: allow-determinism(insert dt is metrics/volatile-only)
        t0 = time.monotonic()
        self._verify_header(block.header)
        self._verify_body(block)
        parent_state = self._states.get(block.header.parent_hash)
        if parent_state is None:
            raise ChainError("no state for parent")  # cannot happen in-order
        state, receipts, _ = self._process(block, parent_state)
        self.store.put_block(block)
        self.store.set_head(block.hash)
        self._head = block
        self._remember_state(block.hash, block.number, state, receipts)
        self._index_txns(block, receipts)
        self.bloom_index.add(block.number, block.header.bloom)
        from eges_tpu_torch.utils import tracing

        # analysis: allow-determinism(insert dt is metrics/volatile-only)
        dt = time.monotonic() - t0
        metrics.timer("chain.insert").update(dt)
        metrics.histogram("chain.insert_seconds").observe(dt)
        metrics.counter("chain.blocks").inc()
        metrics.counter("chain.txns").inc(len(block.transactions))
        metrics.counter("chain.geec_txns").inc(len(block.geec_txns))
        metrics.gauge("chain.height").set(block.number)
        tracing.DEFAULT.record_span("chain.insert", dt, number=block.number,
                                    txns=len(block.transactions))
        if self.journal is not None:
            self.journal.record("block_committed", blk=block.number,
                                txns=len(block.transactions),
                                dt=round(dt, 6))
        for fn in self._listeners:
            fn(block)

    def adopt_snapshot(self, block: Block, state) -> None:
        """Install a root-verified state snapshot as the new head
        WITHOUT its ancestry — the fast-sync pivot adoption (ref:
        eth/downloader/downloader.go:1353 pivot commit +
        statesync.go:1).  The caller is responsible for having verified
        ``block`` against a quorum certificate; this method enforces the
        state<->header binding and persists the snapshot sidecar so a
        restart can anchor on it (no ancestors exist to replay)."""
        from eges_tpu_torch.core import statesync as _ss

        with self._lock:
            if state.root() != block.header.root:
                raise ChainError("snapshot root does not match pivot header")
            if block.number <= self._head.number:
                raise ChainError("pivot not ahead of head")
            self.store.put_block(block)
            self.store.set_head(block.hash)
            self._head = block
            self._remember_state(block.hash, block.number, state, ())
            self._index_txns(block)
            self.bloom_index.add(block.number, block.header.bloom)
            self.store.put_snapshot(_ss.encode_snapshot(block.hash, state))
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics

            metrics.gauge("chain.height").set(block.number)
            metrics.counter("chain.fastsync_adoptions").inc()
        for fn in self._listeners:
            fn(block)

    def make_empty_block(self) -> Block:
        """Empty block atop the current head, keeping numbers dense
        (ref: core/geec_state.go:885-920 GenerateEmptyBlock —
        coinbase=EmptyAddr marks it; state root carried forward)."""
        parent = self._head
        return new_block(Header(
            parent_hash=parent.hash,
            number=parent.number + 1,
            time=parent.header.time + 1,
            coinbase=EMPTY_ADDR,
            root=parent.header.root,
            difficulty=1,
        ))
