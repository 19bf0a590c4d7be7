"""Fast-sync state snapshots: serialize, page, rebuild, verify.

The port's copy of ``eges_tpu/core/statesync.py``, unchanged but for its
imports.

Fills the fast/state-sync role of the reference downloader
(eth/downloader/statesync.go:1, the pivot handling in
eth/downloader/downloader.go:1353): a late joiner downloads the state
AT a pivot block and root-verifies it instead of replaying the whole
chain — O(state), not O(chain).

Redesign vs the reference: geth syncs at TRIE-NODE granularity (each
response is a bag of hash-addressed nodes healed into a node database).
This build's state lives in in-memory persistent tries with no
node-hash database, so pages are ACCOUNT-granular: address-sorted
``(addr, nonce, balance, code_hash, ((hashed_slot, value_rlp)…))``
entries plus the referenced code blobs.  Verification is strictly
end-to-end — the joiner rebuilds the account and storage tries and
compares the final root against a quorum-certified pivot header, so a
byzantine serving peer can delay a fast sync but never poison one.

The same serialization doubles as the FileStore's durable snapshot
sidecar, which is what lets a fast-synced node RESTART without the
ancestors it never downloaded (SURVEY §5 checkpoint/resume).
"""

from __future__ import annotations

from eges_tpu_torch.core import rlp
from eges_tpu_torch.core.state import (
    Account, ContractStorage, EMPTY_CODE_HASH, StateDB,
)
from eges_tpu_torch.core.trie import SecureIncrementalTrie


class StateSyncError(Exception):
    pass


def snapshot_accounts(state: StateDB) -> list[tuple]:
    """Address-sorted serializable view of a state snapshot:
    ``(addr, nonce, balance, code_hash, ((hashed_slot, value_rlp)…))``."""
    out = []
    for addr, a in sorted(state.iter_accounts()):
        slots = tuple(sorted(a.storage.items()))
        out.append((addr, a.nonce, a.balance, a.code_hash, slots))
    return out


def codes_for(state: StateDB, accounts) -> tuple[bytes, ...]:
    """Deduped bytecode blobs referenced by ``accounts`` (one page)."""
    seen: dict[bytes, bytes] = {}
    for addr, _n, _b, ch, _s in accounts:
        if ch != EMPTY_CODE_HASH and ch not in seen:
            code = state.code(addr)
            if code:
                seen[ch] = code
    return tuple(seen.values())


def assemble(accounts, codes) -> StateDB:
    """Rebuild a StateDB from downloaded pages.

    Storage tries are rebuilt from their hashed-key pairs; code blobs
    re-hash through ``set_code``.  NOTHING here is trusted — a wrong
    slot, balance, or code blob lands in the rebuilt tries and shifts
    ``root()``, which the caller must compare against a certified
    header before adopting."""
    from eges_tpu_torch.crypto.keccak import keccak256

    code_by_hash = {keccak256(c): c for c in codes}
    accts: dict[bytes, Account] = {}
    for addr, nonce, balance, ch, slots in accounts:
        storage = (ContractStorage(
            SecureIncrementalTrie.from_hashed_pairs(slots))
            if slots else Account().storage)
        accts[bytes(addr)] = Account(nonce=nonce, balance=balance,
                                     code_hash=bytes(ch), storage=storage)
    st = StateDB(accts)
    for addr, _n, _b, ch, _s in accounts:
        if ch != EMPTY_CODE_HASH:
            # a missing/corrupt blob makes code_hash diverge -> the
            # final root check rejects the whole snapshot
            st.set_code(bytes(addr), code_by_hash.get(bytes(ch), b""))
    return st


# -- durable snapshot sidecar (FileStore restart path) ----------------------
#
# Two wire shapes share the sidecar slot:
#   legacy    rlp [block_hash, accounts, codes]           (fast-sync adopt)
#   checkpoint rlp [MAGIC, version, keccak(body), body]   (periodic cadence)
# where body is itself rlp [block_hash, accounts, codes, consensus].  The
# checkpoint adds a whole-blob checksum (a torn/bit-flipped sidecar is
# DETECTED before any account decodes) and an optional consensus section
# so a restart re-seeds membership/trust-rand soft state instead of
# replaying the whole chain to rebuild it.  ``decode_checkpoint`` sniffs
# the shape, so either generation of sidecar boots either generation of
# node.

CHECKPOINT_MAGIC = b"geec-ckpt"
CHECKPOINT_VERSION = 1


def _encode_accounts(accounts) -> list:
    return [[a, n, b, ch, [[k, v] for k, v in slots]]
            for a, n, b, ch, slots in accounts]


def _decode_accounts(accounts) -> list[tuple]:
    """Decode + validate the account page list: addresses must be
    strictly increasing (sorted, no duplicates) — the invariant every
    writer holds, so a mutated sidecar trips here instead of quietly
    rebuilding a different state."""
    items = []
    prev = None
    for a, n, b, ch, slots in accounts:
        addr = bytes(a)
        if prev is not None and addr <= prev:
            raise StateSyncError("accounts out of order or duplicated")
        prev = addr
        items.append((addr, rlp.decode_uint(n), rlp.decode_uint(b),
                      bytes(ch),
                      tuple((bytes(k), bytes(v)) for k, v in slots)))
    return items


def _encode_consensus(cons: dict) -> bytes:
    return rlp.encode([
        [[m[0], m[1], str(m[2]).encode(), int(m[3]), int(m[4]),
          int(m[5]), int(m[6])] for m in cons.get("members", ())],
        [[int(k), int(v)] for k, v in cons.get("trust_rands", ())],
        [int(n) for n in cons.get("empty_blocks", ())],
        [int(n) for n in cons.get("unconfirmed", ())],
        1 if cons.get("registered") else 0,
    ])


def _decode_consensus(blob: bytes) -> dict:
    members, rands, empties, unconfirmed, registered = rlp.decode(blob)
    return {
        "members": [(bytes(a), bytes(ref), bytes(ip).decode(),
                     rlp.decode_uint(port), rlp.decode_uint(joined),
                     rlp.decode_uint(ttl), rlp.decode_uint(renewed))
                    for a, ref, ip, port, joined, ttl, renewed in members],
        "trust_rands": [(rlp.decode_uint(k), rlp.decode_uint(v))
                        for k, v in rands],
        "empty_blocks": [rlp.decode_uint(n) for n in empties],
        "unconfirmed": [rlp.decode_uint(n) for n in unconfirmed],
        "registered": bool(rlp.decode_uint(registered)),
    }


def encode_snapshot(block_hash: bytes, state: StateDB) -> bytes:
    accounts = snapshot_accounts(state)
    codes = codes_for(state, accounts)
    return rlp.encode([
        block_hash, _encode_accounts(accounts), list(codes)])


def encode_checkpoint(block_hash: bytes, state: StateDB,
                      consensus: dict | None = None) -> bytes:
    """Versioned, checksummed sidecar blob (state + optional consensus
    soft state) for the periodic durability cadence."""
    from eges_tpu_torch.crypto.keccak import keccak256

    accounts = snapshot_accounts(state)
    codes = codes_for(state, accounts)
    body = rlp.encode([
        block_hash, _encode_accounts(accounts), list(codes),
        _encode_consensus(consensus) if consensus is not None else b""])
    return rlp.encode([CHECKPOINT_MAGIC, CHECKPOINT_VERSION,
                       keccak256(body), body])


def decode_checkpoint(data: bytes) -> tuple[bytes, StateDB, dict | None]:
    """Decode either sidecar generation; any corruption — torn tail,
    bit flip, bad checksum, unsorted accounts — raises
    :class:`StateSyncError` so the boot path falls back to full replay
    instead of adopting a damaged state."""
    from eges_tpu_torch.crypto.keccak import keccak256

    try:
        top = rlp.decode(data)
        if (isinstance(top, (list, tuple)) and len(top) == 4
                and bytes(top[0]) == CHECKPOINT_MAGIC):
            _magic, version, checksum, body = top
            if rlp.decode_uint(version) != CHECKPOINT_VERSION:
                raise StateSyncError("unknown checkpoint version")
            body = bytes(body)
            if keccak256(body) != bytes(checksum):
                raise StateSyncError("checkpoint checksum mismatch")
            block_hash, accounts, codes, cons_blob = rlp.decode(body)
            cons = (_decode_consensus(bytes(cons_blob))
                    if bytes(cons_blob) else None)
        else:
            block_hash, accounts, codes = top
            cons = None
        items = _decode_accounts(accounts)
        state = assemble(items, [bytes(c) for c in codes])
        return bytes(block_hash), state, cons
    except StateSyncError:
        raise
    except Exception as exc:
        raise StateSyncError(f"corrupt snapshot sidecar: {exc!r}") from exc


def decode_snapshot(data: bytes) -> tuple[bytes, StateDB]:
    block_hash, state, _cons = decode_checkpoint(data)
    return block_hash, state


# -- staged-page codec (mid-sync crash resume) ------------------------------

def encode_page(pivot: int, root: bytes, cursor: int, total,
                accounts, codes) -> bytes:
    """One accepted live-sync page, framed for the store's sync staging
    log so a crash mid-download resumes instead of restarting."""
    return rlp.encode([int(pivot), root, int(cursor), int(total or 0),
                       _encode_accounts(accounts),
                       [bytes(c) for c in codes]])


def decode_page(blob: bytes) -> tuple:
    """-> ``(pivot, root, cursor, total|None, accounts, codes)``;
    raises :class:`StateSyncError` on any corruption, so a torn staged
    tail truncates the resume instead of poisoning it."""
    try:
        pivot, root, cursor, total, accounts, codes = rlp.decode(blob)
        return (rlp.decode_uint(pivot), bytes(root),
                rlp.decode_uint(cursor), rlp.decode_uint(total) or None,
                _decode_accounts(accounts), [bytes(c) for c in codes])
    except StateSyncError:
        raise
    except Exception as exc:
        raise StateSyncError(f"corrupt staged page: {exc!r}") from exc
