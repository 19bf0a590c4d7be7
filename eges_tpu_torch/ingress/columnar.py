"""Columnar txn ingest — the wire-speed front half (ROADMAP item 5).

The port's copy of ``eges_tpu/ingress/columnar.py``: bulk hashing uses
the port's ``crypto/native.py`` (``geec_keccak256_multi``), as there.

The back half of the pipeline is batched to the hilt (one device call
per verify window); before this module, every row still paid per-tx
Python on the way in: a per-datagram RLP decode into a ``Transaction``
object, a per-tx ``signature_parts()`` re-encode, a per-tx cache probe
and ``Future`` in the scheduler, per-tx dict bookkeeping in the pool.
Here a whole gossip window of txn frames is decoded ONCE into columnar
numpy arrays — ``sighash32`` / ``sig65`` / ``txhash`` / ``gas_price`` /
``nonce`` columns plus validity masks — shaped exactly like the verify
path's staging buffers, so the window lands in the device staging pool
(``verifier.recover_addresses`` / ``scheduler.submit_window``) without
any per-row conversion.  ``Transaction`` object construction is
deferred to admission time (:meth:`TxColumns.txn`): rejected rows —
the flood case — never materialize an object at all, keeping the
cheap-reject path cheap at wire rate (arXiv 1808.02252's DoS contract;
arXiv 2112.02229's never-touch-a-scalar-path discipline).

Byte-identity contract: for every frame the per-row results here equal
the legacy scalar path exactly —

* ``txhash`` is ``keccak256(frame)``.  ``core/rlp.py`` rejects every
  non-canonical encoding, so a frame that decodes at all re-encodes to
  itself and this equals ``Transaction.decode(frame).hash``.
* ``sighash`` is built by slicing the first six field encodings
  straight out of the frame (one list header + optional EIP155
  suffix), which equals ``Transaction.sighash(chain_id)`` for the same
  canonicality reason — no re-encode, no Transaction.
* the ``valid`` mask applies the same v/r/s rules as
  ``Transaction.signature_parts()`` (mask-don't-raise), and the
  ``decoded`` mask the same width guards as ``Transaction.from_rlp``.

The tier-1 differential test (tests/test_columnar_ingest.py) holds the
two paths byte-identical end to end: admissions, stats, ledger
billing, journal dumps.
"""

from __future__ import annotations

import numpy as np

from eges_tpu_torch.core import rlp
from eges_tpu_torch.core.types import Transaction
from eges_tpu_torch.crypto.keccak import keccak256

# Hard per-frame byte gate, applied BEFORE any parsing: an oversized
# frame must die without costing a decode or even a hash (the node's
# datagram path already enforces its own INGRESS_MAX_BYTES on the whole
# message; this is the per-row second fence for direct window callers).
FRAME_MAX_BYTES = 128 * 1024

# Hard row cap per window — the largest window the scheduler's staging
# pool is sized for; decode callers chunk above it.
WINDOW_MAX_ROWS = 16384

_SECP_MAX = 1 << 256


class TxColumns:
    """One decoded gossip window in columnar form.

    Arrays are row-aligned: row ``i`` of every column describes frame
    (or txn) ``i`` of the input.  ``decoded[i]`` is False when the
    frame failed the size gate or canonical decode (no identity — the
    row is untouchable); ``valid[i]`` is False when the row decoded
    but its v/r/s cannot form a wire signature (the cheap-reject rows
    the pool bills without ever building a ``Transaction``).
    """

    __slots__ = ("n", "sighash", "sig", "txhash", "gas_price", "nonce",
                 "decoded", "valid", "hashes", "_items", "_txns")

    def __init__(self, n: int):
        self.n = n
        self.sighash = np.zeros((n, 32), np.uint8)
        self.sig = np.zeros((n, 65), np.uint8)
        self.txhash = np.zeros((n, 32), np.uint8)
        self.gas_price = np.zeros((n,), np.uint64)
        self.nonce = np.zeros((n,), np.uint64)
        self.decoded = np.zeros((n,), bool)
        self.valid = np.zeros((n,), bool)
        # python-object mirror of ``txhash`` for set-based dedup (the
        # pool's ``_known`` difference is one C-level set op over these)
        self.hashes: list[bytes | None] = [None] * n
        self._items: list = [None] * n  # parsed RLP items, decode path
        self._txns: list = [None] * n   # materialized / original txns

    def txn(self, i: int) -> Transaction:
        """Materialize row ``i``'s ``Transaction`` — admission time
        only; rejected rows never pay this."""
        t = self._txns[i]
        if t is None:
            # direct field construction instead of from_rlp: the scan
            # already enforced every from_rlp guard (canonical uints,
            # r/s/v widths, `to` length), so int.from_bytes over the
            # raw payloads builds the identical object without a
            # second decode pass
            it = self._items[i]
            t = Transaction(
                nonce=int.from_bytes(it[0], "big"),
                gas_price=int.from_bytes(it[1], "big"),
                gas_limit=int.from_bytes(it[2], "big"),
                to=bytes(it[3]) if it[3] else None,
                value=int.from_bytes(it[4], "big"),
                payload=bytes(it[5]),
                is_geec=bool(int.from_bytes(it[6], "big")),
                v=int.from_bytes(it[7], "big"),
                r=int.from_bytes(it[8], "big"),
                s=int.from_bytes(it[9], "big"))
            h = self.hashes[i]
            if h is not None:
                # seed the memoized hash from the wire frame's keccak
                # (canonical RLP: keccak256(frame) == keccak256(
                # t.encode())) — admission never re-encodes the row
                t._SENDER_CACHE["hash"] = h
            self._txns[i] = t
        return t

    def gather(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(sighash32, sig65) sub-arrays for ``rows`` — contiguous
        uint8 blocks that drop straight into the verifier's staging
        buffers (one fancy-index copy, zero per-row conversion)."""
        return self.sighash[rows], self.sig[rows]


def _scan_txn_frame(frame: bytes) -> tuple[list, list]:
    """Parse one canonical txn frame WITHOUT building a Transaction:
    returns ``(items, spans)`` where ``items[i]`` is field ``i``'s raw
    byte-string payload and ``spans[i] = (enc_start, enc_end)`` is the
    field's FULL encoding span inside ``frame`` (header included) —
    what the sighash preimage is sliced from.  Raises RLPError on
    anything ``Transaction.decode`` would reject."""
    if not frame:
        raise rlp.RLPError("empty frame")
    b0 = frame[0]
    if b0 < 0xC0:
        raise rlp.RLPError("txn frame must be a list")
    if b0 < 0xF8:
        pos, end = 1, 1 + (b0 - 0xC0)
    else:
        ln = b0 - 0xF7
        if 1 + ln > len(frame):
            raise rlp.RLPError("truncated length")
        lb = frame[1:1 + ln]
        if lb[:1] == b"\x00":
            raise rlp.RLPError("non-canonical length")
        n = int.from_bytes(lb, "big")
        if n < 56:
            raise rlp.RLPError("non-canonical long list")
        pos, end = 1 + ln, 1 + ln + n
    if end != len(frame):
        raise rlp.RLPError("trailing bytes")
    items, spans = [], []
    push_item, push_span = items.append, spans.append
    flen = len(frame)
    for _ in range(10):
        if pos >= end:
            raise rlp.RLPError("txn frame needs 10 fields")
        enc_start = pos
        # _scan_string_item's exact rules, inlined: ten calls per frame
        # is the decode loop's hottest edge
        b0 = frame[pos]
        if b0 < 0x80:
            ps, pe = pos, pos + 1
            pos += 1
        elif b0 < 0xB8:  # short string
            n = b0 - 0x80
            ps = pos + 1
            pe = ps + n
            if pe > flen:
                raise rlp.RLPError("truncated string")
            if n == 1 and frame[ps] < 0x80:
                raise rlp.RLPError("non-canonical single byte")
            pos = pe
        elif b0 < 0xC0:  # long string
            ln = b0 - 0xB7
            ps = pos + 1 + ln
            if ps > flen:
                raise rlp.RLPError("truncated length")
            lb = frame[pos + 1:ps]
            if lb[:1] == b"\x00":
                raise rlp.RLPError("non-canonical length")
            n = int.from_bytes(lb, "big")
            if n < 56:
                raise rlp.RLPError("non-canonical long string")
            pe = ps + n
            if pe > flen:
                raise rlp.RLPError("truncated string")
            pos = pe
        else:
            raise rlp.RLPError("txn field must be a string item")
        if pos > end:
            raise rlp.RLPError("list payload overrun")
        push_item(frame[ps:pe])
        push_span((enc_start, pos))
    if pos != end:
        raise rlp.RLPError("txn frame needs exactly 10 fields")
    # the from_rlp guards: r/s fit 256 bits, v fits 64 bits, `to` is
    # empty or a 20-byte address, uint fields carry no leading zero —
    # every frame that decodes here must also survive from_rlp, so a
    # deferred txn() at admission time can never raise
    if len(items[8]) > 32 or len(items[9]) > 32:
        raise rlp.RLPError("signature scalar wider than 256 bits")
    if len(items[7]) > 8:
        raise rlp.RLPError("v wider than 64 bits")
    if len(items[3]) not in (0, 20):
        raise rlp.RLPError("to must be empty or a 20-byte address")
    for idx in (0, 1, 2, 4, 6, 7, 8, 9):  # all but to(3)/payload(5)
        if items[idx][:1] == b"\x00":
            raise rlp.RLPError("non-canonical integer (leading zero)")
    return items, spans


def _list_header(n: int) -> bytes:
    """RLP list header for an ``n``-byte payload (encode-side mirror of
    the scanner above; kept local so no private reach into rlp)."""
    if n < 56:
        return bytes([0xC0 + n])
    lb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0xC0 + 55 + len(lb)]) + lb


def _dispatch_keccak_many():
    """Prefer the native variable-length batch digest (ONE FFI call
    per window instead of one per hash); per-message :func:`keccak256`
    stays the golden fallback for old library builds."""
    try:
        from eges_tpu_torch.crypto import native

        if native.available() and native.keccak256_multi(
                b"ab", (0, 1, 2)) == keccak256(b"a") + keccak256(b"b"):
            return native.keccak256_multi
    # analysis: allow-swallow(optional native-accel probe; falls back to python)
    except Exception:
        pass
    return None


_KECCAK_MULTI = _dispatch_keccak_many()


def _keccak_many(msgs: list) -> bytes:
    """Flat ``len(msgs)*32`` digest bytes for a list of messages."""
    if not msgs:
        return b""
    if _KECCAK_MULTI is None:
        return b"".join(keccak256(m) for m in msgs)
    offsets = [0]
    push = offsets.append
    total = 0
    for m in msgs:
        total += len(m)
        push(total)
    return _KECCAK_MULTI(b"".join(msgs), offsets)


def decode_window(frames) -> TxColumns:  # ingress-entry:bounded
    """Vectorized envelope/signature extraction: a whole window of raw
    txn frames (length-capped by the transport) into one
    :class:`TxColumns` — O(1) Python-level transitions per window on
    the downstream path instead of O(rows).

    Two passes.  Scan: per frame the byte gate (oversized frames die
    pre-decode, pre-hash), one canonical scan recording field spans,
    and ``signature_parts``'s exact v/r/s rules — the sighash preimage
    is sliced straight out of the frame (list header + first six field
    encodings + EIP155 suffix), no re-encode, no ``Transaction``.
    Fill: ONE batched keccak call digests every txhash and sighash in
    the window, then the columns fill with whole-array writes.  Decode
    or signature failures mask the row out instead of raising
    (mask-don't-raise, the batch contract); invalid-signature rows
    never pay a sighash keccak."""
    frames = list(frames)
    if len(frames) > WINDOW_MAX_ROWS:
        raise ValueError("window exceeds %d rows — chunk the caller"
                         % WINDOW_MAX_ROWS)
    cols = TxColumns(len(frames))
    dec_rows: list[int] = []    # row index per decoded frame
    dec_msgs: list[bytes] = []  # the frame bytes (txhash preimage)
    nonces: list[int] = []
    prices: list[int] = []
    sig_rows: list[int] = []    # row index per signature-valid row
    sig_blobs: list[bytes] = []  # 65-byte wire sig per valid row
    sig_pre: list[bytes] = []   # sighash preimage per valid row
    for i, frame in enumerate(frames):
        if not frame or len(frame) > FRAME_MAX_BYTES:
            continue  # oversized/empty: dead before any parse or copy
        frame = bytes(frame)  # bounded-by: len(frame) <= FRAME_MAX_BYTES (guard above)
        try:
            items, spans = _scan_txn_frame(frame)
        except rlp.RLPError:
            continue
        cols._items[i] = items
        dec_rows.append(i)
        dec_msgs.append(frame)
        nonces.append(min(int.from_bytes(items[0], "big"),
                          (1 << 64) - 1))
        prices.append(min(int.from_bytes(items[1], "big"),
                          (1 << 64) - 1))
        # signature_parts()'s exact v/r/s rules, span-sliced
        v = int.from_bytes(items[7], "big")
        protected = v not in (27, 28) and v != 0
        if protected and v < 35:
            continue  # the chain_id ValueError branch: 29..34 unassigned
        cid = (v - 35) // 2 if protected else None
        recid = v - 27 if cid is None else v - 35 - 2 * cid
        r = int.from_bytes(items[8], "big")
        s = int.from_bytes(items[9], "big")
        if not (0 <= recid <= 3 and 0 < r < _SECP_MAX
                and 0 < s < _SECP_MAX):
            continue
        sig_rows.append(i)
        sig_blobs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big")
                         + bytes([recid]))
        body = frame[spans[0][0]:spans[5][1]]
        if cid is not None:
            body = body + rlp.encode(cid) + b"\x80\x80"
        sig_pre.append(_list_header(len(body)) + body)
    # one digest batch for the whole window: txhashes first, sighashes
    # after — sliced back apart by count
    digests = _keccak_many(dec_msgs + sig_pre)
    n_dec = len(dec_rows)
    if n_dec:
        rows = np.asarray(dec_rows, np.int64)
        cols.decoded[rows] = True
        th = digests[:32 * n_dec]
        cols.txhash[rows] = np.frombuffer(th, np.uint8).reshape(-1, 32)
        hashes = cols.hashes
        for k, i in enumerate(dec_rows):
            hashes[i] = th[32 * k:32 * k + 32]
        cols.nonce[rows] = nonces
        cols.gas_price[rows] = prices
    if sig_rows:
        rows = np.asarray(sig_rows, np.int64)
        cols.valid[rows] = True
        cols.sig[rows] = np.frombuffer(b"".join(sig_blobs),
                                       np.uint8).reshape(-1, 65)
        cols.sighash[rows] = np.frombuffer(digests[32 * n_dec:],
                                           np.uint8).reshape(-1, 32)
    return cols


def columns_from_txns(txns) -> TxColumns:  # ingress-entry:bounded
    """Columns for already-decoded ``Transaction`` objects (the gossip
    path hands the pool decoded txns): extraction only — the original
    objects are kept and returned by :meth:`TxColumns.txn`, so
    admission admits the exact objects the legacy path would."""
    txns = list(txns)
    if len(txns) > WINDOW_MAX_ROWS:
        raise ValueError("window exceeds %d rows — chunk the caller"
                         % WINDOW_MAX_ROWS)
    cols = TxColumns(len(txns))
    for i, t in enumerate(txns):
        h = t.hash
        cols.decoded[i] = True
        cols.hashes[i] = h
        cols.txhash[i] = np.frombuffer(h, np.uint8)
        cols._txns[i] = t
        cols.nonce[i] = min(t.nonce, (1 << 64) - 1)
        cols.gas_price[i] = min(t.gas_price, (1 << 64) - 1)
        parts = t.signature_parts()
        if parts is not None:
            sig, sighash = parts
            cols.sig[i] = np.frombuffer(sig, np.uint8)
            cols.sighash[i] = np.frombuffer(sighash, np.uint8)
            cols.valid[i] = True
    return cols
