"""Transaction pool with a device-batched verification window.

The port's copy of ``eges_tpu/core/txpool.py``: admission windows go to
the port's verifier scheduler (``crypto/verify_host.py``).

Role parity with the reference's ``core/tx_pool.go`` for the Geec
capability set: remote txns are validated (signature -> sender) before
entering the pending set the proposer drains (ref: validateTx's
``types.Sender`` call, core/tx_pool.go:571-573 — the "second TPU
batch-verify target", SURVEY §2.2).

TPU-first redesign (SURVEY §7 step 5): instead of one ecrecover per
``add``, incoming txns accumulate in a verify queue that is flushed as
ONE device batch when either ``max_batch`` rows are waiting or the
``window_ms`` timer fires — the classic latency/occupancy batching
window.  Senders come back from the same batch (recover_addresses), so
admission costs one device call per window regardless of txn rate.
"""

from __future__ import annotations

import threading

from eges_tpu_torch.core.types import Transaction
from eges_tpu_torch.utils import ledger
from eges_tpu_torch.utils import tracing


class _WindowChunk:
    """A columnar window's fresh rows queued for the verify flush.

    Rides the same ``_queue`` as scalar ``Transaction`` entries so
    mixed arrivals (windows from gossip, singletons from RPC) flush in
    strict arrival order; ``rows`` indexes the still-live rows of the
    shared ``TxColumns`` and shrinks in place when a flush slice splits
    the chunk at a ``max_batch`` boundary."""

    __slots__ = ("cols", "rows")

    def __init__(self, cols, rows):
        self.cols = cols
        self.rows = rows  # list of row indices into cols, arrival order


class TxPool:
    def __init__(self, clock, verifier=None, *, window_ms: float = 5.0,
                 max_batch: int = 1024, max_pending: int = 100_000,
                 on_admitted=None, journal_path: str | None = None):
        self.clock = clock
        self.verifier = verifier
        self.window_ms = window_ms
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.on_admitted = on_admitted
        # One re-entrant monitor guards every mutable structure below:
        # add_locals arrives on the RPC thread while the window flush
        # fires on the clock thread.  A GeecNode that adopts this pool
        # REPLACES this lock with its own (GeecNode.txpool setter) so
        # node + pool form a single lock domain — the on_admitted hook
        # re-enters the node from inside a flush, and two separate locks
        # would be acquired in opposite orders on that path.
        self._lock = threading.RLock()
        # local-txn journal (ref: core/tx_pool.go journal — locally
        # submitted txns survive a restart): append-only RLP records,
        # rotated to the still-pending set when it grows stale
        self.journal_path = journal_path
        self._journal = None
        self._journal_count = 0
        # sender -> {nonce -> txn}; admission order preserved separately
        # as (sender, txn) so selection never rescans the whole pool
        self.pending: dict[bytes, dict[int, Transaction]] = {}  # guarded-by: _lock
        self._order: list[tuple[bytes, Transaction]] = []  # guarded-by: _lock
        # hash -> (sender, nonce)
        self._by_hash: dict[bytes, tuple[bytes, int]] = {}  # guarded-by: _lock
        self._dead: set[bytes] = set()  # guarded-by: _lock
        self._known: set[bytes] = set()  # guarded-by: _lock
        # verify queue: scalar Transactions interleaved with columnar
        # _WindowChunk entries in strict arrival order (mixed arrivals
        # must flush exactly like an all-scalar stream); _queue_rows is
        # the ROW count (a chunk is many rows), the unit max_batch and
        # the flush trigger are denominated in
        self._queue: list = []  # guarded-by: _lock
        self._queue_rows = 0  # guarded-by: _lock
        self._window_chunks = 0  # guarded-by: _lock
        self._timer = None
        self.stats = {"admitted": 0, "rejected": 0, "duplicate": 0,  # guarded-by: _lock
                      "batches": 0, "replaced": 0}
        # distributed-tracing linkage: per-txn SpanContext captured at
        # ingest.  The flush runs on a clock callback where contextvars
        # don't survive, so the context is carried here explicitly and
        # re-parented at admit / commit time.
        self.owner = ""  # identifies this pool's node in span attrs
        self._ingest_ctx: dict[bytes, tracing.SpanContext] = {}  # guarded-by: _lock
        self._INGEST_CTX_CAP = 8192
        self._KNOWN_CAP = 1 << 16  # dedup-history bound (maxKnownTxs role)
        # commit-anatomy linkage: per-txn ingest/admit timestamps on the
        # node clock (virtual under the simulator), emitted as one
        # ``commit_anatomy`` stage="pool" event when a block includes
        # the txns — the ingest->admission leg of the per-block
        # critical path (harness/anatomy.py).  Same cap discipline as
        # ``_ingest_ctx``: entries die at eviction.
        self._ingest_t: dict[bytes, float] = {}  # guarded-by: _lock
        self._admit_t: dict[bytes, float] = {}  # guarded-by: _lock
        # ingress-provenance linkage: per-txn (ledger, origin) captured
        # at ingest (utils/ledger.py ambient context) — the window flush
        # runs on a clock callback where the ambient binding is gone, so
        # admit/reject outcomes charge the captured pair.  Same cap
        # discipline as ``_ingest_ctx``; entries pop at their outcome.
        self._ingest_origin: dict[bytes, tuple] = {}
        # consensus event journal (utils/journal.py), attached by the
        # owning GeecNode; distinct from the RLP txn journal above
        self.event_journal = None
        self._depth_gauge()  # register txpool.pending at 0

    def _depth_gauge(self) -> None:
        from eges_tpu_torch.utils import metrics

        metrics.DEFAULT.gauge("txpool.pending").set(len(self._by_hash))

    # -- ingest -----------------------------------------------------------

    def add_remotes(self, txns) -> None:  # thread-entry (RPC via add_locals); ingress-entry:bounded
        """Queue remote txns for batched admission
        (ref: TxPool.AddRemotes core/tx_pool.go:551)."""
        fresh = 0
        with self._lock, \
                tracing.DEFAULT.span("txpool.ingest", owner=self.owner) as sp:
            ctx = sp.context()
            for t in txns:
                h = t.hash
                if h in self._known:
                    self.stats["duplicate"] += 1
                    # ambient charge: a re-delivered txn is pure waste
                    # billed to whoever delivered THIS copy
                    ledger.charge(drops=1)
                    continue
                if len(self._known) >= self._KNOWN_CAP:
                    # coarse clear at the cap (geth's maxKnownTxs
                    # idiom): briefly losing dedup history is cheaper
                    # than letting a hash flood grow the set forever
                    self._known.clear()
                    from eges_tpu_torch.utils import metrics
                    metrics.DEFAULT.counter("txpool.known_clears").inc()
                self._known.add(h)
                self._queue.append(t)
                self._queue_rows += 1
                # one capacity probe covers all three bookkeeping maps:
                # they fill together here and the thread-hygiene counter
                # reconciliation assumes a uniform cap across them
                if len(self._ingest_ctx) < self._INGEST_CTX_CAP:
                    self._ingest_ctx[h] = ctx
                    self._ingest_t[h] = self.clock.now()
                    rec = ledger.current()
                    if rec is not None:
                        self._ingest_origin[h] = rec
                fresh += 1
            sp.set_attr("fresh", fresh)
            if self._queue_rows >= self.max_batch:
                self._flush()
            elif self._queue and self._timer is None:
                self._timer = self.clock.call_later(self.window_ms / 1e3,
                                                    self._on_window)

    def add_remotes_window(self, cols) -> None:  # thread-entry (gossip relay); ingress-entry:bounded
        """Columnar window admission: ONE lock hold and ONE tracing span
        for the whole window, dedup against ``_known`` via set ops, and
        per-window (not per-tx) bookkeeping — the batched sibling of
        :meth:`add_remotes` with row-for-row identical admission
        outcomes, journal events and ledger billing (the differential
        test's contract).  ``cols`` is an ``ingress.columnar.TxColumns``
        duck type: this layer consumes the arrays, it never imports the
        decoder (core stays below ingress in the layer map)."""
        with self._lock, \
                tracing.DEFAULT.span("txpool.ingest", owner=self.owner) as sp:
            ctx = sp.context()
            hashes = cols.hashes
            n_undec = cols.n - int(cols.decoded.sum())
            if n_undec:
                # no identity survives a failed decode: billed to the
                # deliverer as pure waste, dropped pre-queue (the legacy
                # path never sees such rows — its codec drops them)
                ledger.charge(drops=n_undec)
                from eges_tpu_torch.utils import metrics
                metrics.DEFAULT.counter("txpool.window_undecoded").inc(
                    n_undec)
            hs = hashes if not n_undec else \
                [h for h in hashes if h is not None]
            known = self._known
            dup = 0
            if len(known) + len(hs) < self._KNOWN_CAP:
                # fast path: the cap cannot trip mid-window, so dedup is
                # two C-level set ops instead of a per-row probe loop
                uniq = set(hs)
                if len(uniq) == len(hs):
                    dups = uniq & known
                    if dups:
                        dup = len(dups)
                        fresh_rows = [i for i, h in enumerate(hashes)
                                      if h is not None and h not in dups]
                    elif not n_undec:
                        fresh_rows = list(range(cols.n))  # bounded-by: cols.n == len of ONE delivered gossip window (pre-decode INGRESS_MAX_BYTES datagram cap upstream)
                    else:
                        fresh_rows = [i for i, h in enumerate(hashes)
                                      if h is not None]
                    known.update(uniq)
                else:
                    fresh_rows = self._dedup_rows_slow(hashes)
                    dup = len(hs) - len(fresh_rows)
            else:
                # cap boundary: replicate the per-row coarse-clear
                # semantics exactly (a clear mid-window re-admits
                # earlier duplicates, same as the scalar path would)
                fresh_rows = self._dedup_rows_slow(hashes)
                dup = len(hs) - len(fresh_rows)
            if dup:
                self.stats["duplicate"] += dup
                # ambient charge, aggregated: N same-origin unit drops
                # at one timestamp equal one summed drop charge
                ledger.charge(drops=dup)
            if fresh_rows:
                now = self.clock.now()
                rec = ledger.current()
                room = self._INGEST_CTX_CAP - len(self._ingest_ctx)
                book = fresh_rows[:room] if room < len(fresh_rows) \
                    else fresh_rows
                if book:
                    self._ingest_ctx.update((hashes[i], ctx) for i in book)
                    self._ingest_t.update((hashes[i], now) for i in book)
                    if rec is not None:
                        self._ingest_origin.update(
                            (hashes[i], rec) for i in book)
                self._queue.append(_WindowChunk(cols, fresh_rows))
                self._window_chunks += 1
                self._queue_rows += len(fresh_rows)
            sp.set_attr("fresh", len(fresh_rows) if fresh_rows else 0)
            if self._queue_rows >= self.max_batch:
                self._flush()
            elif self._queue and self._timer is None:
                self._timer = self.clock.call_later(self.window_ms / 1e3,
                                                    self._on_window)

    def _dedup_rows_slow(self, hashes) -> list[int]:
        """Per-row dedup replica of the scalar loop — the path taken
        when the window carries intra-window duplicates or could trip
        the ``_KNOWN_CAP`` coarse clear mid-window."""
        fresh_rows = []
        known = self._known
        for i, h in enumerate(hashes):
            if h is None or h in known:
                continue
            if len(known) >= self._KNOWN_CAP:
                known.clear()
                from eges_tpu_torch.utils import metrics
                metrics.DEFAULT.counter("txpool.known_clears").inc()
            known.add(h)
            fresh_rows.append(i)
        return fresh_rows

    def _on_window(self) -> None:
        with self._lock:
            self._timer = None
            self._flush()

    def _flush(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._window_chunks:
            self._flush_mixed()
            return
        batch, self._queue = self._queue[: self.max_batch], \
            self._queue[self.max_batch:]
        if not batch:
            return
        self._queue_rows -= len(batch)
        self.stats["batches"] += 1
        parts = [t.signature_parts() for t in batch]
        senders: list[bytes | None] = [None] * len(batch)
        rows = [(i, p) for i, p in enumerate(parts) if p is not None]
        if rows:
            # one shared recovery path for all three verifier shapes:
            # a VerifierScheduler (window coalescing across callers +
            # the sender cache, so a re-gossiped txn costs a lookup),
            # a plain batch verifier (one device batch), or None (the
            # per-entry host fallback, signature_nocgo.go role)
            from eges_tpu_torch.crypto.verify_host import recover_signers
            rec = recover_signers([(h, sig) for _, (sig, h) in rows],
                                  self.verifier)
            for (i, _), sender in zip(rows, rec):
                senders[i] = sender
        for t, sender in zip(batch, senders):
            if sender is None:
                self.stats["rejected"] += 1
                # invalid signature: the cheap-reject path an ingress
                # flood rides — billed to the captured ingest origin
                self._ledger_charge(t.hash, rejects=1)
                continue
            self._admit(t, sender)
        if self._queue:
            self._flush()

    def _flush_mixed(self) -> None:
        """Row-granular flush for a queue holding columnar window
        chunks (possibly interleaved with scalar txns): each
        ``max_batch``-row slice makes ONE ``recover_signers_window``
        call over arrays gathered straight out of the columns — no
        per-row ``signature_parts``, no per-row entry tuples — and
        ``Transaction`` objects materialize only for rows that admit.
        Outcome order matches the scalar ``_flush`` row for row."""
        import numpy as np

        while self._queue:
            take: list = []
            rows_n = 0
            qi = 0
            consumed_chunks = 0
            while qi < len(self._queue) and rows_n < self.max_batch:
                item = self._queue[qi]
                if isinstance(item, _WindowChunk):
                    need = self.max_batch - rows_n
                    if len(item.rows) <= need:
                        take.append(item)
                        rows_n += len(item.rows)
                        consumed_chunks += 1
                        qi += 1
                    else:  # split: head flushes now, tail stays queued
                        take.append(_WindowChunk(item.cols,
                                                 item.rows[:need]))
                        item.rows = item.rows[need:]
                        rows_n += need
                else:
                    take.append(item)
                    rows_n += 1
                    qi += 1
            self._queue = self._queue[qi:]
            self._window_chunks -= consumed_chunks
            self._queue_rows -= rows_n
            self.stats["batches"] += 1
            # flat row map in arrival order; gather valid rows' arrays
            flat: list = []  # (cols|txn, row_index|None) per output row
            vh, vs, vpos = [], [], []
            for item in take:
                if isinstance(item, _WindowChunk):
                    c, rs = item.cols, item.rows
                    base = len(flat)
                    flat.extend((c, i) for i in rs)
                    rs_arr = np.asarray(rs, dtype=np.int64)
                    mask = c.valid[rs_arr]
                    sel = rs_arr[mask]
                    if sel.size:
                        vh.append(c.sighash[sel])
                        vs.append(c.sig[sel])
                        vpos.extend(
                            (base + np.nonzero(mask)[0]).tolist())
                else:
                    pos = len(flat)
                    flat.append((item, None))
                    p = item.signature_parts()
                    if p is not None:
                        sig, h = p
                        vh.append(np.frombuffer(h, np.uint8)
                                  .reshape(1, 32))
                        vs.append(np.frombuffer(sig, np.uint8)
                                  .reshape(1, 65))
                        vpos.append(pos)
            senders: list = [None] * len(flat)
            if vpos:
                from eges_tpu_torch.crypto.verify_host import \
                    recover_signers_window
                rec = recover_signers_window(
                    vh[0] if len(vh) == 1 else np.concatenate(vh),
                    vs[0] if len(vs) == 1 else np.concatenate(vs),
                    self.verifier)
                for pos, sender in zip(vpos, rec):
                    senders[pos] = sender
            rej: list = []
            # ONE admit span for the whole slice's window rows (spans
            # are ring-buffer telemetry, never journaled — admission
            # outcomes, billing and relay order stay per-row identical
            # to the scalar path); scalar interlopers keep their own
            # per-row span via _admit
            wcm = wsp = None
            amb = ledger.current()  # stable for the whole slice
            try:
                for j, (obj, li) in enumerate(flat):
                    sender = senders[j]
                    if sender is None:
                        self.stats["rejected"] += 1
                        rej.append(obj.hash if li is None
                                   else obj.hashes[li])
                    elif li is None:
                        self._admit(obj, sender)
                    else:
                        t = obj.txn(li)
                        if wcm is None:
                            ctx = self._ingest_ctx.get(t.hash) \
                                or tracing.DEFAULT.current_context()
                            wcm = tracing.DEFAULT.span(
                                "txpool.admit_window", parent=ctx,
                                owner=self.owner, rows=len(flat))
                            wsp = wcm.__enter__()
                        self._admit_traced(t, sender, wsp, batched=True,
                                           amb=amb)
            finally:
                if wcm is not None:
                    wcm.__exit__(None, None, None)
                    # slice-deferred housekeeping (see _admit_traced)
                    self._maybe_compact()
                    self._depth_gauge()
            if rej:
                self._ledger_charge_many(rej, rejects=1)

    def _ledger_charge_many(self, hashes, **counts) -> None:
        """Aggregated flush billing: ONE ``charge()`` per (ledger,
        origin) group — N same-origin unit outcomes at one virtual
        timestamp sum to the same ledger state as N unit charges (the
        decay is lazy, applied per charge timestamp)."""
        amb = ledger.current()
        groups: dict = {}
        order: list = []
        for h in hashes:
            rec = self._ingest_origin.pop(h, None) or amb
            if rec is None:
                continue
            key = (id(rec[0]), rec[1])
            slot = groups.get(key)
            if slot is None:
                groups[key] = [rec, 1]
                order.append(key)
            else:
                slot[1] += 1
        for key in order:
            (led, origin), n = groups[key]
            led.charge(origin, **{k: v * n for k, v in counts.items()})

    # sentinel: "caller did not pre-resolve the ambient ledger pair"
    _NO_AMB = object()

    def _ledger_charge(self, h: bytes, _amb=_NO_AMB, **counts) -> None:
        """Charge a flush outcome to the origin captured at ingest (the
        flush runs on a clock callback with no ambient binding); falls
        back to the ambient pair, no-op when neither exists.  ``_amb``
        lets a window flush resolve :func:`ledger.current` once per
        slice instead of per row — the ambient binding cannot change
        mid-flush (one clock callback, one thread)."""
        rec = self._ingest_origin.pop(h, None)
        if rec is None:
            rec = ledger.current() if _amb is self._NO_AMB else _amb
        if rec is not None:
            led, origin = rec
            led.charge(origin, **counts)

    # a replacement for a (sender, nonce) slot must bid >= 10% more gas
    # price (ref: core/tx_pool.go PriceBump default 10)
    PRICE_BUMP_PCT = 10

    def _admit(self, t: Transaction, sender: bytes) -> None:
        # re-enter the txn's ingest trace: the flush that got us here ran
        # on a clock callback, outside any ambient span context
        ctx = self._ingest_ctx.get(t.hash) \
            or tracing.DEFAULT.current_context()
        with tracing.DEFAULT.span("txpool.admit", parent=ctx,
                                  owner=self.owner,
                                  tx=t.hash.hex()[:16]) as sp:
            self._admit_traced(t, sender, sp)

    def _admit_traced(self, t: Transaction, sender: bytes, sp,
                      batched: bool = False, amb=_NO_AMB) -> None:
        """Admission body.  ``batched=True`` (the window flush) defers
        the per-row housekeeping that is slice-equivalent: the depth
        gauge and ``_order`` compaction run once after the slice, and
        the shared window span skips per-row outcome attrs (on a
        shared span they are last-write-wins noise; the per-row
        outcomes live in ``stats`` and the ledger either way)."""
        by_nonce = self.pending.setdefault(sender, {})
        old = by_nonce.get(t.nonce)
        if old is None and len(self._by_hash) >= self.max_pending:
            # capacity only limits NEW slots: a price-bump replacement
            # keeps the pool size constant and must stay possible even
            # when full (ref: core/tx_pool.go admits replacements)
            self.stats["rejected"] += 1
            self._ledger_charge(t.hash, amb, rejects=1, sender=sender)
            if not batched:
                sp.set_attr("outcome", "rejected")
            if not by_nonce:
                del self.pending[sender]
            return
        if old is not None:
            # price-bump replacement (ref: core/tx_pool.go:571+)
            if t.gas_price * 100 < old.gas_price * (100 + self.PRICE_BUMP_PCT):
                self.stats["duplicate"] += 1
                self._ledger_charge(t.hash, amb, drops=1, sender=sender)
                if not batched:
                    sp.set_attr("outcome", "duplicate")
                return
            self._by_hash.pop(old.hash, None)
            self._dead.add(old.hash)
            self.stats["replaced"] += 1
        by_nonce[t.nonce] = t
        self._order.append((sender, t))
        self._by_hash[t.hash] = (sender, t.nonce)
        if len(self._admit_t) < self._INGEST_CTX_CAP:
            self._admit_t[t.hash] = self.clock.now()
        self.stats["admitted"] += 1
        self._ledger_charge(t.hash, amb, admits=1, sender=sender)
        if not batched:
            self._maybe_compact()
            self._depth_gauge()
            sp.set_attr("outcome", "admitted")
        if self.on_admitted is not None:
            # still inside the admit span: a broadcast hook fired here
            # injects this trace into the outbound gossip envelope
            self.on_admitted(t, sender)

    def _maybe_compact(self) -> None:
        """Compact ``_order`` when mostly tombstones — reachable from
        both eviction AND replacement-heavy ingest (a replacement storm
        with no block inclusions must not grow memory unboundedly)."""
        if len(self._dead) * 2 > max(len(self._order), 64):
            self._order = [(s, t) for s, t in self._order
                           if t.hash not in self._dead]
            self._dead.clear()

    # -- drain ------------------------------------------------------------

    def pending_txns(self, limit: int | None = None,
                     state=None) -> list[Transaction]:
        """Executable-ordered pending txns for block building: senders in
        first-admission order, each sender's txns nonce-ascending
        (ref: TxPool.Pending + types.TxsByPriceAndNonce,
        miner/worker.go:463).

        With ``state`` (a StateDB), only the currently *executable*
        contiguous run per sender is returned — starting at the sender's
        state nonce and staying within its balance — and already-mined
        nonces are evicted.  This is the promote/demote split of the
        reference pool (pending vs queued, core/tx_pool.go): a sender
        with a nonce gap or empty purse no longer starves other senders
        out of the per-block limit."""
        with self._lock:
            seen: set[bytes] = set()
            out: list[Transaction] = []
            for s, _ in list(self._order):
                if s in seen:
                    continue
                seen.add(s)
                by_nonce = self.pending.get(s)
                if not by_nonce:
                    continue
                run = sorted(by_nonce.items())
                if state is not None:
                    start = state.nonce(s)
                    stale = [t for n, t in run if n < start]
                    if stale:
                        self._evict(stale)
                        run = [(n, t) for n, t in run if n >= start]
                    spendable = state.balance(s)
                    picked = []
                    want = start
                    for n, t in run:
                        if n != want:
                            break  # nonce gap: rest is non-executable
                        from eges_tpu_torch.core.state import INTRINSIC_GAS
                        cost = t.value + t.gas_price * INTRINSIC_GAS
                        if cost > spendable:
                            break
                        spendable -= cost
                        picked.append(t)
                        want += 1
                    out.extend(picked)
                else:
                    out.extend(t for _, t in run)
                if limit and len(out) >= limit:
                    break
            return out[:limit] if limit else out

    def _evict(self, txns) -> None:
        """O(evicted) eviction: the ``_by_hash`` index locates each txn's
        (sender, nonce) slot directly, and ``_order`` compacts lazily via
        a tombstone set only when mostly dead (round-2 verdict weak #8:
        the old path rebuilt the whole order list per block)."""
        for t in txns:
            loc = self._by_hash.pop(t.hash, None)
            if loc is None:
                continue
            sender, nonce = loc
            by_nonce = self.pending.get(sender)
            if by_nonce is not None:
                cur = by_nonce.get(nonce)
                if cur is not None and cur.hash == t.hash:
                    del by_nonce[nonce]
                    if not by_nonce:
                        del self.pending[sender]
            self._dead.add(t.hash)  # bounded-by: _maybe_compact clears when dead > live (called below)
            self._ingest_ctx.pop(t.hash, None)
            self._ingest_t.pop(t.hash, None)
            self._admit_t.pop(t.hash, None)
            self._ingest_origin.pop(t.hash, None)
        self._maybe_compact()
        self._depth_gauge()

    def remove_included(self, txns, block: int | None = None) -> None:
        """Drop txns included in a canonical block; closes each txn's
        trace with a ``tx.commit`` span so ingest -> admit -> commit is
        one linked trace even across nodes."""
        with self._lock:
            for t in txns:
                ctx = self._ingest_ctx.get(t.hash)
                if ctx is not None:
                    tracing.DEFAULT.record_span(
                        "tx.commit", 0.0, parent=ctx, owner=self.owner,
                        tx=t.hash.hex()[:16],
                        **({"block": block} if block is not None else {}))
            # commit-anatomy pool stage: the ingest->admission leg of
            # this block's critical path, on the node clock (virtual
            # under the simulator, so deterministic in sims).  Emitted
            # BEFORE eviction drops the per-txn timestamps.
            if self.event_journal is not None and txns:
                ing = [self._ingest_t[t.hash] for t in txns
                       if t.hash in self._ingest_t]
                adm = [self._admit_t[t.hash] for t in txns
                       if t.hash in self._admit_t]
                if ing and adm:
                    self.event_journal.record(
                        "commit_anatomy", blk=block, stage="pool",
                        count=len(txns),
                        t_first_ingest=round(min(ing), 6),
                        t_last_admit=round(max(adm), 6),
                        ingest_to_admit_s=round(max(adm) - min(ing), 6))
            self._evict(txns)
            if self.event_journal is not None and txns:
                self.event_journal.record("txns_included", blk=block,
                                          count=len(txns))
            if (self.journal_path and
                    self._journal_count > max(64, 4 * len(self._by_hash))):
                self._rotate_journal()

    # -- local-txn journal (ref: core/tx_pool.go newTxJournal) ------------

    def add_locals(self, txns) -> None:  # thread-entry (RPC worker); ingress-entry:bounded
        """Admit locally-submitted txns AND journal them so they survive
        a node restart (remote gossip txns are not journaled).  Only
        FRESH txns journal — resubmitting the same txn N times must not
        grow the file — and a journal that outgrows the live pool 4x
        rotates even on a quiet chain."""
        with self._lock:
            fresh = [t for t in txns if t.hash not in self._known]
            if self.journal_path and fresh:
                import struct

                if self._journal is None:
                    self._journal = open(self.journal_path, "ab")
                for t in fresh:
                    raw = t.encode()
                    self._journal.write(struct.pack("<I", len(raw)) + raw)
                    self._journal_count += 1
                self._journal.flush()
                if self._journal_count > max(64, 4 * (len(self._by_hash)
                                                      + len(fresh))):
                    self._rotate_journal()
            self.add_remotes(txns)

    def load_journal(self) -> int:
        """Re-queue journaled local txns (stale nonces fall out at
        selection); returns how many were loaded.  A torn tail is
        repaired by rewriting the parsed prefix — otherwise every
        append after the tear would be unreadable forever."""
        import os
        import struct

        if not self.journal_path or not os.path.exists(self.journal_path):
            return 0
        with self._lock:
            with open(self.journal_path, "rb") as f:
                data = f.read()
            txns = []
            pos = 0
            good_end = 0
            while pos + 4 <= len(data):
                (n,) = struct.unpack("<I", data[pos : pos + 4])
                if pos + 4 + n > len(data):
                    break  # torn tail
                try:
                    txns.append(
                        Transaction.decode(data[pos + 4 : pos + 4 + n]))
                except Exception:
                    break  # torn/corrupt record: keep the parsed prefix
                pos += 4 + n
                good_end = pos
            if good_end != len(data):
                with open(self.journal_path, "r+b") as f:
                    f.truncate(good_end)
            self._journal_count = len(txns)
            if txns:
                self.add_remotes(txns)
                self._flush()
            return len(txns)

    def _rotate_journal(self) -> None:
        """Rewrite the journal with the still-pending set (a superset of
        the locals — geth rotates locals only; re-journaling a remote is
        harmless and keeps the rotation logic index-free)."""
        import os
        import struct

        if self._journal is not None:
            self._journal.close()
            self._journal = None
        tmp = self.journal_path + ".tmp"
        kept = 0
        with open(tmp, "wb") as f:
            for s, t in self._order:
                if t.hash in self._dead or t.hash not in self._by_hash:
                    continue
                raw = t.encode()
                f.write(struct.pack("<I", len(raw)) + raw)
                kept += 1
        os.replace(tmp, self.journal_path)
        self._journal_count = kept

    def close(self) -> None:
        with self._lock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_hash)
