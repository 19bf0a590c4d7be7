"""The Geec consensus node: one event-loop state machine per node.

The port's copy of ``eges_tpu/consensus/node.py``: vote and body checks
go to the port's verifier scheduler, which runs them on the card when
the cluster hands it the port's ``BatchVerifier``.

This is the TPU-native re-architecture of the reference's goroutine soup
— ``GeecState`` + its four loops (``blockLoop``/``handleVerifyReplies``/
``handleQueryReply``/election ``HandleMessage``, core/geec_state.go:315-318),
the engine's blocking ``Seal`` (consensus/geec/geec.go:282-370) and the
ProtocolManager's worker goroutines (eth/handler.go:897-1056) — collapsed
into ONE single-threaded, non-blocking state machine per node with
injectable clock and transport (SURVEY §7 step 3: "replace the
comment-enforced lock soup with event loops and explicit messages").

Everything the reference does with a blocking wait becomes a timer or a
deferred message:

* ``Wb.Wait(blk)`` (condvar)            -> defer queue drained on advance
* ``Seal`` blocking on election/ACKs    -> proposer phase machine + timers
* ``time.Sleep(backoff)``               -> backoff timer
* ``blockLoop`` select timeout ladder   -> block-timeout timer, 3x
  committee re-election then forced empty block (geec_state.go:1140-1180)

The consensus-critical semantics (versioned retries, vote transfer,
confidence, TTL economy, membership windows) follow the reference
line-for-line in *behavior*; citations sit on each method.

Signature verification is where TPUs enter: acceptors verify a proposed
block's signed txns as one device batch before ACKing (the reference's
acceptor replies unconditionally, ``valResult := true``,
core/geec_state.go:545 — verification actually happening is this build's
north-star upgrade), and the insert path batch-recovers senders
(core/state_processor.go:93's per-tx loop, batched).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from dataclasses import dataclass

from eges_tpu_torch.consensus import messages as M
from eges_tpu_torch.consensus.config import (
    ChainGeecConfig, NodeConfig, calc_confidence, ttl_params,
    CONFIDENCE_THRESHOLD,
)
from eges_tpu_torch.consensus.membership import Member, Membership, derive_seed
from eges_tpu_torch.consensus.working_block import (
    WorkingBlock, ELEC_CANDIDATE, ELEC_ELECTED, ELEC_VOTED,
    WB_CURRENT, WB_FUTURE, WB_PASSED,
)
from eges_tpu_torch.core.chain import BlockChain
from eges_tpu_torch.utils import ledger
from eges_tpu_torch.utils import tracing
from eges_tpu_torch.core.types import (
    Block, ConfirmBlockMsg, Header, QueryBlockMsg, Registration, Transaction,
    fake_txn, EMPTY_ADDR, new_block,
)


def addr_to_int(addr: bytes) -> int:
    """Election tie-break key (ref: election/server.go:122-125)."""
    return (int.from_bytes(addr[0:8], "big") + int.from_bytes(addr[8:16], "big")
            + int.from_bytes(addr[16:20], "big")) % (1 << 64)


# Proposer phases
IDLE, ELECTING, VALIDATING, BACKOFF = range(4)


class GeecNode:
    """One consensus participant.

    Wire-in points: ``transport`` must call :meth:`on_gossip` /
    :meth:`on_direct` for inbound traffic; the chain calls
    :meth:`_on_new_block` via its listener hook.  ``clock`` provides
    ``now()`` and ``call_later(delay_s, fn) -> cancelable handle``.
    """

    # Ingress hardening caps: every attacker-fed byte path or container
    # is bounded up front; overflow is shed oldest-first with a counted
    # ``*_dropped`` metric so floods stay visible, cheap, and non-fatal
    # (cf. geth's message-size limits and fetcher/txpool caps).
    INGRESS_MAX_BYTES = 1 << 20       # one datagram's decode budget
    DEFER_MAX = 4096                  # deferred-thunk queue depth
    GEEC_TXN_MAX_BYTES = 1 << 20      # one UDP txn payload
    GEEC_PENDING_MAX = 1 << 14        # pending UDP txn backlog
    REG_PENDING_MAX = 4096            # pending registration requests
    FASTSYNC_MAX_ACCOUNTS = 1 << 20   # fast-sync state staging rows
    HEIGHT_WINDOW = 8192              # retained per-height bookkeeping

    def __init__(self, chain: BlockChain, clock, transport,
                 node_cfg: NodeConfig, chain_cfg: ChainGeecConfig, *,
                 mine: bool = True, verifier=None, log=None):
        self.chain = chain
        self.clock = clock
        self.transport = transport
        self.cfg = node_cfg
        self.ccfg = chain_cfg
        self.mine = mine
        self.verifier = verifier
        self.coinbase = node_cfg.coinbase
        self._log = log or (lambda *a, **k: None)

        # structured protocol event journal (utils/journal.py): one per
        # node, virtual-time aware, shared with this node's chain /
        # membership / txpool so every control-plane decision lands in
        # one replayable stream
        from eges_tpu_torch.utils.journal import Journal
        self.journal = Journal(node=self.coinbase.hex()[:8],
                               clock=clock.now)
        # ingress provenance ledger (utils/ledger.py): per-origin decayed
        # cost counters charged by every layer this node drives — the
        # entry points below bind it as the ambient charge target, and
        # each committed block journals one ingress_ledger snapshot
        self.ledger = ledger.IngressLedger(clock=clock.now)
        # a VerifierScheduler (crypto/scheduler.py) journals its flush
        # decisions; a cluster-shared scheduler lands in the stream of
        # the FIRST node that adopts it (the device owner's view)
        if verifier is not None and \
                getattr(verifier, "journal", b"") is None:
            verifier.journal = self.journal
        self.elections_won = 0
        self.elections_lost = 0
        self._last_commit_t = clock.now()
        chain.journal = self.journal

        # signed-vote mode (ChainGeecConfig.signed_votes): every election
        # vote / ACK / query reply / confirm carries a secp256k1 signature
        # and quorum tallies run through the device batch verifier —
        # BASELINE config 3's "vote-sig batch verify on TPU"
        self._signing = bool(chain_cfg.signed_votes)
        if self._signing and mine and len(node_cfg.privkey) != 32:
            raise ValueError("signed_votes chain requires a 32-byte privkey")

        tp = ttl_params(node_cfg.total_nodes)
        self.membership = Membership(node_cfg.n_candidates,
                                     node_cfg.n_acceptors, **tp)
        self.membership.journal = self.journal
        # genesis bootstrap membership (ref: geec_state.go:275-289)
        for bn in chain_cfg.bootstrap:
            self.membership.add(Member(addr=bn.account, ip=bn.ip, port=bn.port,
                                       referee=bn.account, joined_block=0,
                                       ttl=tp["initial_ttl"]))

        # One re-entrant monitor guards every mutable consensus field
        # below.  The state machine is single-threaded on the event
        # loop, but the RPC server runs its handlers on another thread
        # and enters through submit_txns / broadcast_txns /
        # request_registration — every entry point (inbound dispatch,
        # chain listener, timer fire, RPC surface) takes this lock, so
        # those two threads serialize.  The attached TxPool shares THIS
        # lock (see the txpool setter) — one lock domain, no ordering
        # hazards between pool window flushes and RPC submissions.
        self._lock = threading.RLock()
        self.wb = WorkingBlock(self.coinbase)
        self.trust_rands: dict[int, int] = {0: 0}
        self.pending_blocks: dict[int, Block] = {}
        self.max_confirmed_block = 0
        self.unconfirmed: list[Block] = []
        self.empty_block_list: list[int] = []
        self.pending_regs: dict[bytes, Registration] = {}
        self.registered = self.coinbase in self.membership
        # deque, not list: the flood path sheds oldest-first and a
        # list.pop(0) there is O(backlog) per shed row.  The cap check
        # stays explicit (no maxlen=) — eviction must bill the ledger
        # and bump the dropped counter, and chaos scenarios retune the
        # cap per instance at runtime.
        self.pending_geec_txns: deque[Transaction] = deque()
        self._proposal_geec_txns: list[Transaction] = []
        self._txn_seen: set[bytes] = set()
        self._sync_target = 0
        self._sync_progress = False
        # fetched-ahead staging: certified blocks beyond the chain's
        # out-of-order window wait here (the downloader queue role,
        # ref: eth/downloader/queue.go — bounded, lowest numbers kept)
        self._sync_stash: dict[int, Block] = {}
        # header-first skeleton (ref: eth/downloader/downloader.go:931):
        # number -> header hash whose quorum certificate batch-verified
        # ahead of its body; bodies hashing onto a pin skip per-reply
        # certificate verification, mismatches drop
        self._sync_skel: dict[int, bytes] = {}
        self._skel_req_upto = 0  # header-request watermark
        # fast-sync (statesync.go role): live download state, one-shot
        # per session — a failed/poisoned attempt falls back to full
        # replay rather than looping against a byzantine serving peer
        self._fs: dict | None = None
        self._fs_done = False
        # serving peers whose pages failed the pivot root check: never
        # re-anchor a download on one (byzantine-server quarantine)
        self._fs_blacklist: set[bytes] = set()
        self._snap_cache: tuple | None = None  # serving-side page cache
        # per-origin token buckets for the snapshot-serving plane, so a
        # flood of StateFetchReqs cannot turn this node into a DoS
        # amplifier; bounded-by: SERVE_TOKENS_MAX (oldest evicted)
        self._serve_tokens: dict[str, tuple[float, float]] = {}
        self.geec_txn_sink = None  # app-layer callback for confirmed geec txns
        self.txpool = None  # optional TxPool; proposals drain it
        #                     (property: attaching one wires the journal)
        # columnar ingest hook (ROADMAP item 5): an injectable
        # txns -> TxColumns extractor (eges_tpu_torch.ingress.columns_of).
        # Injected rather than imported — consensus sits below the
        # ingress package in the layer map — by whatever wires the node
        # (sim/cluster.py, the node runner).  When set, multi-txn
        # gossip bundles admit window-granular via add_remotes_window;
        # singletons keep the legacy per-tx path.
        self.columnarize = None

        # deferred messages for future working blocks (Wait() analogue);
        # deque for the same O(1) oldest-first shedding as above
        self._deferred: deque[tuple[int, object]] = deque()  # (blk_num, thunk)

        # proposer phase state
        self._phase = IDLE
        self._proposal: Block | None = None
        self._proposal_version = 0
        self._validate_req: M.ValidateRequest | None = None
        self._seal_t0 = 0.0
        self._elect_t = 0.0
        self._ack_t = 0.0
        # commit-anatomy phase splits for the in-flight proposal: the
        # election and ack-quorum durations land here when each phase
        # completes, and _finish_seal journals them as ONE
        # ``commit_anatomy`` stage="seal" event so the critical-path
        # assembler (harness/anatomy.py) can segment seal time without
        # re-joining three breakdown spans
        self._election_dt = 0.0
        self._ack_dt = 0.0

        # timers
        self._timers: dict[str, object] = {}
        self._timeout_times = 0

        chain.add_listener(self._on_new_block)
        # restart path: rebuild membership/trust-rand/working-block state
        # from the durable chain (blocks already canonical are final here;
        # the journal stays quiet — replayed history is not live protocol
        # activity and would double-count in the observatory).  When the
        # chain anchored on a root-verified checkpoint sidecar carrying a
        # consensus section, seed the soft state from it and replay only
        # the tail past the anchor — O(tail), not O(chain).  A missing
        # block below an anchorless pivot (fast-synced store) is skipped:
        # the live node never ingested it either.
        self.journal.enabled = False
        anchor = 0
        cons = getattr(chain, "snapshot_consensus", None)
        if cons is not None and getattr(chain, "snapshot_anchor", 0) > 0:
            anchor = chain.snapshot_anchor
            self._seed_from_checkpoint(cons)
        replayed = 0
        for n in range(anchor + 1, chain.height() + 1):
            blk = chain.get_block_by_number(n)
            if blk is None:
                continue
            self._ingest_block(blk, replay=True)
            replayed += 1
        self.journal.enabled = True
        self.max_confirmed_block = chain.height()
        if self.coinbase in self.membership:
            self.registered = True
        if chain.height() > 0:
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            self.journal.record("statesync_restart", blk=chain.height(),
                                snapshot_blk=anchor, replayed=replayed)
            metrics.gauge("statesync.restart_replayed").set(replayed)

    def _seed_from_checkpoint(self, cons: dict) -> None:
        """Re-seed consensus soft state from a checkpoint's consensus
        section.  Existing entries (the genesis bootstrap members added
        above) are overwritten in place — routing them through
        ``Membership.add`` would take its RENEWAL path and stack TTLs
        the live run never granted."""
        for (addr, referee, ip, port, joined, ttl, renewed) in \
                cons.get("members", ()):
            m = self.membership.get(addr)
            if m is None:
                self.membership.add(Member(addr=addr, ip=ip, port=port,
                                           referee=referee,
                                           joined_block=joined, ttl=ttl,
                                           renewed_times=renewed))
                m = self.membership.get(addr)
                if m is None:
                    continue
            m.ip, m.port, m.referee = ip, port, referee
            m.joined_block, m.ttl = joined, ttl
            m.renewed_times = renewed
        self.trust_rands.update(cons.get("trust_rands", ()))
        self.empty_block_list = list(cons.get("empty_blocks", ()))
        # the restored queue stays bounded-by: SYNC_STASH_MAX — a
        # damaged sidecar must not inflate the unconfirmed window
        for n in cons.get("unconfirmed", ()):
            if len(self.unconfirmed) >= self.SYNC_STASH_MAX:
                break
            blk = self.chain.get_block_by_number(n)
            if blk is not None:
                self.unconfirmed.append(blk)
        if cons.get("registered"):
            self.registered = True

    # ------------------------------------------------------------------
    # vote authentication (signed-vote mode)
    # ------------------------------------------------------------------

    def _sign(self, sighash: bytes) -> bytes:
        if not self._signing or len(self.cfg.privkey) != 32:
            return b""
        from eges_tpu_torch.crypto import secp256k1 as host
        return host.ecdsa_sign(sighash, self.cfg.privkey)

    def _verify_single(self, sighash: bytes, sig: bytes,
                       author: bytes) -> bool:
        """One-off signature check (candidacies, proposals, confirms).

        With a VerifierScheduler wired (sim cluster / node service),
        ``recover_signers`` delegates into its cache + coalescing
        window, so a lone check is a cache hit (gossip re-delivery), a
        row in someone else's batch, or one host recover — never the
        padded 1-row device dispatch this path used to cost.  Consensus
        blocks on this check, so it rides the scheduler's high-priority
        window class."""
        if not self._signing:
            return True
        if len(sig) != 65:
            return False
        from eges_tpu_torch.crypto.verify_host import recover_signers
        return recover_signers([(sighash, sig)], self.verifier,
                               priority="consensus")[0] == author

    def _recover_entries(self, entries) -> list:
        """Recover the signer of each ``(author, sighash, sig)`` entry in
        ONE verifier batch (or one scheduler window, where the cache
        strips already-seen votes before the device sees them); per-entry
        result is the claimed author when the signature checks out, else
        None.  With signing off every entry passes.  Election acks and
        QC checks block consensus progress, so the rows enter the
        scheduler's consensus priority class: they flush ahead of bulk
        tx-ingest rows and their windows preempt bulk windows at lane
        placement."""
        if not self._signing:
            return [a for a, _, _ in entries]
        from eges_tpu_torch.crypto.verify_host import recover_signers
        rec = recover_signers([(h, s) for _, h, s in entries], self.verifier,
                              priority="consensus")
        return [a if r == a else None
                for (a, _, _), r in zip(entries, rec)]

    def _verify_quorum(self, entries) -> dict[bytes, bytes]:
        """Quorum tally over possibly-multiple entries per author:
        returns ``{author: verified_sig}`` for every author with at least
        one valid entry (sig is ``b""`` when signing is off)."""
        out: dict[bytes, bytes] = {}
        for (a, _, s), r in zip(entries, self._recover_entries(entries)):
            if r is not None and a not in out:
                out[a] = s if self._signing else b""
        return out

    # ------------------------------------------------------------------
    # timers
    # ------------------------------------------------------------------

    def _set_timer(self, name: str, delay_s: float, fn) -> None:
        self._cancel_timer(name)

        def fire():
            # timer callbacks join the same monitor as the message and
            # RPC entry points; re-entrancy keeps nested arming from
            # already-locked regions cheap
            with self._lock:
                fn()

        self._timers[name] = self.clock.call_later(delay_s, fire)

    def _cancel_timer(self, name: str) -> None:
        h = self._timers.pop(name, None)
        if h is not None:
            h.cancel()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            self._arm_block_timeout()
            if self.mine:
                if not self.registered:
                    self._start_registration(renew=0)
                self._try_propose()

    def stop(self) -> None:
        with self._lock:
            for name in list(self._timers):
                self._cancel_timer(name)

    def _breakdown(self, phase: str, dt: float, **kw) -> None:
        """One phase timing, three sinks: the legacy ``[Breakdown]`` log
        line (only under --breakdown, so grep.py-style harvesting keeps
        working), a percentile histogram, and a finished span."""
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.histogram(f"consensus.phase_seconds;phase={phase}").observe(dt)
        tracing.DEFAULT.record_span(f"consensus.{phase}", dt,
                                    node=self.coinbase.hex()[:8], **kw)
        if self.cfg.breakdown:
            self._log("breakdown", phase=phase, dt=dt, **kw)

    def _bump_version(self, version: int) -> None:
        """Single funnel for version bumps so the journal sees every
        failed round (the observatory's failed-round rate counts
        these).  version 0 is the normal first attempt of a block, not
        a failed round — it stays out of the journal."""
        self.wb.bump_version(version)
        if version > 0:
            self.journal.record("version_bump", blk=self.wb.blk_num,
                                version=version)

    @property
    def txpool(self):
        return self._txpool

    @txpool.setter
    def txpool(self, pool) -> None:
        self._txpool = pool
        if pool is not None:
            pool.event_journal = self.journal
            # one lock domain for node + pool: the RPC thread holds the
            # node lock through submit_txns -> add_locals while the
            # clock thread's window flush re-enters the node through the
            # on_admitted broadcast hook — two separate locks would be
            # taken in opposite orders on those paths (deadlock); one
            # shared re-entrant lock serializes both.
            pool._lock = self._lock

    # ------------------------------------------------------------------
    # inbound dispatch
    # ------------------------------------------------------------------

    def on_gossip(self, data: bytes) -> None:  # ingress-entry
        ctx, data = tracing.extract(data)
        # ingress provenance: every cost this datagram incurs (pool
        # admits/rejects, verifier rows, deferred/duplicate drops) bills
        # to the delivering peer stamped by the transport fabric
        src = ledger.current_peer()
        with self._lock, tracing.DEFAULT.activate(ctx), \
                ledger.bind(self.ledger, f"peer:{src}" if src else "net"):
            self._on_gossip(data)

    def _on_gossip(self, data: bytes) -> None:
        if len(data) > self.INGRESS_MAX_BYTES:
            # decode budget enforced before ANY byte is parsed: an
            # oversized datagram costs one length check, billed to its
            # origin, and never reaches RLP (DoS-resistance contract)
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            metrics.counter("consensus.ingress_oversized").inc()
            ledger.charge(drops=1)
            self._log("oversized gossip dropped", nbytes=len(data))
            return
        if not self._state_reply_fits(data):
            return
        try:
            code, msg = M.unpack_gossip(data)
        except Exception as exc:
            # malformed datagram from a peer must not kill the loop
            self._log("malformed gossip", nbytes=len(data), err=repr(exc))
            return
        try:
            self._dispatch_gossip(code, msg)
        except Exception as exc:
            # a datagram that unpacks but whose payload fails deeper
            # decode/auth (bit-flip corruption) is a peer-supplied input:
            # reject it, never crash the node (DoS-resistance contract)
            self._log("gossip handler rejected", code=code, err=repr(exc))

    def _dispatch_gossip(self, code: int, msg) -> None:
        if code == M.GOSSIP_VALIDATE_REQ:
            self._handle_validate_request(msg)
        elif code == M.GOSSIP_QUERY:
            self._handle_query(msg)
        elif code == M.GOSSIP_REGISTER_REQ:
            self._append_reg_req(msg)
        elif code == M.GOSSIP_CONFIRM_BLOCK:
            self._handle_confirm(msg)
        elif code == M.GOSSIP_GET_BLOCKS:
            self._serve_block_fetch(msg)
        elif code == M.GOSSIP_BLOCKS_REPLY:
            self._handle_blocks_reply(msg)
        elif code == M.GOSSIP_GET_HEADERS:
            self._serve_header_fetch(msg)
        elif code == M.GOSSIP_HEADERS_REPLY:
            self._handle_headers_reply(msg)
        elif code == M.GOSSIP_GET_STATE:
            self._serve_state_fetch(msg)
        elif code == M.GOSSIP_STATE_REPLY:
            # gossip replies carry no authenticated author; the pinned
            # server check in the handler accepts them only when they
            # answer the cursor this node actually asked for
            self._handle_state_chunk(msg, author=b"")
        elif code == M.GOSSIP_TXNS:
            self._handle_txns(msg)

    def on_direct(self, data: bytes) -> None:  # ingress-entry
        ctx, data = tracing.extract(data)
        src = ledger.current_peer()
        with self._lock, tracing.DEFAULT.activate(ctx), \
                ledger.bind(self.ledger, f"peer:{src}" if src else "net"):
            self._on_direct(data)

    def _on_direct(self, data: bytes) -> None:
        if len(data) > self.INGRESS_MAX_BYTES:
            # same decode budget as the gossip plane
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            metrics.counter("consensus.ingress_oversized").inc()
            ledger.charge(drops=1)
            self._log("oversized direct dropped", nbytes=len(data))
            return
        if not self._state_reply_fits(data):
            return
        try:
            code, author, msg = M.unpack_direct(data)
        except Exception as exc:
            # malformed/unauthenticated datagram: drop, but leave a trace
            self._log("malformed direct", nbytes=len(data), err=repr(exc))
            return
        try:
            self._dispatch_direct(code, msg, author)
        except Exception as exc:
            # same contract as the gossip plane: corrupted-but-unpackable
            # payloads get rejected by the handler, not fatal
            self._log("direct handler rejected", code=code, err=repr(exc))

    def _state_reply_fits(self, data: bytes) -> bool:
        """Pre-decode byte cap for state-sync replies: a state page is
        the one message class whose legitimate size dwarfs every other
        frame, so the global INGRESS_MAX_BYTES budget would let a
        byzantine server feed ~1 MiB of junk per datagram into the RLP
        decoder.  Peek ONLY the leading message code (no body decode)
        and drop oversized state replies before any account parses;
        bounded-by: STATE_REPLY_MAX_BYTES."""
        if len(data) <= self.STATE_REPLY_MAX_BYTES:
            return True
        from eges_tpu_torch.core import rlp as rlp_mod
        code = rlp_mod.peek_first_uint(data)
        if code in (M.GOSSIP_STATE_REPLY, M.UDP_STATE):
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            metrics.counter("statesync.oversized_reply").inc()
            ledger.charge(drops=1)
            self._log("oversized state reply dropped", nbytes=len(data))
            return False
        return True

    def _dispatch_direct(self, code: int, msg, author: bytes = b"") -> None:
        if code == M.UDP_ELECT:
            self._handle_elect_message(msg)
        elif code == M.UDP_EXAMINE_REPLY:
            self._handle_validate_reply(msg)
        elif code == M.UDP_QUERY_REPLY:
            self._handle_query_reply(msg)
        elif code == M.UDP_BLOCKS:
            self._handle_blocks_reply(msg)
        elif code == M.UDP_GET_BLOCKS:
            self._serve_block_fetch(msg)
        elif code == M.UDP_GET_HEADERS:
            self._serve_header_fetch(msg)
        elif code == M.UDP_HEADERS:
            self._handle_headers_reply(msg)
        elif code == M.UDP_GET_STATE:
            self._serve_state_fetch(msg)
        elif code == M.UDP_STATE:
            self._handle_state_chunk(msg, author=author)

    def on_geec_txn(self, payload: bytes) -> None:  # ingress-entry
        """UDP txn ingest (ref: consensus/geec/geec_api.go:28-41)."""
        from eges_tpu_torch.core.types import geec_txn
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        if len(payload) > self.GEEC_TXN_MAX_BYTES:
            metrics.counter("consensus.geec_txn_dropped").inc()
            ledger.charge(drops=1)
            return
        with self._lock:
            if len(self.pending_geec_txns) >= self.GEEC_PENDING_MAX:
                # backlog full: shed the oldest so a txn flood cannot
                # pin memory ahead of the next proposal drain — O(1)
                # on the deque even at flood scale
                self.pending_geec_txns.popleft()
                metrics.counter("consensus.geec_txn_dropped").inc()
                ledger.charge(drops=1)
            self.pending_geec_txns.append(geec_txn(payload))

    # defer a thunk until the working block reaches ``blk`` (Wait analogue)
    def _defer(self, blk: int, thunk) -> None:
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        if len(self._deferred) >= self.DEFER_MAX:
            # depth cap: a peer stuffing far-future waits evicts the
            # oldest deferral instead of growing the queue unboundedly
            self._deferred.popleft()
            metrics.counter("consensus.deferred_dropped").inc()
            ledger.charge(drops=1)
        self._deferred.append((blk, thunk))
        # a deferred message is buffered work the sender imposed on us —
        # billed to the ambient ingress origin (no-op on internal paths)
        ledger.charge(deferred=1)
        metrics.gauge("consensus.deferred_depth").set(len(self._deferred))

    def _drain_deferred(self) -> None:
        ready = [(b, t) for (b, t) in self._deferred if b <= self.wb.blk_num]
        self._deferred = deque((b, t) for (b, t) in self._deferred
                               if b > self.wb.blk_num)
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.gauge("consensus.deferred_depth").set(len(self._deferred))
        if ready:
            self.journal.record("deferred_drain", blk=self.wb.blk_num,
                                drained=len(ready))
        for b, t in ready:
            if b == self.wb.blk_num:
                t()

    # ------------------------------------------------------------------
    # trust rand / committee helpers
    # ------------------------------------------------------------------

    def seed_for(self, blk_num: int) -> int | None:
        """Committee seed for height ``blk_num`` = TrustRand(blk_num-1).
        The reference stubs GetTrustRand to return the block number
        (core/geec_state.go:156-171); here the real header-recorded rand
        is used — the stub's determinism comes from the simulator's
        seeded PRNGs instead."""
        return self.trust_rands.get(blk_num - 1)

    def is_committee(self, blk_num: int, version: int = 0) -> bool:
        seed = self.seed_for(blk_num)
        if seed is None:
            return False
        return self.membership.is_committee(self.coinbase, seed, version)

    def is_acceptor(self, blk_num: int) -> bool:
        seed = self.seed_for(blk_num)
        if seed is None:
            return False
        return self.membership.is_acceptor(self.coinbase, seed)

    # ------------------------------------------------------------------
    # proposer pipeline (the event-driven Seal, ref: geec.go:282-370)
    # ------------------------------------------------------------------

    def _try_propose(self, version: int = 0) -> None:
        if not self.mine or self._phase != IDLE:
            return
        h = self.wb.blk_num
        if not self.is_committee(h, version):
            return  # ErrNoCommittee path (geec.go:262): stay follower
        self._seal_t0 = self.clock.now()
        self._start_election(h, version)

    def _start_election(self, blk_num: int, version: int) -> None:
        """(ref: ElectForProposer geec_state.go:606-651 + Elect
        election_go.go:37-175)"""
        wb = self.wb
        if blk_num != wb.blk_num:
            return
        seed = self.seed_for(blk_num)
        committee = self.membership.committee(seed, version)
        if version > wb.max_version:
            self._bump_version(version)
        elif wb.elect_state == ELEC_VOTED:
            return  # already voted on this version (election_go.go:56-59)
        wb.n_candidates = len(committee)
        wb.election_threshold = self.membership.election_threshold(len(committee))
        self._phase = ELECTING
        self._proposal_version = version
        self._elect_t = self.clock.now()
        self.journal.record("election_started", blk=blk_num, version=version,
                            committee=len(committee),
                            threshold=wb.election_threshold)
        self._election_retry(blk_num, version, committee, retry=0)

    def _election_retry(self, blk_num: int, version: int, committee,
                        retry: int) -> None:
        wb = self.wb
        if (blk_num != wb.blk_num or wb.max_version > version
                or wb.elect_state == ELEC_VOTED):
            self._abort_proposal()
            return
        if (len(wb.supporters) >= wb.election_threshold
                and self._on_elected()):
            return
        em = M.ElectMessage(code=M.MSG_ELECT, block_num=blk_num,
                            author=self.coinbase, rand=wb.my_rand,
                            version=version, retry=retry,
                            ip=self.cfg.consensus_ip,
                            port=self.cfg.consensus_port)
        em = dataclasses.replace(em, sig=self._sign(em.signing_hash()))
        payload = M.pack_direct(M.UDP_ELECT, self.coinbase, em)
        for m in committee:
            if m.addr == self.coinbase:
                continue  # never to self (election_go.go:83)
            self.transport.send_direct(m.ip, m.port, payload)
        # 1 s retry loop (election_go.go:150)
        self._set_timer("election", 1.0,
                        lambda: self._election_retry(blk_num, version,
                                                     committee, retry + 1))

    def _on_elected(self) -> bool:
        """Threshold of votes reached -> verify the vote signatures as one
        device batch, then build + broadcast the proposal.  Returns False
        (election continues) if pruning forged votes drops the count back
        below the threshold."""
        wb = self.wb
        if self._phase != ELECTING:
            return False
        if self._signing:
            items = [(a, h, s) for a in wb.supporters
                     for (h, s) in wb.supporter_votes.get(a, ())]
            valid = self._verify_quorum(items)
            for a in list(wb.supporters):
                if a not in valid:
                    wb.supporters.discard(a)
                    wb.supporter_votes.pop(a, None)
            if len(wb.supporters) < wb.election_threshold:
                return False
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.counter("consensus.elected").inc()
        wb.elect_state = ELEC_ELECTED
        wb.is_proposer = True
        wb.validate_threshold = self.membership.validate_threshold()
        self._cancel_timer("election")
        dt = self.clock.now() - self._elect_t
        self._breakdown("election", dt, blk=wb.blk_num)
        self._election_dt = dt
        self.elections_won += 1
        self.journal.record("election_won", blk=wb.blk_num,
                            version=self._proposal_version, dt=dt,
                            votes=len(wb.supporters))
        if self._proposal_version > 0:
            # recovered leader: query what happened first
            self._start_query(wb.blk_num, self._proposal_version)
            return True
        self._build_and_validate(wb.blk_num, self._proposal_version)
        return True

    def _build_proposal(self, blk_num: int) -> Block:
        """Assemble header+body (ref: Prepare geec.go:228-264 + Seal's txn
        attachment geec.go:319-339 + Finalize geec.go:268-279)."""
        parent = self.chain.head()
        regs = tuple(self.pending_regs[a] for a in
                     sorted(self.pending_regs)[: self.ccfg.max_reg_per_blk])
        n = min(len(self.pending_geec_txns), self.cfg.txn_per_block)
        geec_txns = tuple(self.pending_geec_txns.popleft()
                          for _ in range(n))
        # remember the drained txns so an aborted proposal re-queues them
        # instead of silently dropping UDP-ingested transactions
        self._proposal_geec_txns = list(geec_txns)
        fakes = tuple(fake_txn(self.cfg.txn_size, seq=i)
                      for i in range(self.cfg.txn_per_block - n))
        # signed txns execute: dry-run them on the head state for the
        # header's state/receipt/gas commitments (L3; worker.go:463-467)
        txs = (tuple(self.txpool.pending_txns(
            self.cfg.txn_per_block, state=self.chain.head_state()))
               if self.txpool is not None else ())
        # the header's time/difficulty are fixed BEFORE the preview so
        # the dry-run executes with the exact BlockCtx validation will
        # re-derive from the sealed header (TIMESTAMP/DIFFICULTY reads
        # must see the same values, or the state root won't reproduce)
        difficulty = 100
        blk_time = max(int(self.clock.now()), parent.header.time + 1)
        if txs:
            from eges_tpu_torch.core.evm import BlockCtx
            ctx = BlockCtx(coinbase=self.coinbase, number=blk_num,
                           time=blk_time, difficulty=difficulty)
            txs, root, receipt_hash, gas_used, bloom = \
                self.chain.execute_preview(txs, self.coinbase, ctx=ctx)
        else:
            from eges_tpu_torch.core.trie import EMPTY_ROOT
            root, receipt_hash, gas_used = (parent.header.root, EMPTY_ROOT, 0)
            bloom = bytes(256)
        header = Header(
            parent_hash=parent.hash, number=blk_num,
            coinbase=self.coinbase, difficulty=difficulty,
            time=blk_time,
            root=root, receipt_hash=receipt_hash, gas_used=gas_used,
            bloom=bloom, regs=regs,
            trust_rand=self.wb._rng.getrandbits(64),  # seed for NEXT block
        )
        return new_block(header, txs=txs, geec_txns=geec_txns,
                         fake_txns=fakes)

    def _build_and_validate(self, blk_num: int, version: int) -> None:
        if blk_num != self.wb.blk_num:
            self._abort_proposal()
            return
        self._proposal = self._build_proposal(blk_num)
        self.journal.record("proposal_built", blk=blk_num, version=version,
                            txns=len(self._proposal.transactions),
                            geec_txns=len(self._proposal.geec_txns))
        req = M.ValidateRequest(
            block_num=blk_num, author=self.coinbase, block=self._proposal,
            ip=self.cfg.consensus_ip, port=self.cfg.consensus_port,
            retry=0, version=version,
            empty_list=tuple(self.empty_block_list),
        )
        req = dataclasses.replace(req, sig=self._sign(req.signing_hash()))
        self._ask_for_ack(req)

    def _ask_for_ack(self, req: M.ValidateRequest) -> None:
        """(ref: AskForAck geec.go:373-419 — gossip the full block, retry
        on validate_timeout with bumped retry counter)"""
        self._phase = VALIDATING
        self._validate_req = req
        self.wb.validate_replies.clear()
        self.wb.validate_cert = {}
        self.wb.validate_succeeded = False
        self._ack_t = self.clock.now()
        self.journal.record("validate_request", blk=req.block_num,
                            version=req.version,
                            threshold=self.wb.validate_threshold)
        self._validate_retry(req.block_num, req.version, 0)

    def _validate_retry(self, blk_num: int, version: int, retry: int) -> None:
        if blk_num != self.wb.blk_num or self._phase != VALIDATING:
            return
        if retry > 0:
            self.journal.record("validate_retry", blk=blk_num,
                                version=version, retry=retry)
        req = dataclasses.replace(self._validate_req, retry=retry)
        self.transport.gossip(M.pack_gossip(M.GOSSIP_VALIDATE_REQ, req))
        self._set_timer("validate", self.ccfg.validate_timeout_ms / 1e3,
                        lambda: self._validate_retry(blk_num, version,
                                                     retry + 1))

    def _handle_validate_reply(self, reply: M.ValidateReply) -> None:
        """Tally ACKs (ref: handleVerifyReplies geec_state.go:1184-1227).

        Only replies from the seeded acceptor window for this height may
        count toward the quorum (the reference gates acceptor identity via
        IsValidator on the reply path, geec_state.go:439-521) — otherwise
        a single peer could fabricate a validate quorum."""
        wb = self.wb
        if reply.block_num != wb.blk_num:
            return
        seed = self.seed_for(reply.block_num)
        if seed is None or not self.membership.is_acceptor(reply.author, seed):
            return
        # backfilled empty blocks ride the same certification gate as the
        # sync plane — an unverified reply must not inject history
        fills = (self._filter_certified(list(reply.fill_blocks))
                 if self._signing else reply.fill_blocks)
        for blk in fills:
            self.chain.offer(blk)
        if not reply.accepted:
            return  # an explicit NACK never counts toward the quorum
        if (self._proposal is not None
                and reply.block_hash != self._proposal.hash):
            return  # an ACK binds a specific block; not ours -> not ours
        # up to 2 distinct stored replies per author (spoof-squat defense)
        lst = wb.validate_replies.setdefault(reply.author, [])
        if len(lst) < 2 and all(r.sig != reply.sig for r in lst):
            lst.append(reply)
        if (len(wb.validate_replies) >= wb.validate_threshold
                and not wb.validate_succeeded and self._phase == VALIDATING):
            if self._signing:
                # the config-3 batch point: recover every collected ACK
                # signature in ONE device call, prune forgeries, and only
                # then trip the quorum.  The verified signatures become
                # the confirm's quorum certificate.
                items = [(r.author, r.signing_hash(), r.sig)
                         for rl in wb.validate_replies.values() for r in rl]
                cert = self._verify_quorum(items)
                for a in list(wb.validate_replies):
                    if a not in cert:
                        del wb.validate_replies[a]
                if len(wb.validate_replies) < wb.validate_threshold:
                    return  # keep collecting; retry loop re-solicits
                wb.validate_cert = cert
            wb.validate_succeeded = True
            self._cancel_timer("validate")
            dt = self.clock.now() - self._ack_t
            self._breakdown("ack", dt, blk=wb.blk_num)
            self._ack_dt = dt
            self.journal.record("validate_quorum", blk=wb.blk_num, dt=dt,
                                acks=len(wb.validate_replies))
            self._phase = BACKOFF
            supporters = tuple(wb.validate_replies.keys())
            self._set_timer("backoff", self.ccfg.backoff_time_ms / 1e3,
                            lambda: self._finish_seal(supporters))

    def _finish_seal(self, supporters: tuple[bytes, ...]) -> None:
        """Confirm + self-insert + broadcast (ref: Seal tail geec.go:356-368
        + worker.wait/minedBroadcastLoop eth/handler.go:1183-1209)."""
        block = self._proposal
        if block is None or block.number != self.wb.blk_num:
            self._abort_proposal()
            return
        parent = self.chain.head()
        parent_conf = parent.confirm.confidence if parent.confirm else 0
        confirm = ConfirmBlockMsg(
            block_number=block.number, hash=block.hash,
            confidence=calc_confidence(parent_conf), supporters=supporters,
            empty_block=False,
            supporter_sigs=tuple(self.wb.validate_cert.get(a, b"")
                                 for a in supporters)
            if self._signing else ())
        confirm = dataclasses.replace(confirm,
                                      sig=self._sign(confirm.signing_hash()))
        sealed = block.with_confirm(confirm)
        self._phase = IDLE
        self._proposal = None
        self._proposal_geec_txns = []  # included in the sealed block
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.counter("consensus.sealed").inc()
        seal_s = self.clock.now() - self._seal_t0
        self._breakdown("seal_total", seal_s, blk=block.number)
        # commit-anatomy seal stage: the proposer-side phase split of
        # this block's seal, on the virtual clock.  t_seal_start lets
        # the assembler place the segment absolutely; election/ack are
        # the measured sub-phases, the remainder is build/backoff.
        self.journal.record(
            "commit_anatomy", blk=block.number, stage="seal",
            t_seal_start=round(self._seal_t0, 6),
            seal_s=round(seal_s, 6),
            election_s=round(self._election_dt, 6),
            ack_s=round(self._ack_dt, 6))
        self.chain.offer(sealed)  # our own insert funnel
        self.transport.gossip(M.pack_gossip(M.GOSSIP_CONFIRM_BLOCK, confirm))

    def _abort_proposal(self) -> None:
        if self._phase != IDLE:
            # only a live proposal attempt journals an abort — the
            # belt-and-braces calls on every block ingest would be noise
            self.journal.record("proposal_aborted", blk=self.wb.blk_num,
                                phase=self._phase)
        self._phase = IDLE
        self._proposal = None
        drained = getattr(self, "_proposal_geec_txns", None)
        if drained:
            # an aborted proposal returns its geec txns to the front of
            # the queue; duplicates vs a block that actually included
            # them are removed again at ingest time
            self.pending_geec_txns.extendleft(reversed(drained))
        self._proposal_geec_txns = []
        self._cancel_timer("election")
        self._cancel_timer("validate")
        self._cancel_timer("backoff")
        self._cancel_timer("query")

    # ------------------------------------------------------------------
    # election message handling (ref: handleElectMessage
    # election_go.go:178-310)
    # ------------------------------------------------------------------

    def _handle_elect_message(self, em: M.ElectMessage) -> None:
        wb = self.wb
        verdict = wb.classify(em.block_num)
        if verdict == WB_PASSED:
            return
        if verdict == WB_FUTURE:
            self._defer(em.block_num, lambda: self._handle_elect_message(em))
            return
        if wb.max_version > em.version:
            return  # old version (election_go.go:205)
        # Elections are a committee-only protocol: both candidacies and
        # votes must come from the seeded committee window for this
        # height/version, or one outside peer could seed itself as
        # delegator / fabricate an election quorum.
        seed = self.seed_for(em.block_num)
        if (seed is None
                or not self.membership.is_committee(em.author, seed,
                                                    em.version)):
            return
        if wb.max_version < em.version:
            self._bump_version(em.version)
            if self._phase in (ELECTING, VALIDATING):
                self._abort_proposal()

        if em.code == M.MSG_ELECT:
            # a forged candidacy would steal this node's vote — verify
            # the candidate's signature before voting for it
            if not self._verify_single(em.signing_hash(), em.sig, em.author):
                return
            if wb.elect_state == ELEC_CANDIDATE:
                if (wb.my_rand > em.rand
                        or (wb.my_rand == em.rand
                            and addr_to_int(self.coinbase) > addr_to_int(em.author))):
                    return  # I have the larger rand — ignore
                wb.elect_state = ELEC_VOTED
                wb.delegator = em.author
                wb.delegator_ip = em.ip
                wb.delegator_port = em.port
                if self._phase == ELECTING:
                    # we were campaigning and a larger rand beat us
                    self.elections_lost += 1
                    self.journal.record("election_lost", blk=em.block_num,
                                        version=em.version,
                                        winner=em.author.hex()[:8])
                    self._abort_proposal()
                self._vote(em.block_num, em.ip, em.port, em.version)
            elif wb.elect_state == ELEC_VOTED:
                # re-vote on delegator retry or after two extra rounds
                if (em.author == wb.delegator
                        or em.retry > wb.max_election_retry + 1):
                    self._vote(em.block_num, wb.delegator_ip,
                               wb.delegator_port, em.version)
                    wb.max_election_retry = em.retry
        elif em.code == M.MSG_VOTE:
            # votes are stashed with their signatures and batch-verified
            # when the threshold is reached (_on_elected)
            if wb.elect_state == ELEC_CANDIDATE or self._phase == ELECTING:
                wb.supporters.add(em.author)
                self._stash_vote(em)
                if (len(wb.supporters) >= wb.election_threshold
                        and self._phase == ELECTING):
                    self._on_elected()
            elif wb.elect_state == ELEC_VOTED:
                # vote transfer: forward the original author's vote with
                # its original signature (the signed fields exclude
                # transport details, so the signature stays valid)
                wb.supporters.add(em.author)
                self._stash_vote(em)
                fwd = M.ElectMessage(code=M.MSG_VOTE, block_num=em.block_num,
                                     author=em.author, rand=em.rand,
                                     version=em.version,
                                     ip=self.cfg.consensus_ip,
                                     port=self.cfg.consensus_port,
                                     sig=em.sig)
                self.transport.send_direct(
                    wb.delegator_ip, wb.delegator_port,
                    M.pack_direct(M.UDP_ELECT, self.coinbase, fwd))

    def _stash_vote(self, em: M.ElectMessage) -> None:
        """Keep up to 2 distinct (sighash, sig) entries per claimed voter
        so a spoofed garbage-sig vote can neither squat the slot nor
        overwrite the genuine signature before the tally verifies."""
        lst = self.wb.supporter_votes.setdefault(em.author, [])
        entry = (em.signing_hash(), em.sig)
        if len(lst) < 2 and entry not in lst:
            lst.append(entry)
            self.journal.record("vote_stashed", blk=em.block_num,
                                version=em.version,
                                voter=em.author.hex()[:8])

    def _vote(self, blk_num: int, ip: str, port: int, version: int) -> None:
        """(ref: vote election_go.go:312-340)"""
        self.journal.record("vote_cast", blk=blk_num, version=version)
        reply = M.ElectMessage(code=M.MSG_VOTE, block_num=blk_num,
                               author=self.coinbase, version=version,
                               ip=self.cfg.consensus_ip,
                               port=self.cfg.consensus_port)
        reply = dataclasses.replace(reply,
                                    sig=self._sign(reply.signing_hash()))
        self.transport.send_direct(ip, port,
                                   M.pack_direct(M.UDP_ELECT, self.coinbase,
                                                 reply))

    # ------------------------------------------------------------------
    # acceptor side: validate requests (ref: HandleValidateRequest
    # eth/handler.go:1000-1056 + Validate geec_state.go:528-591)
    # ------------------------------------------------------------------

    def _handle_validate_request(self, req: M.ValidateRequest) -> None:
        wb = self.wb
        verdict = wb.classify(req.block_num)
        if verdict == WB_PASSED:
            return
        if verdict == WB_FUTURE:
            self._defer(req.block_num,
                        lambda: self._handle_validate_request(req))
            return
        if req.version < wb.max_version:
            return
        # Only the elected proposer — a committee member for this
        # height/version — may ask for ACKs; gate before relaying or
        # stashing the block so an unauthenticated peer cannot seed
        # pending_blocks with crafted blocks.
        seed = self.seed_for(req.block_num)
        if (seed is None
                or not self.membership.is_committee(req.author, seed,
                                                    req.version)):
            return
        # the proposal itself must be signed by the claimed proposer
        if not self._verify_single(req.signing_hash(), req.sig, req.author):
            return
        if req.version > wb.max_version:
            self._bump_version(req.version)
        if req.retry <= wb.max_validate_retry:
            return  # already relayed/answered this retry round
        # gossip-relay with dedup (handler.go:1025-1037)
        self.transport.gossip(M.pack_gossip(M.GOSSIP_VALIDATE_REQ, req))
        if req.block.number > self.max_confirmed_block:
            self.pending_blocks[req.block.number] = req.block
        wb.max_validate_retry = req.retry

        if not self.is_acceptor(req.block_num):
            return
        accepted = self._validate_block(req.block)
        if not accepted:
            self._log("reject", blk=req.block_num)
            self.journal.record("validate_reply", blk=req.block_num,
                                version=req.version, accepted=False)
            return
        self.journal.record("validate_reply", blk=req.block_num,
                            version=req.version, accepted=True)
        fills = []
        for n in req.empty_list:  # backfill requested empties
            b = self.chain.get_block_by_number(n)
            if b is not None:
                fills.append(b)
        reply = M.ValidateReply(block_num=req.block_num, author=self.coinbase,
                                accepted=True, retry=req.retry,
                                fill_blocks=tuple(fills),
                                block_hash=req.block.hash)
        reply = dataclasses.replace(reply,
                                    sig=self._sign(reply.signing_hash()))
        self.transport.send_direct(
            req.ip, req.port,
            M.pack_direct(M.UDP_EXAMINE_REPLY, self.coinbase, reply))

    def _validate_block(self, block: Block) -> bool:
        """Acceptor-side block check.  The reference ACKs unconditionally
        (``valResult := true``, geec_state.go:545); here the full insert
        validation runs BEFORE ACKing: ancestry, tx root, batched sender
        recovery on device, and the state/receipt/gas commitments — the
        capability BASELINE.json targets."""
        return self.chain.validate_candidate(block)

    # ------------------------------------------------------------------
    # confirm handling (ref: eth/handler.go:785-871)
    # ------------------------------------------------------------------

    # accept confirm effects only this far ahead of our head: a forged
    # confirm with a huge block_number must not wedge max_confirmed_block
    # (confirms are unauthenticated gossip until the signed-vote layer)
    CONFIRM_WINDOW = 256

    def _handle_confirm(self, confirm: ConfirmBlockMsg) -> None:
        if confirm.block_number <= self.max_confirmed_block:
            return
        if confirm.block_number > self.chain.height() + self.CONFIRM_WINDOW:
            # too far ahead to act on: if it's real we are badly behind —
            # sync first (rate-limited), and let later confirms land
            # normally once the gap closes; if forged, nothing was harmed
            self._request_backfill(confirm.block_number)
            return
        if self._signing and not self._confirm_ok(confirm):
            return
        if confirm.empty_block:
            for n in sorted(self.pending_blocks):
                if n <= confirm.block_number:
                    # an empty confirm vouches for no pending hash below
                    # it; dropped pendings are healed by backfill
                    del self.pending_blocks[n]
            if self.chain.height() == confirm.block_number - 1:
                empty = self.chain.make_empty_block().with_confirm(confirm)
                self.chain.offer(empty)
        else:
            # A confirm vouches for exactly one suffix: walk parent_hash
            # back from the confirmed hash and apply only pending blocks
            # on that path (cf. the hash check on the query path,
            # geec_state.go:1370).  A losing proposal stashed at a lower
            # height — e.g. confirm(N+1) arriving before confirm(N) while
            # a competing block is pending at N — must never be inserted:
            # it would wedge the chain under an 'unknown ancestor' that
            # backfill cannot displace.
            chained: dict[int, Block] = {}
            want = confirm.hash
            n = confirm.block_number
            while n > 0:
                blk = self.pending_blocks.get(n)
                if blk is None or blk.hash != want:
                    break
                chained[n] = blk
                want = blk.header.parent_hash
                n -= 1
            for n in list(self.pending_blocks):
                if n <= confirm.block_number:
                    del self.pending_blocks[n]
            # every block on the vouched suffix gets the confirm stamped,
            # ancestors included — the reference attaches the same
            # ConfirmMessage to all pendings it pops (eth/handler.go:
            # 785-871), and downstream consumers (replace_suffix's
            # "replacements must be confirmed", TTL rewards) rely on a
            # non-None confirm
            for n in sorted(chained):
                self.chain.offer(chained[n].with_confirm(confirm))
        self.max_confirmed_block = confirm.block_number
        self.journal.record("block_confirmed", blk=confirm.block_number,
                            empty=confirm.empty_block,
                            confidence=confirm.confidence)
        # unconditional re-broadcast; loop broken by max_confirmed gate
        self.transport.gossip(M.pack_gossip(M.GOSSIP_CONFIRM_BLOCK, confirm))
        behind = self.chain.height() < confirm.block_number
        local = self.chain.get_block_by_number(confirm.block_number)
        forked = (not confirm.empty_block and local is not None
                  and local.hash != confirm.hash)
        if behind or forked:
            # a fork at (or below) our head needs a target beyond our
            # height or the sync tick would no-op before the overlapping
            # request can expose the fork point to replace_suffix
            target = confirm.block_number + (0 if behind else 1)
            self._request_backfill(target)

    def _confirm_cert_entries(self, confirm: ConfirmBlockMsg):
        """Reconstruct the per-supporter signing hashes of a confirm's
        quorum certificate, or None if structurally invalid.

        ``version == 0``: supporters signed ACKs (ValidateReply sighash,
        which binds height + acceptor + the exact block hash).
        ``version > 0``: supporters signed query replies for the
        timeout-recovery outcome.  Receivers can therefore re-verify the
        quorum with NO trust in the proposer — the upgrade over the
        reference's trustedHW assumption (and over a single-member
        signature, which one malicious member could mint alone)."""
        sups, sigs = confirm.supporters, confirm.supporter_sigs
        if (len(sups) != len(sigs) or len(set(sups)) != len(sups)
                or len(sups) < self.membership.validate_threshold()):
            return None
        entries = []
        for a, s in zip(sups, sigs):
            if confirm.version == 0:
                h = M.ValidateReply(block_num=confirm.block_number, author=a,
                                    accepted=True,
                                    block_hash=confirm.hash).signing_hash()
            else:
                h = M.QueryReply(
                    block_num=confirm.block_number, author=a,
                    version=confirm.version, empty=confirm.empty_block,
                    block_hash=bytes(32) if confirm.empty_block
                    else confirm.hash).signing_hash()
            entries.append((a, h, s))
        return entries

    def _confirm_ok(self, confirm: ConfirmBlockMsg) -> bool:
        """Signed-vote mode: a gossiped confirm is accepted only with a
        valid quorum certificate (>= validate_threshold verified
        supporter signatures; acceptor-window-checked when the seed for
        that height is known) AND a member signature from its proposer
        (binds the confidence/supporter packaging to a member key).

        The threshold is evaluated against membership as currently known.
        A syncing node's membership starts at the genesis bootstrap list
        and grows in step with the blocks it applies, so historical certs
        meet the as-of-then threshold; the one rough edge is a live
        confirm racing a threshold-raising membership change, which the
        timeout/re-election ladder recovers from."""
        entries = self._confirm_cert_entries(confirm)
        if entries is None:
            return False
        valid = [a for a in self._recover_entries(entries) if a is not None]
        need = self.membership.validate_threshold()
        if len(valid) < need:
            return False
        seed = self.seed_for(confirm.block_number)
        if seed is not None and sum(
                1 for a in valid
                if self.membership.is_acceptor(a, seed)) < need:
            return False
        if len(confirm.sig) != 65:
            return False
        from eges_tpu_torch.crypto.verify_host import recover_signers
        signer = recover_signers(
            [(confirm.signing_hash(), confirm.sig)], self.verifier,
            priority="consensus")[0]
        return signer is not None and signer in self.membership

    # ------------------------------------------------------------------
    # transaction gossip (ref: TxMsg eth/handler.go:742-759 ->
    # TxPool.AddRemotes; relay-once dedup by txn hash)
    # ------------------------------------------------------------------

    _TXN_SEEN_CAP = 1 << 16

    def submit_txns(self, txns) -> None:  # thread-entry (RPC worker); ingress-entry:bounded
        """Local ingress (RPC eth_sendRawTransaction): admit to our pool
        via the journaled local path (they survive a restart, ref:
        core/tx_pool.go journal); admitted txns are broadcast via the
        pool's admission hook."""
        txns = list(txns)
        with self._lock, ledger.bind(self.ledger, "rpc"):
            if self.txpool is not None:
                self._ensure_pool_relay()
                self.txpool.add_locals(txns)
            else:
                self.broadcast_txns(txns)

    def broadcast_txns(self, txns) -> None:  # thread-entry (RPC worker); ingress-entry:bounded
        """Gossip txns to peers with relay-once dedup."""
        with self._lock:
            fresh = [t for t in txns if t.hash not in self._txn_seen]
            if not fresh:
                return
            self._mark_seen_txns(fresh)
            self.transport.gossip(
                M.pack_gossip(M.GOSSIP_TXNS, M.TxnsMsg(txns=tuple(fresh))))

    def _handle_txns(self, msg: M.TxnsMsg) -> None:
        fresh = [t for t in msg.txns if t.hash not in self._txn_seen]
        dupes = len(msg.txns) - len(fresh)
        if dupes:
            # relay-once dedup drops: re-gossiped txns billed to the
            # peer that delivered this redundant copy
            ledger.charge(drops=dupes)
        if not fresh:
            return
        if self.txpool is not None:
            # relay AFTER admission (signature verified in the pool's
            # batch window) — an attacker's junk txns must not get
            # network-wide fan-out amplification (the reference relays
            # only pool-accepted txns, eth/handler.go:742-759)
            self._ensure_pool_relay()
            if self.columnarize is not None and len(fresh) > 1:
                # wire-speed path: one columnar extraction + one
                # window-granular admission for the whole bundle
                self.txpool.add_remotes_window(self.columnarize(fresh))
            else:
                self.txpool.add_remotes(fresh)
        else:
            # pool-less follower: relay with dedup so txns still
            # propagate through it (marked seen either way)
            self.broadcast_txns(fresh)

    def _ensure_pool_relay(self) -> None:
        """Hook the pool's admission callback to broadcast admitted txns
        (chained with any existing callback)."""
        if getattr(self, "_pool_relay_hooked", None) is self.txpool:
            return
        prev = self.txpool.on_admitted

        def hook(t, sender, _prev=prev):
            if _prev is not None:
                _prev(t, sender)
            self.broadcast_txns([t])

        self.txpool.on_admitted = hook
        self._pool_relay_hooked = self.txpool

    def _mark_seen_txns(self, txns) -> None:
        if len(self._txn_seen) > self._TXN_SEEN_CAP:
            self._txn_seen.clear()  # coarse LRU: dupes re-relay once
        self._txn_seen.update(t.hash for t in txns)

    # ------------------------------------------------------------------
    # sync (the downloader role, ref: eth/downloader/downloader.go:931 —
    # ranged, retried, peer-tracked; SURVEY §5 checkpoint/resume)
    # ------------------------------------------------------------------

    SYNC_BATCH = 128       # blocks per request (served cap matches)
    SYNC_MAX_STALL = 8     # fruitless retries before giving up
    SYNC_FANOUT = 3        # concurrent ranged requests to distinct peers
    SYNC_STASH_MAX = 2048  # fetched-ahead blocks held for the funnel
    HDR_BATCH = 256        # headers per skeleton request (headers+certs
    #                        are ~50x smaller than 1000-txn bodies)
    HDR_FANOUT = 2         # concurrent header lanes
    SKEL_AHEAD = 4096      # skeleton prefetch horizon past the head
    SKEL_MAX = 16384       # pinned hashes cap (32B each)
    # fast-sync knobs (statesync.go role)
    FASTSYNC_MIN_GAP = 128   # replaying fewer blocks than this is cheaper
    #                          than a state download round-trip
    PIVOT_LAG = 32           # serve state this far behind head: deep
    #                          enough to be reorg-stable, shallow enough
    #                          that the tail replay stays short
    STATE_PAGE_BYTES = 36_000  # per-reply account payload budget (UDP)
    STATE_PAGE_MAX = 512       # accounts per page cap
    # byzantine-tolerance knobs for the live state download
    STATE_REPLY_MAX_BYTES = 192_000  # pre-decode byte cap on one state
    #                                  reply (FASTSYNC_MAX_ACCOUNTS caps
    #                                  rows; this caps BYTES before RLP)
    STATESYNC_MAX_REANCHORS = 3      # pivot/server re-anchors before the
    #                                  sync aborts to full replay
    STATESYNC_MAX_RETRIES = 64       # total fruitless ticks across the
    #                                  whole download before clean abort
    SERVE_RATE_PAGES_S = 4.0         # per-origin serving refill rate
    SERVE_BURST = 8                  # per-origin serving burst
    SERVE_TOKENS_MAX = 256           # tracked serving origins (oldest
    #                                  evicted; bounds the bucket dict)

    def _request_backfill(self, target: int, start: int | None = None) -> None:
        """Start (or extend) a sync toward ``target``.

        One outstanding request at a time; each retry rotates to another
        member peer (direct UDP), with a gossip broadcast as every third
        fallback for peers not in the membership.  Progress (blocks
        applied) resets the retry budget; a target that yields no blocks
        after SYNC_MAX_STALL rotations is abandoned (a forged confirm
        number must not keep the node polling forever)."""
        self._sync_target = max(getattr(self, "_sync_target", 0), target)
        # fast-sync entry (statesync.go role): a large-enough gap on a
        # fast_sync node downloads the pivot STATE instead of replaying
        # every block; certificates (signed votes) are what let the
        # joiner trust the pivot root, so unsigned chains always replay
        if (self.cfg.fast_sync and self._signing and not self._fs_done
                and target - self.chain.height() > self.FASTSYNC_MIN_GAP):
            if self._fs is None:
                self._fastsync_start(target)
            return
        if self._fs is not None:
            return  # the state download owns sync until it resolves
        if "backfill" not in self._timers:
            self._sync_progress = False
            self._sync_tick(start=start, retry=0)

    def _sync_tick(self, start: int | None, retry: int) -> None:
        height = self.chain.height()
        if height >= self._sync_target:
            self._cancel_timer("backfill")
            self._sync_skel.clear()
            self._skel_req_upto = 0
            return
        if self._sync_progress:
            retry = 0  # a reply delivered blocks: reset the stall budget
            self._sync_progress = False
        elif retry >= self.SYNC_MAX_STALL:
            # no peer served anything across a full rotation: the target
            # is unreachable (e.g. a forged confirm number) — abandon it
            # AND drop the fetched-ahead staging (unapplied peer-supplied
            # blocks must not squat memory after the sync dies)
            self._cancel_timer("backfill")
            self._sync_target = 0
            self._sync_stash.clear()
            self._sync_skel.clear()
            self._skel_req_upto = 0
            return
        if start is None:
            # overlap a few blocks behind our head so the reply exposes
            # the fork point when our tail is locally-forced empties
            # (replace_suffix needs the anchor)
            start = max(1, height - 7)
        # concurrent per-peer ranged fetch (the downloader's parallel
        # queues, ref: eth/downloader/downloader.go fetchParts role):
        # split the outstanding range into SYNC_FANOUT chunks and ask a
        # DIFFERENT member peer for each; arrivals beyond the insert
        # window stage in _sync_stash until the head catches up
        for lane in range(self.SYNC_FANOUT):
            lane_start = start + lane * self.SYNC_BATCH
            if lane_start > self._sync_target:
                break
            count = max(min(self._sync_target - lane_start + 1,
                            self.SYNC_BATCH), 1)
            req = M.BlockFetchReq(start=lane_start, count=count,
                                  ip=self.cfg.consensus_ip,
                                  port=self.cfg.consensus_port)
            peer = self._pick_sync_peer(retry + lane)
            if peer is not None and retry % 3 != 2:
                self.transport.send_direct(
                    peer.ip, peer.port,
                    M.pack_direct(M.UDP_GET_BLOCKS, self.coinbase, req))
            elif lane == 0:
                # every third rotation (or with no member peers) the
                # first lane broadcasts instead — the gossip fallback
                # for peers outside the membership
                self.transport.gossip(
                    M.pack_gossip(M.GOSSIP_GET_BLOCKS, req))
        # header-first skeleton prefetch (ref: downloader.go:931): pull
        # the gap's headers+certificates ahead of bodies so the whole
        # range's signatures batch-verify on the device at once and the
        # body lanes skip per-reply verification (they hash onto pins).
        # Watermark-gated: lost header replies just mean those numbers
        # fall back to the certified body path — no retry machinery.
        for n in [k for k in self._sync_skel if k <= height]:
            del self._sync_skel[n]
        if self._signing and len(self._sync_skel) < self.SKEL_MAX:
            want_hi = min(self._sync_target, height + self.SKEL_AHEAD)
            hdr_start = max(height + 1, self._skel_req_upto + 1)
            for lane in range(self.HDR_FANOUT):
                lane_start = hdr_start + lane * self.HDR_BATCH
                if lane_start > want_hi:
                    break
                count = min(want_hi - lane_start + 1, self.HDR_BATCH)
                hreq = M.BlockFetchReq(start=lane_start, count=count,
                                       ip=self.cfg.consensus_ip,
                                       port=self.cfg.consensus_port)
                peer = self._pick_sync_peer(retry + 7 * lane + 3)
                if peer is not None:
                    self.transport.send_direct(
                        peer.ip, peer.port,
                        M.pack_direct(M.UDP_GET_HEADERS, self.coinbase,
                                      hreq))
                else:
                    self.transport.gossip(
                        M.pack_gossip(M.GOSSIP_GET_HEADERS, hreq))
                self._skel_req_upto = lane_start + count - 1
        self._set_timer("backfill", self.ccfg.validate_timeout_ms / 1e3,
                        lambda: self._sync_tick(None, retry + 1))

    def _pick_sync_peer(self, retry: int):
        peers = [m for m in self.membership.members()
                 if m.addr != self.coinbase and m.ip]
        if not peers:
            return None
        self._sync_rr = getattr(self, "_sync_rr", 0) + 1
        return peers[(self._sync_rr + retry) % len(peers)]

    # UDP datagrams cap near 64 KB; a batch of blocks at the 1000-txn
    # operating point is far larger (the in-process sim has no MTU,
    # which hid this — a real-socket joiner stalled at height 0 while
    # its peers' replies were silently dropped).  Small chunks go
    # direct; anything bigger rides the TCP gossip plane (receivers
    # that are not syncing dedupe via chain.offer).
    UDP_BUDGET = 40_000

    def _send_chunked(self, req, items, enc_len, make_reply,
                      udp_code, gossip_code, max_items: int) -> None:
        """Chunk sync reply ``items`` under the UDP budget — shared by
        the block and header serve paths so the MTU handling can never
        drift between the planes.  A single item too big for any
        datagram rides the TCP gossip plane alone."""
        chunk: list = []
        size = 0
        for it in items + [None]:
            enc = enc_len(it) if it is not None else 0
            if chunk and (it is None or size + enc > self.UDP_BUDGET
                          or len(chunk) >= max_items):
                reply = make_reply(tuple(chunk))
                packed = M.pack_direct(udp_code, self.coinbase, reply)
                if len(packed) <= self.UDP_BUDGET + 1024:
                    self.transport.send_direct(req.ip, req.port, packed)
                else:
                    self.transport.gossip(
                        M.pack_gossip(gossip_code, reply))
                chunk, size = [], 0
            if it is not None:
                if enc > self.UDP_BUDGET:
                    self.transport.gossip(M.pack_gossip(
                        gossip_code, make_reply((it,))))
                else:
                    chunk.append(it)
                    size += enc

    def _serve_block_fetch(self, req: M.BlockFetchReq) -> None:
        blocks = []
        for n in range(req.start, req.start + min(req.count,
                                                  self.SYNC_BATCH)):
            b = self.chain.get_block_by_number(n)
            if b is None:
                break
            blocks.append(b)
        if not blocks:
            return
        self._send_chunked(
            req, blocks, lambda b: len(b.encode()),
            lambda t: M.BlocksReply(blocks=t),
            M.UDP_BLOCKS, M.GOSSIP_BLOCKS_REPLY, max_items=32)

    def _certified_mask(self, items) -> list[bool]:
        """For ``(number, obj_hash, confirm)`` triples: True when the
        quorum certificate verifies AND actually certifies the object in
        hand (or none is required — confidence-0 local empties carry
        none legitimately).  The binding matters as much as the
        signatures: a replayed GENUINE certificate paired with a
        fabricated header/block must fail here, so the confirm's claimed
        number and hash are checked against the object before any
        signature work.  The one certificate shape that cannot bind a
        hash — version>0 empty-block recovery, whose supporters signed
        the zero hash — is handled by the callers (bodies must be empty;
        headers are never pinned on it).  All certificates across the
        batch are recovered in ONE verifier batch — during catch-up this
        is where a whole gap's signatures land on the device together."""
        need = self.membership.validate_threshold()
        spans = []          # (item_index, entry_span) needing verification
        all_entries = []
        keep = [True] * len(items)
        for i, (number, obj_hash, confirm) in enumerate(items):
            if confirm is None or confirm.confidence == 0:
                continue
            if confirm.block_number != number or (
                    confirm.hash != obj_hash
                    and self._cert_binds_hash(confirm)):
                keep[i] = False  # certificate is for a different object
                continue
            entries = self._confirm_cert_entries(confirm)
            if entries is None:
                keep[i] = False
                continue
            spans.append((i, len(all_entries), len(entries)))
            all_entries.extend(entries)
        recovered = self._recover_entries(all_entries) if all_entries else []
        for i, start, n in spans:
            valid = [a for a in recovered[start:start + n] if a is not None]
            ok = len(valid) >= need
            if ok:
                seed = self.seed_for(items[i][0])
                if seed is not None and sum(
                        1 for a in valid
                        if self.membership.is_acceptor(a, seed)) < need:
                    ok = False
            keep[i] = ok
        return keep

    @staticmethod
    def _cert_binds_hash(confirm) -> bool:
        """False for the one certificate shape whose supporter
        signatures do not cover a block hash: version>0 empty-block
        recovery signs the zero hash — it certifies "empty at N", not
        any particular bytes."""
        return not (confirm.version > 0 and confirm.empty_block)

    def _serve_header_fetch(self, req: M.BlockFetchReq) -> None:
        """Serve a header-skeleton request: (header, confirm) pairs, no
        bodies (ref: eth/handler.go GetBlockHeadersMsg role).  Chunked
        like block replies: small chunks ride UDP back to the asker,
        oversized ones the TCP gossip plane."""
        from eges_tpu_torch.core import rlp as rlp_mod

        pairs = []
        for n in range(req.start, req.start + min(req.count,
                                                  2 * self.HDR_BATCH)):
            b = self.chain.get_block_by_number(n)
            if b is None:
                break
            pairs.append((b.header, b.confirm))
        if not pairs:
            return
        self._send_chunked(
            req, pairs,
            lambda p: (len(rlp_mod.encode(p[0].to_rlp()))
                       + (len(rlp_mod.encode(p[1].to_rlp()))
                          if p[1] else 1)),
            lambda t: M.HeadersReply(headers=t),
            M.UDP_HEADERS, M.GOSSIP_HEADERS_REPLY, max_items=128)

    # ------------------------------------------------------------------
    # fast sync (the fast/state-sync mode of the reference downloader,
    # ref: eth/downloader/statesync.go:1, downloader.go:1353 — account-
    # granular pages instead of trie nodes; design in core/statesync.py)
    # ------------------------------------------------------------------

    def _fastsync_start(self, target: int) -> None:
        self._fs = {"target": target, "pivot": 0, "root": b"",
                    "accounts": [], "codes": [], "total": None,
                    "headers": {}, "block": None, "progress": False,
                    # byzantine-tolerance state: the pinned serving peer
                    # (every page of one download comes from ONE server,
                    # so a poisoned download is attributable), plus the
                    # bounded re-anchor / total-retry budgets
                    "server": None, "reanchors": 0, "retries": 0}
        self._fastsync_load_staging()
        self._log("FASTSYNC start", gap=target - self.chain.height())
        self._fastsync_tick(retry=0)

    def _fastsync_load_staging(self) -> None:
        """Mid-sync crash resume: pages a previous process accepted and
        staged to the store re-enter the download, so a crash at cursor
        N resumes at N instead of 0.  Only a consistent prefix loads —
        same pivot/root throughout, cursors contiguous from 0; the
        first torn or inconsistent blob truncates the resume there."""
        from eges_tpu_torch.core import statesync as _ss
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        fs = self._fs
        try:
            blobs = self.chain.store.load_sync_pages()
        # analysis: allow-swallow(staging is an optimization; an unreadable log just restarts the download from cursor 0)
        except Exception:
            return
        pages = 0
        for blob in blobs:
            try:
                pivot, root, cursor, total, accounts, codes = \
                    _ss.decode_page(blob)
            except _ss.StateSyncError:
                break  # torn staged tail: keep the consistent prefix
            if pages == 0:
                if cursor != 0:
                    break
                fs["pivot"], fs["root"] = pivot, root
            elif (pivot != fs["pivot"] or root != fs["root"]
                    or cursor != len(fs["accounts"])):
                break
            if (len(fs["accounts"]) + len(accounts)
                    > self.FASTSYNC_MAX_ACCOUNTS):
                break  # an overgrown staging log never resumes past the
                       # same row budget the live download enforces
            fs["accounts"].extend(accounts)
            fs["codes"].extend(codes)
            fs["total"] = total
            pages += 1
        if pages:
            self.journal.record("statesync_resume", blk=fs["pivot"],
                                pages=pages, rows=len(fs["accounts"]))
            metrics.counter("statesync.resumes").inc()
            self._log("FASTSYNC resume", pivot=fs["pivot"], pages=pages,
                      rows=len(fs["accounts"]))

    def _clear_sync_staging(self) -> None:
        try:
            self.chain.store.clear_sync_staging()
        # analysis: allow-swallow(staging cleanup is best-effort; stale pages fail the consistency check on the next load)
        except Exception:
            pass

    def _fastsync_abort(self, why: str) -> None:
        """Fall back to full replay — once per session; a byzantine or
        pruned serving peer can delay a fast sync, never wedge it."""
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        fs, self._fs = self._fs, None
        self._fs_done = True
        self._cancel_timer("fastsync")
        if fs is not None:
            # drop the staged rows NOW: an armed timer or in-flight
            # closure still holding ``fs`` must not pin up to
            # FASTSYNC_MAX_ACCOUNTS rows until the next sync
            fs["accounts"].clear()
            fs["codes"].clear()
            fs["headers"].clear()
            fs["block"] = None
        self._clear_sync_staging()
        self.journal.record("statesync_abort", why=why)
        metrics.counter("statesync.aborts").inc()
        self._log("FASTSYNC abandoned", why=why)
        if fs is not None:
            self._request_backfill(fs["target"])

    def _fastsync_pick_server(self, retry: int):
        """Serving-peer choice for the state download: the usual member
        rotation, EXCLUDING peers that already served a poisoned page."""
        peers = [m for m in self.membership.members()
                 if m.addr != self.coinbase and m.ip
                 and m.addr not in self._fs_blacklist]
        if not peers:
            return None
        self._sync_rr = getattr(self, "_sync_rr", 0) + 1
        return peers[(self._sync_rr + retry) % len(peers)]

    def _fastsync_rotate_server(self, retry: int) -> None:
        """The pinned server went quiet for a full stall ladder: move
        the download to another peer.  Staged pages answer the OLD
        server's pivot snapshot, so rotation with pages on hand
        re-anchors the whole download (bounded by the re-anchor
        budget); with nothing staged it just unpins."""
        fs = self._fs
        old = fs["server"]
        self.journal.record(
            "statesync_server_rotate", blk=fs["pivot"],
            server=old.addr.hex()[:8] if old is not None else "",
            retry=retry)
        if fs["accounts"] or fs["pivot"]:
            self._fastsync_reanchor("server quiet", blacklist=False)
        else:
            fs["server"] = None

    def _fastsync_reanchor(self, why: str, *, blacklist: bool) -> None:
        """Restart the download from cursor 0 on a fresh pivot/server,
        optionally quarantining the current server first.  Budgeted:
        crossing STATESYNC_MAX_REANCHORS aborts to full replay."""
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        fs = self._fs
        srv = fs["server"]
        if blacklist and srv is not None:
            self._fs_blacklist.add(srv.addr)
        fs["reanchors"] += 1
        metrics.counter("statesync.reanchors").inc()
        self.journal.record("statesync_reanchor", blk=fs["pivot"],
                            count=fs["reanchors"], why=why)
        self._log("FASTSYNC reanchor", why=why, count=fs["reanchors"])
        if fs["reanchors"] > self.STATESYNC_MAX_REANCHORS:
            self._fastsync_abort("re-anchor budget exhausted")
            return
        fs.update(pivot=0, root=b"", accounts=[], codes=[], total=None,
                  block=None, progress=False, server=None)
        fs["headers"].clear()
        self._clear_sync_staging()

    def _fastsync_tick(self, retry: int) -> None:
        fs = self._fs
        if fs is None:
            return
        if fs["progress"]:
            retry = 0
            fs["progress"] = False
        else:
            if retry > 0:
                fs["retries"] += 1
            if fs["retries"] >= self.STATESYNC_MAX_RETRIES:
                # total-retry budget across the whole download, however
                # many servers it rotated through: clean abort-to-replay
                self._fastsync_abort("retry budget exhausted")
                return
            if retry >= self.SYNC_MAX_STALL:
                self._fastsync_rotate_server(retry)
                fs = self._fs
                if fs is None:
                    return
                retry = 0
        if fs["server"] is None:
            fs["server"] = self._fastsync_pick_server(retry)
            if fs["server"] is None:
                self._fastsync_abort("no serving peer")
                return
        srv = fs["server"]
        req = M.StateFetchReq(block_num=fs["pivot"],
                              cursor=len(fs["accounts"]),
                              ip=self.cfg.consensus_ip,
                              port=self.cfg.consensus_port)
        self.transport.send_direct(
            srv.ip, srv.port,
            M.pack_direct(M.UDP_GET_STATE, self.coinbase, req))
        if fs["pivot"]:
            # the pivot header (for the certified root) and the pivot
            # block (the new head) ride the existing sync lanes
            breq = M.BlockFetchReq(start=fs["pivot"], count=1,
                                   ip=self.cfg.consensus_ip,
                                   port=self.cfg.consensus_port)
            if fs["pivot"] not in fs["headers"]:
                peer2 = self._pick_sync_peer(retry + 1)
                if peer2 is not None:
                    self.transport.send_direct(
                        peer2.ip, peer2.port,
                        M.pack_direct(M.UDP_GET_HEADERS, self.coinbase,
                                      breq))
                else:
                    self.transport.gossip(
                        M.pack_gossip(M.GOSSIP_GET_HEADERS, breq))
            if fs["block"] is None:
                peer3 = self._pick_sync_peer(retry + 2)
                if peer3 is not None:
                    self.transport.send_direct(
                        peer3.ip, peer3.port,
                        M.pack_direct(M.UDP_GET_BLOCKS, self.coinbase,
                                      breq))
                else:
                    self.transport.gossip(
                        M.pack_gossip(M.GOSSIP_GET_BLOCKS, breq))
        # per-peer backoff: each fruitless retry against the pinned
        # server stretches the re-ask interval (deterministic ladder)
        delay = (self.ccfg.validate_timeout_ms / 1e3
                 * min(retry + 1, 4))
        self._set_timer("fastsync", delay,
                        lambda: self._fastsync_tick(retry + 1))

    def _handle_state_chunk(self, reply: M.StateChunkReply,
                            author: bytes = b"") -> None:
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        fs = self._fs
        if fs is None:
            return
        srv = fs["server"]
        if author and srv is not None and author != srv.addr:
            # authenticated page from a peer this download is NOT
            # anchored on: one interleaved poisoned page would fail the
            # final root check and waste the whole download — reject it
            # and bill the sender.  (Gossip replies carry no author and
            # pass; the cursor/pivot checks below still gate them, and
            # the root check backstops everything.)
            metrics.counter("statesync.pages_rejected").inc()
            ledger.charge(rejects=1)
            return
        if fs["pivot"] == 0:
            if reply.cursor != 0 or reply.block_num <= self.chain.height():
                return
            fs["pivot"], fs["root"] = reply.block_num, reply.root
        elif reply.block_num != fs["pivot"] or reply.root != fs["root"]:
            if reply.cursor == 0 and reply.block_num > fs["pivot"]:
                # server pruned our pivot and re-anchored: restart there
                fs.update(pivot=reply.block_num, root=reply.root,
                          accounts=[], codes=[], total=None, block=None)
                self._clear_sync_staging()
            else:
                metrics.counter("statesync.pages_rejected").inc()
                return
        if reply.cursor != len(fs["accounts"]):
            # duplicate or out-of-order page (benign under re-asks);
            # the tick re-requests the cursor it actually needs
            metrics.counter("statesync.pages_rejected").inc()
            return
        if (len(fs["accounts"]) + len(reply.accounts)
                > self.FASTSYNC_MAX_ACCOUNTS):
            # a malicious state server claiming an absurd account count
            # cannot balloon the staging buffers: quarantine it and
            # re-anchor the download on another server (budgeted)
            self._log("fastsync state too large",
                      staged=len(fs["accounts"]))
            self._fastsync_reanchor("state too large", blacklist=True)
            if self._fs is not None:
                self._fastsync_tick(retry=0)
            return
        fs["accounts"].extend(reply.accounts)
        fs["codes"].extend(reply.codes)
        fs["total"] = reply.total
        fs["progress"] = True
        metrics.counter("statesync.pages_accepted").inc()
        # fetching is ingress work too: bill the staged rows to the
        # origin that delivered them (ambient bind at the perimeter)
        ledger.charge(rows=len(reply.accounts), admits=1)
        self._stage_sync_page(reply)
        self._fastsync_maybe_finish()
        if self._fs is not None:
            self._fastsync_tick(retry=0)  # next page immediately

    def _stage_sync_page(self, reply: M.StateChunkReply) -> None:
        """Persist one accepted page to the store's staging log (the
        crash-resume source read back by ``_fastsync_load_staging``)."""
        from eges_tpu_torch.core import statesync as _ss

        fs = self._fs
        try:
            self.chain.store.append_sync_page(_ss.encode_page(
                fs["pivot"], fs["root"], reply.cursor, reply.total,
                reply.accounts, reply.codes))
        # analysis: allow-swallow(staging is an optimization; a page that failed to stage just re-downloads after a crash)
        except Exception:
            pass

    def _fastsync_take_blocks(self, blocks) -> None:
        """During a state download the block lanes only feed the pivot
        block; everything else re-fetches after adoption."""
        fs = self._fs
        want = [b for b in blocks if b.number == fs["pivot"]]
        if not want or fs["block"] is not None:
            return
        ok = self._filter_certified(want)
        if ok:
            fs["block"] = ok[0]
            fs["progress"] = True
            self._fastsync_maybe_finish()

    def _fastsync_maybe_finish(self) -> None:
        from eges_tpu_torch.core import statesync as _ss
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        fs = self._fs
        if (fs is None or fs["total"] is None
                or len(fs["accounts"]) < fs["total"]):
            return
        hdr = fs["headers"].get(fs["pivot"])
        blk = fs["block"]
        if hdr is None or blk is None:
            return  # the tick keeps requesting them
        if blk.hash != hdr.hash:
            fs["block"] = None  # block from a liar peer; re-fetch
            return
        state = None
        try:
            state = _ss.assemble(fs["accounts"], fs["codes"])
        except Exception as exc:
            # structurally-invalid pages (bad storage pairs, torn rows)
            # are the same class of attack as a wrong balance: poison
            self._log("fastsync assemble failed", err=repr(exc))
        if state is None or state.root() != hdr.root:
            # pages were poisoned: certificates bound the header, the
            # rebuilt tries disagree — nothing was adopted.  Every page
            # came from the pinned server, so the poisoning is
            # attributable: quarantine it, bill the wasted rows to it,
            # and re-anchor the download on an honest peer (budgeted;
            # the re-anchor path aborts to full replay when exhausted)
            srv = fs["server"]
            label = srv.addr.hex()[:8] if srv is not None else "?"
            self.journal.record("statesync_poisoned", blk=fs["pivot"],
                                server=label, rows=len(fs["accounts"]))
            metrics.counter("statesync.poisoned").inc()
            self.ledger.charge(f"server:{label}",
                               rejects=max(len(fs["accounts"]), 1))
            self._fastsync_reanchor(
                "state root mismatch vs certified header",
                blacklist=True)
            if self._fs is not None:
                self._fastsync_tick(retry=0)
            return
        target = fs["target"]
        pivot = fs["pivot"]
        rows = len(fs["accounts"])
        self.chain.adopt_snapshot(blk, state)
        self._clear_sync_staging()
        self._fs = None
        self._fs_done = True
        self._cancel_timer("fastsync")
        self.journal.record("statesync_adopted", blk=pivot,
                            accounts=rows, target=target)
        self._log("FASTSYNC adopted", pivot=pivot,
                  root=hdr.root.hex()[:12], accounts=len(state),
                  target=target)
        self._request_backfill(max(target, pivot), start=pivot + 1)

    def _serve_state_fetch(self, req: M.StateFetchReq) -> None:
        """Serve one address-sorted page of a pivot state snapshot.

        The pivot is head−PIVOT_LAG on first contact (block_num=0); on
        later pages the exact requested block, falling back to a fresh
        cursor-0 pivot when ours got pruned (the joiner restarts).  The
        flattened account list is cached per pivot hash — paging is a
        slice, not a re-walk."""
        from eges_tpu_torch.core import rlp as rlp_mod
        from eges_tpu_torch.core import statesync as _ss
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        # serving is rate-limited per origin: snapshot pages are the
        # most expensive reply this node produces, and an unthrottled
        # serve loop would let one cheap StateFetchReq stream turn this
        # node into a DoS amplifier against itself
        origin = ledger.current_peer() or f"{req.ip}:{req.port}"
        if not self._serve_tokens_take(origin):
            metrics.counter("statesync.serve_throttled").inc()
            ledger.charge(drops=1)
            return
        height = self.chain.height()
        n, cursor = req.block_num, req.cursor
        blk = state = None
        if n:
            blk = self.chain.get_block_by_number(n)
            state = self.chain.state_at(blk.hash) if blk else None
        if state is None:
            n, cursor = max(1, height - self.PIVOT_LAG), 0
            while n <= height:
                blk = self.chain.get_block_by_number(n)
                state = self.chain.state_at(blk.hash) if blk else None
                if state is not None:
                    break
                n += 1
        if state is None or blk is None:
            return
        cache = self._snap_cache
        if cache is None or cache[0] != blk.hash:
            accounts = _ss.snapshot_accounts(state)
            self._snap_cache = (blk.hash, accounts)
        else:
            accounts = cache[1]
        if cursor > len(accounts):
            return
        page, size = [], 0
        for item in accounts[cursor:]:
            enc = len(rlp_mod.encode(
                [item[0], item[1], item[2], item[3],
                 [[k, v] for k, v in item[4]]]))
            if page and (size + enc > self.STATE_PAGE_BYTES
                         or len(page) >= self.STATE_PAGE_MAX):
                break
            page.append(item)
            size += enc
        reply = M.StateChunkReply(
            block_num=n, root=blk.header.root, cursor=cursor,
            total=len(accounts), accounts=tuple(page),
            codes=_ss.codes_for(state, page))
        packed = M.pack_direct(M.UDP_STATE, self.coinbase, reply)
        if len(packed) <= self.UDP_BUDGET + 1024:
            self.transport.send_direct(req.ip, req.port, packed)
        else:
            self.transport.gossip(M.pack_gossip(M.GOSSIP_STATE_REPLY,
                                                reply))
        # serving is billable work driven by the requester
        metrics.counter("statesync.pages_served").inc()
        ledger.charge(rows=len(page), admits=1)

    def _serve_tokens_take(self, origin: str) -> bool:
        """Per-origin token bucket for the snapshot-serving plane, on
        the node clock (virtual in sims, so deterministic).  The bucket
        dict is bounded-by: SERVE_TOKENS_MAX (oldest origin evicted)."""
        now = self.clock.now()
        tokens, last = self._serve_tokens.get(
            origin, (float(self.SERVE_BURST), now))
        tokens = min(float(self.SERVE_BURST),
                     tokens + (now - last) * self.SERVE_RATE_PAGES_S)
        ok = tokens >= 1.0
        if ok:
            tokens -= 1.0
        self._serve_tokens[origin] = (tokens, now)
        while len(self._serve_tokens) > self.SERVE_TOKENS_MAX:
            self._serve_tokens.pop(next(iter(self._serve_tokens)))
        return ok

    def _handle_headers_reply(self, reply: M.HeadersReply) -> None:
        """Pin the verified skeleton: batch-verify every certificate in
        the reply (one device batch for the lot) and remember the header
        hashes, so arriving bodies only need to hash onto a pin.
        Uncertified headers (local empties, or certs that fail) are NOT
        pinned — their bodies take the fully-verified path."""
        pairs = [(h, c) for h, c in reply.headers
                 if h.number > self.chain.height()]
        if not pairs or not self._signing:
            return  # without signed votes there is nothing to pre-verify
        if len(self._sync_skel) + len(pairs) > self.SKEL_MAX:
            pairs = pairs[:max(0, self.SKEL_MAX - len(self._sync_skel))]
            if not pairs:
                return
        mask = self._certified_mask([(h.number, h.hash, c)
                                     for h, c in pairs])
        for (h, c), ok in zip(pairs, mask):
            # pin only hash-binding certificates: the mask has already
            # checked c.hash == h.hash for these, so the pin IS what the
            # quorum signed.  Recovery empties (sigs over the zero hash)
            # can't bind bytes and are never pinned.
            if (ok and c is not None and c.confidence > 0
                    and self._cert_binds_hash(c)):
                self._sync_skel[h.number] = h.hash
                if self._fs is not None:
                    # fast sync needs the certified HEADER (its root is
                    # what the downloaded state verifies against)
                    self._fs["headers"][h.number] = h
                    if h.number == self._fs["pivot"]:
                        self._fs["progress"] = True
                        self._fastsync_maybe_finish()

    def _filter_certified(self, blocks) -> list:
        """Drop backfilled blocks whose quorum confirm doesn't verify or
        doesn't certify THIS block — a sync peer must not be able to
        hand us fabricated "confirmed" history, including a fabricated
        block wearing a replayed genuine certificate.  Locally-forced
        empty blocks (confidence 0) are legitimately uncertified, and
        are exactly the blocks replace_suffix may later displace."""
        keep = self._certified_mask(
            [(b.number, b.hash, b.confirm) for b in blocks])
        out = []
        for b, k in zip(blocks, keep):
            if not k:
                continue
            c = b.confirm
            if (c is not None and c.confidence > 0
                    and not self._cert_binds_hash(c)
                    and (b.transactions or b.geec_txns or b.fake_txns)):
                continue  # recovery cert proves only "empty at N"
            out.append(b)
        return out

    def _handle_blocks_reply(self, reply: M.BlocksReply) -> None:
        """Backfilled canonical blocks: heal a local-empty-block fork via
        reorg, then extend normally.  If the fork is deeper than the
        reply's overlap, re-request further back (doubling window)."""
        blocks = sorted(reply.blocks, key=lambda b: b.number)
        if self._fs is not None:
            # a state download is in flight: block lanes only feed the
            # pivot; the tail re-fetches after adoption
            self._fastsync_take_blocks(blocks)
            return
        if self._signing:
            # header-first fast path: a body hashing onto a pinned
            # (pre-verified) skeleton entry needs no certificate work.
            # A body CONTRADICTING its pin falls back to full
            # certificate verification — and if its hash-bound
            # certificate verifies, the pin was wrong (equivocation or
            # poisoning upstream) and is evicted, so one bad pin can
            # never starve a height and wedge the sync.
            pinned, rest = [], []
            for b in blocks:
                pin = self._sync_skel.get(b.number)
                if pin is not None and b.hash == pin:
                    pinned.append(b)
                else:
                    rest.append(b)
            verified = self._filter_certified(rest)
            for b in verified:
                if self._sync_skel.get(b.number) not in (None, b.hash):
                    del self._sync_skel[b.number]
            blocks = sorted(pinned + verified, key=lambda b: b.number)
        if not blocks:
            return
        head = self.chain.height()
        conflict = [b for b in blocks if b.number <= head
                    and (local := self.chain.get_block_by_number(b.number))
                    is not None and local.hash != b.hash]
        if conflict:
            done = self.chain.replace_suffix(
                [b for b in blocks if b.number >= conflict[0].number])
            if not done and conflict[0].number == blocks[0].number:
                # fork point precedes the reply window — look deeper
                # (keep the target above our head or the tick no-ops)
                self._cancel_timer("backfill")
                self._sync_target = max(self._sync_target, head + 1)
                depth = 2 * max(head - blocks[0].number + 1, 8)
                self._sync_tick(start=max(1, head - depth + 1), retry=0)
                return
            if done:
                self._sync_progress = True
        for b in blocks:
            if b.number > self.chain.height() + 256:
                # beyond the insert funnel's buffer window: stage it
                # (concurrent lanes fetch ahead of the head)
                if (len(self._sync_stash) < self.SYNC_STASH_MAX
                        or b.number < max(self._sync_stash)):
                    self._sync_stash[b.number] = b
                    while len(self._sync_stash) > self.SYNC_STASH_MAX:
                        del self._sync_stash[max(self._sync_stash)]
            elif self.chain.offer(b):
                self._sync_progress = True
        # drain staged blocks that entered the window as the head moved
        while self._sync_stash:
            window_end = self.chain.height() + 256
            ready = [n for n in self._sync_stash if n <= window_end]
            if not ready:
                break
            progressed = False
            for n in sorted(ready):
                if self.chain.offer(self._sync_stash.pop(n)):
                    progressed = True
                    self._sync_progress = True
            if not progressed:
                break
        # continuation: more of the range outstanding -> next request now
        if (self._sync_progress
                and self.chain.height() < getattr(self, "_sync_target", 0)):
            self._cancel_timer("backfill")
            self._sync_tick(start=None, retry=0)
        elif self.chain.height() >= getattr(self, "_sync_target", 0):
            # target reached in this very reply: drop the skeleton now
            # rather than waiting for the timer's completion tick
            self._sync_skel.clear()
            self._skel_req_upto = 0

    # ------------------------------------------------------------------
    # chain listener (ref: handleNewBlock geec_state.go:964-1018 +
    # blockLoop geec_state.go:1132-1180)
    # ------------------------------------------------------------------

    def _on_new_block(self, blk: Block) -> None:  # api: _on_new_block
        with self._lock:
            self._timeout_times = 0
            self._arm_block_timeout()
            self._ingest_block(blk)

    def _ingest_block(self, blk: Block, replay: bool = False) -> None:
        """Consensus-state effects of a canonical block; also used to
        rebuild state from a durable chain on restart (the reference
        rebuilds GeecState "from genesis bootstrap list + replayed
        confirmed blocks", SURVEY §5 checkpoint/resume)."""
        self.trust_rands[blk.number] = blk.header.trust_rand
        if self.txpool is not None and blk.transactions:
            self.txpool.remove_included(blk.transactions, block=blk.number)
        if blk.geec_txns:
            # drop geec txns the landed block already included — from the
            # pending queue AND from any in-flight proposal's drained list
            # (the abort below would otherwise re-queue them after this
            # dedup already ran)
            included = {t.hash for t in blk.geec_txns}
            self.pending_geec_txns = deque(
                t for t in self.pending_geec_txns
                if t.hash not in included)
            if self._proposal_geec_txns:
                self._proposal_geec_txns = [
                    t for t in self._proposal_geec_txns
                    if t.hash not in included]
        if blk.header.coinbase == EMPTY_ADDR:
            if blk.number not in self.empty_block_list:
                self.empty_block_list.append(blk.number)
        self.unconfirmed.append(blk)
        # per-height bookkeeping is windowed: entries older than
        # HEIGHT_WINDOW heights cannot be referenced by any committee /
        # confirm path near the tip, so long runs hold steady memory
        while len(self.trust_rands) > self.HEIGHT_WINDOW:
            del self.trust_rands[next(iter(self.trust_rands))]
        while len(self.empty_block_list) > self.HEIGHT_WINDOW:
            self.empty_block_list.pop(0)
        if not replay:
            self._last_commit_t = self.clock.now()
            # per-block ingress provenance snapshot: one ingress_ledger
            # event when anything was charged since the last block —
            # the SLO engine keys on its admit/reject deltas
            self.ledger.journal_snapshot(self.journal, blk=blk.number)
        confidence = blk.confirm.confidence if blk.confirm else 0
        if confidence > CONFIDENCE_THRESHOLD:
            self._handle_confirmed_tail(blk)
        # drop pendings at or below the new height
        for n in list(self.pending_blocks):
            if n <= blk.number:
                del self.pending_blocks[n]
        if (not replay and self.cfg.checkpoint_every
                and blk.number % self.cfg.checkpoint_every == 0):
            # durable checkpoint cadence: every Nth committed block
            # snapshots state + consensus soft state to the store's
            # sidecar, so the NEXT restart replays only the tail
            self._write_checkpoint(blk)
        if blk.number >= self.wb.blk_num:
            if not replay:
                self._abort_proposal()
            self.wb.advance(blk.number + 1)
            if not replay:
                self._drain_deferred()
                self._try_propose()

    def _write_checkpoint(self, blk: Block) -> None:
        from eges_tpu_torch.core import statesync as _ss
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        state = self.chain.state_at(blk.hash)
        if state is None:
            return  # state already pruned past the window; next cadence
        cons = {
            "members": [(m.addr, m.referee, m.ip, m.port, m.joined_block,
                         m.ttl, m.renewed_times)
                        for m in self.membership.members()],
            "trust_rands": sorted(self.trust_rands.items()),
            "empty_blocks": list(self.empty_block_list),
            "unconfirmed": [b.number for b in self.unconfirmed],
            "registered": self.registered,
        }
        try:
            payload = _ss.encode_checkpoint(blk.hash, state, cons)
            self.chain.store.put_snapshot(payload)
        except Exception as exc:
            # a failed checkpoint write must never stall consensus: the
            # previous sidecar (or full replay) still restarts this node
            self._log("checkpoint write failed", err=repr(exc))  # analysis: allow-swallow(checkpointing is a durability optimization; boot falls back to replay)
            return
        self.journal.record("statesync_checkpoint", blk=blk.number,
                            nbytes=len(payload))
        metrics.counter("statesync.checkpoints").inc()
        metrics.gauge("statesync.checkpoint_bytes").set(len(payload))

    def _handle_confirmed_tail(self, confirmed_blk: Block) -> None:
        """Apply effects of all now-confirmed blocks (ref:
        handleConfirmedBlock geec_state.go:1021-1082)."""
        for blk in self.unconfirmed:
            for reg in blk.header.regs:
                known = self.pending_regs.get(reg.account)
                if known is not None and known.renew <= reg.renew:
                    del self.pending_regs[reg.account]
                try:
                    port = int(reg.port)
                except ValueError:
                    continue  # geec_state.go:1049: unparsable port ignored
                self.membership.add(Member(
                    addr=reg.account, referee=reg.referee, ip=reg.ip,
                    port=port, joined_block=blk.number,
                    ttl=self.membership.initial_ttl,
                    renewed_times=reg.renew))
                if reg.account == self.coinbase:
                    self.registered = True
                    self._cancel_timer("register")
            for txn in blk.geec_txns:
                if self.geec_txn_sink is not None:
                    self.geec_txn_sink(txn)
            if self.cfg.failure_test:
                self._check_membership(blk)
        self.unconfirmed = []
        self.empty_block_list = []

    def _check_membership(self, blk: Block) -> None:
        """TTL economy per confirmed block (ref: CheckMembership
        geec_state.go:1088-1129)."""
        if blk.confirm is not None:
            self.membership.reward(list(blk.confirm.supporters)
                                   + [blk.header.coinbase])
        if blk.number % self.membership.ttl_interval == 0:
            self.membership.decay()
            if (self.membership.needs_renewal(self.coinbase)
                    and self.mine):
                me = self.membership.get(self.coinbase)
                self._start_registration(renew=me.renewed_times + 1)
            elif self.coinbase not in self.membership and self.registered:
                # our own TTL ran out — typically discovered while
                # replaying blocks missed behind a partition, where the
                # renewal window passed unseen (ref: the node-expiry
                # path, core/geec_state.go:706,1088).  Clear the stale
                # registered flag and rejoin from scratch so the heal
                # ends in clean re-registration, not a silent zombie.
                self.registered = False
                if self.mine and self.transport is not None:
                    self._start_registration(renew=0)

    # ------------------------------------------------------------------
    # registration (ref: Register geec_state.go:706-757)
    # ------------------------------------------------------------------

    def request_registration(self) -> None:  # thread-entry (RPC worker)
        """Public join-request trigger (the thw RPC namespace's Register,
        ref: consensus/geec/api.go)."""
        with self._lock:
            self._start_registration(renew=0)

    def _start_registration(self, renew: int) -> None:
        me = self.membership.get(self.coinbase)
        if me is not None and me.renewed_times >= renew > 0:
            return
        reg = Registration(account=self.coinbase, referee=self.coinbase,
                           ip=self.cfg.consensus_ip,
                           port=str(self.cfg.consensus_port),
                           renew=renew)
        self._registration_tick(reg, attempt=0)

    def _registration_tick(self, reg: Registration, attempt: int) -> None:
        if self.registered and reg.renew == 0:
            return
        self._append_reg_req(reg)  # local pending list too
        if self.transport is not None:
            # transport is None only during construction-time replay
            # (a restarted node re-discovering a pending renewal); the
            # timer below re-sends once the node is live on the net
            self.transport.gossip(M.pack_gossip(M.GOSSIP_REGISTER_REQ, reg))
        self._set_timer("register", self.ccfg.reg_timeout_s,
                        lambda: self._registration_tick(reg, attempt + 1))

    def _append_reg_req(self, reg: Registration) -> None:
        """(ref: AppendRegReq geec_state.go:669-683)"""
        known = self.pending_regs.get(reg.account)
        if (known is not None and known.ip == reg.ip and known.port == reg.port
                and known.renew >= reg.renew):
            return
        if (known is None
                and len(self.pending_regs) >= self.REG_PENDING_MAX):
            # a gossip flood of forged registrations evicts the oldest
            # pending request instead of growing the dict without bound
            self.pending_regs.pop(next(iter(self.pending_regs)))
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            metrics.counter("consensus.reg_req_dropped").inc()
            ledger.charge(drops=1)
        self.pending_regs[reg.account] = reg

    # ------------------------------------------------------------------
    # failure handling: timeout ladder (ref: blockLoop
    # geec_state.go:1140-1180)
    # ------------------------------------------------------------------

    def _arm_block_timeout(self) -> None:
        self._set_timer("block_timeout", self.cfg.block_timeout_s,
                        self._on_block_timeout)

    def _on_block_timeout(self) -> None:
        with self._lock:
            if self.wb.blk_num == 1:
                self._arm_block_timeout()  # no timeout during bootstrap
                return
            if self._timeout_times < 3:
                self._timeout_times += 1
                self._arm_block_timeout()
                self._handle_committee_timeout(self._timeout_times)
            else:
                self._timeout_times = 0
                self._arm_block_timeout()
                self._force_empty_block()

    def _force_empty_block(self) -> None:
        """(ref: HandleBlockTimeout geec_state.go:927-953)"""
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        metrics.counter("consensus.forced_empties").inc()
        empty = self.chain.make_empty_block()
        confirm = ConfirmBlockMsg(block_number=empty.number, hash=empty.hash,
                                  confidence=0, empty_block=True)
        self.empty_block_list.append(empty.number)
        while len(self.empty_block_list) > self.HEIGHT_WINDOW:
            self.empty_block_list.pop(0)
        self.chain.offer(empty.with_confirm(confirm))

    def _handle_committee_timeout(self, version: int) -> None:
        """Re-elect at a higher version then query what happened
        (ref: HandleCommitteeTimeout geec_state.go:1286-1405)."""
        blk_num = self.wb.blk_num
        if not self.is_committee(blk_num, version):
            return
        self._abort_proposal()
        self._try_propose(version)

    # -- query protocol (recovered leader side) -------------------------

    def _start_query(self, blk_num: int, version: int) -> None:
        wb = self.wb
        wb.query_threshold = self.membership.validate_threshold()
        wb.query_replies.clear()
        wb.query_empty_count = 0
        wb.query_nonempty_count = 0
        wb.query_recv_majority = False
        self._phase = VALIDATING  # reuse phase slot for retry gating
        self._query_retry(blk_num, version, 0)

    def _query_retry(self, blk_num: int, version: int, retry: int) -> None:
        if blk_num != self.wb.blk_num or self.wb.query_recv_majority:
            return
        q = QueryBlockMsg(block_number=blk_num, version=version,
                          ip=self.cfg.consensus_ip, retry=retry,
                          port=self.cfg.consensus_port)
        self.transport.gossip(M.pack_gossip(M.GOSSIP_QUERY, q))
        self._set_timer("query", self.ccfg.validate_timeout_ms / 1e3,
                        lambda: self._query_retry(blk_num, version, retry + 1))

    def _handle_query_reply(self, reply: M.QueryReply) -> None:
        """(ref: handleQueryReply geec_state.go:1231-1283).  Same
        acceptor-window gate as the ACK tally: only seeded acceptors may
        count toward the query quorum."""
        wb = self.wb
        if reply.block_num != wb.blk_num or reply.version != wb.max_version:
            return
        seed = self.seed_for(reply.block_num)
        if seed is None or not self.membership.is_acceptor(reply.author, seed):
            return
        lst = wb.query_replies.setdefault(reply.author, [])
        if len(lst) < 2 and all(r.sig != reply.sig for r in lst):
            lst.append(reply)
        if (len(wb.query_replies) >= wb.query_threshold
                and not wb.query_recv_majority):
            if self._signing:
                items = [(r.author, r.signing_hash(), r.sig)
                         for rl in wb.query_replies.values() for r in rl]
                cert = self._verify_quorum(items)
                for a in list(wb.query_replies):
                    if a not in cert:
                        del wb.query_replies[a]
                if len(wb.query_replies) < wb.query_threshold:
                    return  # keep collecting; query retry re-solicits
                wb.query_cert = cert
                # the verified reply per author = the one whose sig the
                # batch recovered
                wb.query_verified = {
                    a: next(r for r in rl if r.sig == cert[a])
                    for a, rl in wb.query_replies.items()}
            else:
                wb.query_verified = {a: rl[0]
                                     for a, rl in wb.query_replies.items()}
            # tally from the verified replies only
            replies = list(wb.query_verified.values())
            wb.query_empty_count = sum(1 for r in replies if r.empty)
            nonempty = [r.block_hash for r in replies if not r.empty]
            if nonempty:
                # majority hash among non-empty answers
                self._query_block_hash = max(set(nonempty),
                                             key=nonempty.count)
            if self._signing:
                # the cert must be coherent: only same-hash answers can
                # certify a non-empty outcome
                wb.query_nonempty_count = (
                    nonempty.count(self._query_block_hash) if nonempty else 0)
            else:
                wb.query_nonempty_count = len(nonempty)
            wb.query_recv_majority = True
            self._cancel_timer("query")
            self._resolve_query(reply.block_num, reply.version)

    def _resolve_query(self, blk_num: int, version: int) -> None:
        """(ref: QUERY_* decision geec_state.go:1339-1398)"""
        wb = self.wb
        head = self.chain.head()
        head_conf = head.confirm.confidence if head.confirm else 0
        def query_cert(members) -> tuple[tuple, tuple]:
            sups = tuple(members)
            sigs = (tuple(wb.query_cert.get(a, b"") for a in sups)
                    if self._signing else ())
            return sups, sigs

        if wb.query_empty_count >= wb.query_threshold:
            # nobody saw a block: confirm an empty one.  The quorum cert
            # is the empty-answering repliers' signatures (version > 0
            # marks it as a query cert for receivers).
            self._phase = IDLE
            empty = self.chain.make_empty_block()
            sups, sigs = query_cert(
                a for a, r in wb.query_verified.items() if r.empty)
            confirm = ConfirmBlockMsg(block_number=blk_num, hash=empty.hash,
                                      confidence=calc_confidence(head_conf),
                                      supporters=sups, empty_block=True,
                                      version=version, supporter_sigs=sigs)
            confirm = dataclasses.replace(
                confirm, sig=self._sign(confirm.signing_hash()))
            self.chain.offer(empty.with_confirm(confirm))
            self.transport.gossip(M.pack_gossip(M.GOSSIP_CONFIRM_BLOCK, confirm))
        elif wb.query_nonempty_count >= wb.query_threshold:
            # majority saw the block: confirm it
            self._phase = IDLE
            sups, sigs = query_cert(
                a for a, r in wb.query_verified.items()
                if not r.empty and r.block_hash == self._query_block_hash)
            confirm = ConfirmBlockMsg(block_number=blk_num,
                                      hash=self._query_block_hash,
                                      confidence=calc_confidence(head_conf),
                                      supporters=sups, empty_block=False,
                                      version=version, supporter_sigs=sigs)
            confirm = dataclasses.replace(
                confirm, sig=self._sign(confirm.signing_hash()))
            pending = self.pending_blocks.get(blk_num)
            if pending is not None and pending.hash == confirm.hash:
                self.chain.offer(pending.with_confirm(confirm))
            self.transport.gossip(M.pack_gossip(M.GOSSIP_CONFIRM_BLOCK, confirm))
        else:
            # mixed: re-run the ACK round for the pending block
            pending = self.pending_blocks.get(blk_num)
            if pending is None:
                self._phase = IDLE
                return
            req = M.ValidateRequest(
                block_num=blk_num, author=self.coinbase, block=pending,
                ip=self.cfg.consensus_ip, port=self.cfg.consensus_port,
                retry=0, version=version,
                empty_list=tuple(self.empty_block_list))
            req = dataclasses.replace(req, sig=self._sign(req.signing_hash()))
            self._proposal = pending
            self._proposal_version = version
            self._ask_for_ack(req)

    # -- query serving (ref: HandleQueryMsg eth/handler.go:897-997) ------

    def _handle_query(self, query: QueryBlockMsg) -> None:
        wb = self.wb
        verdict = wb.classify(query.block_number)
        if verdict == WB_PASSED:
            return
        if verdict == WB_FUTURE:
            self._defer(query.block_number, lambda: self._handle_query(query))
            return
        if query.version < wb.max_version:
            return
        if query.version > wb.max_version:
            self._bump_version(query.version)
            if self._phase in (ELECTING, VALIDATING):
                self._abort_proposal()
        if query.retry <= wb.max_query_retry:
            return
        wb.max_query_retry = query.retry
        self.transport.gossip(M.pack_gossip(M.GOSSIP_QUERY, query))
        if not self.is_acceptor(query.block_number):
            return
        pending = self.pending_blocks.get(query.block_number)
        reply = M.QueryReply(
            block_num=query.block_number, author=self.coinbase,
            version=query.version, retry=query.retry,
            empty=pending is None,
            block_hash=pending.hash if pending is not None else bytes(32))
        reply = dataclasses.replace(reply,
                                    sig=self._sign(reply.signing_hash()))
        self.transport.send_direct(
            query.ip, query.port,
            M.pack_direct(M.UDP_QUERY_REPLY, self.coinbase, reply))
