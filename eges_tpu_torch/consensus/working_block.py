"""Per-height consensus scratchpad.

The port's copy of ``eges_tpu/consensus/working_block.py``, unchanged.

Port of the reference's ``WorkingBlock`` (ref: core/geecCore/geec_wb.go)
minus its mutex/condvar protocol: here exactly one event loop owns the
struct, and the reference's ``Wait(blk)`` (block the goroutine until the
working height catches up, geec_wb.go:118) becomes *deferral* — the node
queues messages addressed to future heights and replays them on
:meth:`advance` (the ``Move``/``Cond.Broadcast`` analogue, geec_wb.go:84).

``my_rand`` is drawn from a per-node deterministic PRNG seeded by the
coinbase (geec_wb.go:66-68), so election tie-breaks are reproducible in
the simulator.
"""

from __future__ import annotations

import random

# Election states (ref: core/geecCore/geec_wb.go:14-18)
ELEC_CANDIDATE = 0x01
ELEC_VOTED = 0x02
ELEC_ELECTED = 0x03

# Wait verdicts (ref: geec_wb.go:74-78)
WB_PASSED = 0x00
WB_CURRENT = 0x01
WB_FUTURE = 0x02  # caller must defer (reference blocks instead)


class WorkingBlock:
    def __init__(self, coinbase: bytes):
        self.coinbase = coinbase
        self._rng = random.Random(int.from_bytes(coinbase[-8:], "big"))
        self.blk_num = 0
        self.advance(1)

    def advance(self, blk_num: int) -> None:
        """(ref: Move, geec_wb.go:84-106)"""
        self.blk_num = blk_num
        self.max_version = -1
        self.max_validate_retry = -1
        self.max_query_retry = -1
        # election
        self.elect_state = ELEC_CANDIDATE
        self.supporters: set[bytes] = set()
        # signed-vote mode: up to 2 distinct (signing_hash, sig) entries
        # per claimed voter, batch-verified when the threshold is reached
        # — multiple entries so a spoofed garbage-sig vote can neither
        # squat the slot nor overwrite the genuine one
        self.supporter_votes: dict[bytes, list[tuple[bytes, bytes]]] = {}
        self.my_rand = self._rng.getrandbits(64)
        self.delegator: bytes = self.coinbase
        self.delegator_ip: str = ""
        self.delegator_port: int = 0
        self.max_election_retry = 0
        self.n_candidates = 0
        self.election_threshold = 1 << 62
        # validation (proposer side) — up to 2 distinct stored replies per
        # claimed author (see supporter_votes note)
        self.is_proposer = False
        self.validate_replies: dict[bytes, list] = {}  # addr -> [ValidateReply]
        self.validate_threshold = 1 << 62
        self.validate_succeeded = False
        # signed-vote mode: the verified ACK signature per supporter,
        # harvested at quorum time — becomes the confirm's quorum cert
        self.validate_cert: dict[bytes, bytes] = {}
        # query (recovery side)
        self.query_replies: dict[bytes, list] = {}  # addr -> [QueryReply]
        # quorum-verified reply and signature per author (set at tally)
        self.query_verified: dict[bytes, object] = {}
        self.query_cert: dict[bytes, bytes] = {}
        self.query_empty_count = 0
        self.query_nonempty_count = 0
        self.query_threshold = 1 << 62
        self.query_recv_majority = False

    def classify(self, blk_num: int) -> int:
        """Old / current / future for an incoming message's height
        (the Wait() verdict, geec_wb.go:118-135)."""
        if blk_num < self.blk_num:
            return WB_PASSED
        if blk_num == self.blk_num:
            return WB_CURRENT
        return WB_FUTURE

    def bump_version(self, version: int) -> None:
        """Entering a higher re-election version resets retry dedup
        (ref: election_go.go:49-55, handler.go:917-922)."""
        if version > self.max_version:
            self.max_version = version
            self.max_query_retry = -1
            self.max_validate_retry = -1
            self.elect_state = ELEC_CANDIDATE
            self.supporters.clear()
            self.supporter_votes.clear()
