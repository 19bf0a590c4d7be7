"""Membership registry: the sorted candidate list, seeded committee /
acceptor windows, and the TTL economy.

The port's copy of ``eges_tpu/consensus/membership.py``: the election
window check uses the port's ``crypto/native.py``.

Semantics ported from the reference's treemap-based membership
(ref: core/geec_state.go:325-521,770-861,1088-1129), re-expressed as a
plain sorted structure owned by one event loop (no locks — the reference
enforces "call with lock held" by comment, SURVEY §5 flags that as the
fragility to remove).

Window rule (ref: getAllCommittee, geec_state.go:358-419): members sorted
by address; ``start = seed % size``; if the window fits, take
``[start, start+n)``; if it wraps, take ``[0, n-size+start)`` plus
``[start, size)``.  The same rule with ``n_candidates`` gives the
committee (proposer-electable set) and with ``n_acceptors`` the validator
set.  If fewer members than ``n`` exist, everyone is in.

Versioned re-election derives a new seed from the base seed —
``float64(seed) ** version`` in the reference (geec_state.go:700,
IsCommittee uses ``version+1``, ElectForProposer uses ``version``; the two
disagree there — a reference inconsistency).  Here both sides use ONE
transform so recovered leaders always know they are committee members:
``derive_seed(seed, version)``, identical on every node.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class Member:
    """(ref: core/geecCore/Types.go:9-17 GeecMember)"""

    addr: bytes
    ip: str
    port: int
    referee: bytes = b""
    joined_block: int = 0
    ttl: int = 0
    renewed_times: int = 0


def derive_seed(seed: int, version: int) -> int:
    """Seed for version>0 re-elections.  Integer arithmetic (not the
    reference's float64 ``math.Pow``, which loses precision above 2^53 and
    differs between call sites); deterministic on every host."""
    if version == 0:
        return seed
    return pow(seed, version + 1, (1 << 64) - 59)  # largest 64-bit prime


class Membership:
    """Sorted-by-address member registry with window selection and TTL."""

    def __init__(self, n_candidates: int, n_acceptors: int, *,
                 initial_ttl: int = 50, bonus_ttl: int = 20,
                 renew_ttl_threshold: int = 20, max_ttl: int = 50,
                 ttl_interval: int = 10):
        self.n_candidates = n_candidates
        self.n_acceptors = n_acceptors
        self.initial_ttl = initial_ttl
        self.bonus_ttl = bonus_ttl
        self.renew_ttl_threshold = renew_ttl_threshold
        self.max_ttl = max_ttl
        self.ttl_interval = ttl_interval
        self._members: dict[bytes, Member] = {}
        self._sorted_addrs: list[bytes] = []
        self._flat: bytes | None = None  # packed sorted addrs (native path)
        # owning GeecNode attaches its event journal (utils/journal.py)
        # so the TTL economy shows up in the consensus observatory
        self.journal = None

    def _record(self, type: str, **attrs) -> None:
        if self.journal is not None:
            self.journal.record(type, **attrs)

    def _update_gauges(self) -> None:
        from eges_tpu_torch.utils import metrics

        metrics.DEFAULT.gauge("membership.size").set(len(self._members))
        min_ttl = min((m.ttl for m in self._members.values()), default=0)
        metrics.DEFAULT.gauge("membership.min_ttl").set(min_ttl)

    # -- registry ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, addr: bytes) -> bool:
        return addr in self._members

    def get(self, addr: bytes) -> Member | None:
        return self._members.get(addr)

    def members(self) -> list[Member]:
        return [self._members[a] for a in self._sorted_addrs]

    def add(self, member: Member) -> None:
        """Insert or renew (ref: AddGeecMember geec_state.go:326-353 —
        renewal stacks TTL up to max_ttl)."""
        existing = self._members.get(member.addr)
        if existing is not None:
            existing.renewed_times = member.renewed_times
            existing.ttl = min(existing.ttl + member.ttl, self.max_ttl)
            existing.ip = member.ip or existing.ip
            existing.port = member.port or existing.port
            self._record("member_renewed", addr=member.addr.hex()[:8],
                         ttl=existing.ttl)
            self._update_gauges()
            return
        self._members[member.addr] = member
        bisect.insort(self._sorted_addrs, member.addr)
        self._flat = None
        self._record("member_registered", addr=member.addr.hex()[:8],
                     ttl=member.ttl, joined_block=member.joined_block)
        self._update_gauges()

    def remove(self, addr: bytes) -> None:
        if addr in self._members:
            del self._members[addr]
            self._sorted_addrs.remove(addr)
            self._flat = None
            self._update_gauges()

    # -- windows ----------------------------------------------------------

    def _window(self, seed: int, n: int) -> list[bytes]:
        size = len(self._sorted_addrs)
        if size == 0:
            return []
        if size < n:
            return list(self._sorted_addrs)
        start = seed % size
        if start + n > size:
            head = self._sorted_addrs[: n - size + start]
            tail = self._sorted_addrs[start:]
            return head + tail
        return self._sorted_addrs[start : start + n]

    def committee(self, seed: int, version: int = 0) -> list[Member]:
        """Proposer-electable window (ref: getAllCommittee)."""
        addrs = self._window(derive_seed(seed, version), self.n_candidates)
        return [self._members[a] for a in addrs]

    def _window_check(self, addr: bytes, seed: int, n: int) -> bool:
        """Membership-in-window check; native binary search when the
        C++ election component is built (native/election.cpp — the
        reference's own measured hot spot, its --breakdown logs
        "ChecMembership Time", core/geec_state.go:1092)."""
        from eges_tpu_torch.crypto import native

        size = len(self._sorted_addrs)
        if size == 0:
            return False
        if native.has_election():
            if self._flat is None:
                self._flat = b"".join(self._sorted_addrs)
            return native.window_check(self._flat, size, seed % size, n,
                                       addr)
        return addr in self._window(seed, n)

    def is_committee(self, addr: bytes, seed: int, version: int = 0) -> bool:
        """(ref: IsCommittee geec_state.go:770-861)"""
        if addr not in self._members:
            return False
        return self._window_check(addr, derive_seed(seed, version),
                                  self.n_candidates)

    def acceptors(self, seed: int) -> list[Member]:
        addrs = self._window(seed, self.n_acceptors)
        return [self._members[a] for a in addrs]

    def is_acceptor(self, addr: bytes, seed: int) -> bool:
        """(ref: IsValidator geec_state.go:439-521)"""
        if addr not in self._members:
            return False
        return self._window_check(addr, seed, self.n_acceptors)

    def acceptor_count(self) -> int:
        """(ref: getAcceptorCount geec_state.go:421-428)"""
        return min(len(self._members), self.n_acceptors)

    # -- thresholds (ref: geec_state.go:651, election_go.go:66) -----------

    def validate_threshold(self) -> int:
        """ceil((acceptors + 1) / 2) — proposer needs this many ACKs."""
        n = self.acceptor_count()
        return -(-(n + 1) // 2)

    def election_threshold(self, n_committee: int) -> int:
        """ceil((committee + 1) / 2) - 1 votes (self-vote is implicit)."""
        return -(-(n_committee + 1) // 2) - 1

    # -- TTL economy (ref: CheckMembership geec_state.go:1088-1129) --------

    def reward(self, addrs) -> None:
        """Bonus TTL for a confirmed block's supporters + proposer."""
        for addr in addrs:
            m = self._members.get(addr)
            if m is not None:
                m.ttl = min(m.ttl + self.bonus_ttl, self.max_ttl)
        self._update_gauges()

    def decay(self) -> list[bytes]:
        """Periodic TTL decay + eviction; returns evicted addresses.
        Call every ``ttl_interval`` blocks."""
        evicted = []
        for addr in list(self._sorted_addrs):
            m = self._members[addr]
            if m.ttl <= self.ttl_interval:
                self.remove(addr)
                evicted.append(addr)
                self._record("member_expired", addr=addr.hex()[:8])
            else:
                m.ttl -= self.ttl_interval
        self._update_gauges()
        return evicted

    def needs_renewal(self, addr: bytes) -> bool:
        m = self._members.get(addr)
        return m is not None and m.ttl <= self.renew_ttl_threshold
