"""Deterministic in-process multi-node simulator.

The port's copy of ``eges_tpu/sim/simnet.py``, unchanged but for its
imports.

The analogue of the reference's ``p2p/simulations`` framework (SURVEY §4:
"in-memory net or exec'd nodes ... NOT used for Geec" — the fork only
ever tested Geec with real clusters + log grepping).  This build makes
the deterministic simulator the *primary* consensus test vehicle: virtual
time, seeded latency/loss, full-mesh gossip and addressed direct
datagrams, every run reproducible from its seed.

* :class:`SimClock` — a heap of (due, seq, fn) callbacks; ``run_until``
  executes them in timestamp order, advancing virtual time instantly.
* :class:`SimNet` — in-memory transports: ``gossip`` fans out to every
  other node's gossip inbox (the RLPx/TCP plane), ``send_direct``
  delivers to the (ip, port) owner (the raw-UDP plane).  Configurable
  per-message latency jitter and drop rate model the planes' real
  characteristics (UDP loss is what the reference's retry ladders exist
  for).
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass

from eges_tpu_torch.utils import ledger


class _Timer:
    __slots__ = ("fn", "cancelled")

    def __init__(self, fn):
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class SimClock:
    def __init__(self, start: float = 0.0):
        self._now = start
        self._heap: list = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    def call_later(self, delay_s: float, fn) -> _Timer:
        t = _Timer(fn)
        heapq.heappush(self._heap, (self._now + max(delay_s, 0.0),
                                    next(self._seq), t))
        return t

    def run_until(self, deadline: float, stop_condition=None) -> None:
        """Execute due callbacks in order until virtual ``deadline``."""
        while self._heap and self._heap[0][0] <= deadline:
            due, _, timer = heapq.heappop(self._heap)
            self._now = due
            if not timer.cancelled:
                timer.fn()
            if stop_condition is not None and stop_condition():
                return
        self._now = max(self._now, deadline)

    def pending(self) -> int:
        return sum(1 for _, _, t in self._heap if not t.cancelled)


class SkewedClock:
    """Per-node clock view over a shared :class:`SimClock`.

    Models a skewed local oscillator: ``now()`` is offset by ``skew_s``
    (mutable mid-run — the fault layer's clock-skew action), while
    timers still fire on the shared virtual timeline, so a skewed node
    mis-timestamps blocks/journal rows without desynchronizing the
    event heap."""

    def __init__(self, base: SimClock, skew_s: float = 0.0):
        self._base = base
        self.skew_s = skew_s

    def now(self) -> float:
        return self._base.now() + self.skew_s

    def call_later(self, delay_s: float, fn) -> _Timer:
        return self._base.call_later(delay_s, fn)


@dataclass
class LinkRule:
    """Per-(sender, receiver) delivery overrides — one DIRECTION of a
    link, so ``A -> B`` can drop while ``B -> A`` flows (the asymmetric
    partition the symmetric ``SimNet.partition`` cannot express).
    ``None`` fields fall back to the net-wide defaults."""

    blocked: bool = False
    drop_rate: float | None = None
    latency_s: float | None = None
    jitter_s: float | None = None
    duplicate_rate: float = 0.0
    reorder_rate: float = 0.0
    reorder_max_s: float = 0.05
    corrupt_rate: float = 0.0


class SimTransport:
    """Per-node transport handle bound to a :class:`SimNet`."""

    def __init__(self, net: "SimNet", node_id: str):
        self._net = net
        self.node_id = node_id

    def gossip(self, data: bytes) -> None:
        from eges_tpu_torch.utils import tracing
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        data = tracing.inject_current(data)
        metrics.counter("net.gossip_bytes").inc(len(data))
        metrics.counter("net.gossip_msgs").inc()
        self._net.deliver_gossip(self.node_id, data)

    def send_direct(self, ip: str, port: int, data: bytes) -> None:
        from eges_tpu_torch.utils import tracing
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        data = tracing.inject_current(data)
        metrics.counter("net.direct_bytes").inc(len(data))
        metrics.counter("net.direct_msgs").inc()
        self._net.deliver_direct(self.node_id, (ip, port), data)


class SimNet:
    def __init__(self, clock: SimClock, *, seed: int = 0,
                 latency_s: float = 0.002, jitter_s: float = 0.002,
                 drop_rate: float = 0.0):
        self.clock = clock
        self.rng = random.Random(seed)
        self.latency_s = latency_s
        self.jitter_s = jitter_s
        self.drop_rate = drop_rate
        # net-wide fault knobs (the per-link LinkRule overrides these)
        self.corrupt_rate = 0.0
        self.duplicate_rate = 0.0
        self.reorder_rate = 0.0
        self.reorder_max_s = 0.05
        self._gossip_sinks: dict[str, object] = {}   # node_id -> fn(bytes)
        self._direct_sinks: dict[tuple, object] = {}  # (ip, port) -> fn(bytes)
        self._partitioned: set[str] = set()
        self._links: dict[tuple[str, str], LinkRule] = {}
        self.stats = {"gossip": 0, "direct": 0, "dropped": 0,
                      "dead_letter": 0, "corrupted": 0, "duplicated": 0,
                      "reordered": 0, "gossip_bytes": 0, "direct_bytes": 0}

    def join(self, node_id: str, ip: str, port: int, on_gossip, on_direct):
        transport = SimTransport(self, node_id)
        self._gossip_sinks[node_id] = on_gossip
        self._direct_sinks[(ip, port)] = (node_id, on_direct)
        return transport

    def leave(self, node_id: str) -> None:
        """Unbind a node from both planes (crash injection): its sends
        vanish, and datagrams already in flight toward it arrive at a
        closed port."""
        self._gossip_sinks.pop(node_id, None)
        for addr in [a for a, (nid, _) in self._direct_sinks.items()
                     if nid == node_id]:
            del self._direct_sinks[addr]

    def partition(self, node_id: str) -> None:
        """Cut a node off both planes (crash/partition injection)."""
        self._partitioned.add(node_id)

    def heal(self, node_id: str) -> None:
        self._partitioned.discard(node_id)

    # -- per-link rules (asymmetric: (src, dst) is one direction) ---------

    def set_link(self, src: str, dst: str, **overrides) -> LinkRule:
        """Create or update the ``src -> dst`` rule; the reverse
        direction is untouched (asymmetric by construction)."""
        rule = self._links.setdefault((src, dst), LinkRule())
        for k, v in overrides.items():
            if not hasattr(rule, k):
                raise TypeError(f"unknown link override: {k!r}")
            setattr(rule, k, v)
        return rule

    def block_link(self, src: str, dst: str) -> None:
        """Drop everything ``src -> dst`` while ``dst -> src`` flows."""
        self.set_link(src, dst, blocked=True)

    def clear_link(self, src: str, dst: str) -> None:
        self._links.pop((src, dst), None)

    def _delay(self) -> float:
        return self.latency_s + self.rng.random() * self.jitter_s

    def _dropped(self) -> bool:
        return self.drop_rate > 0 and self.rng.random() < self.drop_rate

    def _mangle(self, data: bytes) -> bytes:
        """Deterministic datagram corruption: truncate or flip one bit.
        Receivers must reject it in decode/auth — never crash."""
        if len(data) < 2 or self.rng.random() < 0.5:
            return data[: max(1, len(data) // 2)]
        i = self.rng.randrange(len(data))
        return data[:i] + bytes([data[i] ^ (1 << self.rng.randrange(8))]) \
            + data[i + 1:]

    def _send(self, src: str, dst: str, data: bytes, plane: str,
              fire) -> None:
        """One directed delivery decision: link rule -> drop -> delay ->
        corruption/reorder/duplication.  All randomness draws from the
        one seeded rng, in a fixed order, so a fault plan replays
        bit-identically; with no faults configured the rng stream is
        exactly the legacy drop+delay sequence."""
        rule = self._links.get((src, dst))
        if rule is not None and rule.blocked:
            self.stats["dropped"] += 1
            return
        drop = (rule.drop_rate if rule is not None
                and rule.drop_rate is not None else self.drop_rate)
        if drop > 0 and self.rng.random() < drop:
            self.stats["dropped"] += 1
            return
        lat = (rule.latency_s if rule is not None
               and rule.latency_s is not None else self.latency_s)
        jit = (rule.jitter_s if rule is not None
               and rule.jitter_s is not None else self.jitter_s)
        delay = lat + self.rng.random() * jit
        corrupt = rule.corrupt_rate if rule is not None \
            and rule.corrupt_rate else self.corrupt_rate
        if corrupt and self.rng.random() < corrupt:
            data = self._mangle(data)
            self.stats["corrupted"] += 1
        reorder = rule.reorder_rate if rule is not None \
            and rule.reorder_rate else self.reorder_rate
        reorder_max = rule.reorder_max_s if rule is not None \
            else self.reorder_max_s
        if reorder and self.rng.random() < reorder:
            # bounded reordering: a late copy overtakes nothing beyond
            # the window, mirroring real UDP queue churn
            delay += self.rng.random() * reorder_max
            self.stats["reordered"] += 1
        dup = rule.duplicate_rate if rule is not None \
            and rule.duplicate_rate else self.duplicate_rate
        if dup and self.rng.random() < dup:
            self.stats["duplicated"] += 1
            extra = delay + self.rng.random() * reorder_max
            self.clock.call_later(extra,
                                  (lambda f, d: lambda: f(d))(fire, data))
        self.stats[plane] += 1
        self.stats[plane + "_bytes"] += len(data)
        self.clock.call_later(delay,
                              (lambda f, d: lambda: f(d))(fire, data))

    def deliver_gossip(self, sender_id: str, data: bytes) -> None:
        if sender_id in self._partitioned \
                or sender_id not in self._gossip_sinks:
            return
        for node_id in list(self._gossip_sinks):
            if node_id == sender_id or node_id in self._partitioned:
                continue
            self._send(sender_id, node_id, data, "gossip",
                       (lambda nid, src:
                        lambda d: self._fire_gossip(nid, d, src))
                       (node_id, sender_id))

    def deliver_gossip_many(self, sender_id: str, frames) -> None:
        """Inject one WINDOW of gossip datagrams from a (possibly
        external) sender in a single call — the wire-speed ingest
        test/chaos idiom.  Each frame rides the normal per-datagram
        fault model (drop/corrupt/duplicate/reorder), so a window
        injection is byte-identical to the equivalent loop of
        :meth:`deliver_gossip` calls."""
        for data in frames:
            self.deliver_gossip(sender_id, data)

    def _fire_gossip(self, node_id: str, data: bytes,  # ingress-entry
                     sender_id: str = "") -> None:
        # delivery-time lookup: the receiver may have crashed (left the
        # net) while this datagram was in flight
        sink = self._gossip_sinks.get(node_id)
        if sink is None:
            self.stats["dropped"] += 1
            return
        # provenance stamp: the receiving node's entry point reads the
        # delivering peer (utils/ledger.py) to tag ingress cost
        with ledger.peer(sender_id):  # bounded-by: _ORIGIN_MAX (ledger.peer clamps)
            sink(data)

    def deliver_direct(self, sender_id: str, addr: tuple, data: bytes) -> None:
        if sender_id in self._partitioned:
            return
        entry = self._direct_sinks.get(addr)
        if entry is None:
            # dead letter, like a UDP datagram to a closed port — now
            # counted, so chaos reports can see retries hitting a
            # crashed node's port
            self.stats["dead_letter"] += 1
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            metrics.counter("net.dead_letters").inc()
            return
        node_id, _sink = entry
        if node_id in self._partitioned:
            self.stats["dropped"] += 1
            return
        self._send(sender_id, node_id, data, "direct",
                   (lambda a, src: lambda d: self._fire_direct(a, d, src))
                   (addr, sender_id))

    def _fire_direct(self, addr: tuple, data: bytes,  # ingress-entry
                     sender_id: str = "") -> None:
        entry = self._direct_sinks.get(addr)
        if entry is None:
            self.stats["dead_letter"] += 1
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics
            metrics.counter("net.dead_letters").inc()
            return
        with ledger.peer(sender_id):  # bounded-by: _ORIGIN_MAX (ledger.peer clamps)
            entry[1](data)
