"""Peer discovery: bootnode registry + announce/lookup client.

The port's copy of ``eges_tpu/net/discovery.py``, unchanged but for its
imports; the packets are byte-equal to the reference's for the same key
and seq.

The permissioned-network replacement for the reference's Kademlia UDP
discovery (ref: p2p/discover/udp.go, p2p/discover/table.go) and its
``bootnode`` binary (ref: cmd/bootnode/main.go).  A full DHT is the
wrong tool for a committee-scale permissioned chain, so this is
Kademlia-lite: nodes ANNOUNCE themselves to one or more bootnodes
(signed, TTL'd) and poll GET_PEERS for a sample of live endpoints,
which feeds :meth:`GossipPlane.add_peer` — making ``--peers`` optional
(a node joins knowing only a bootnode).

Wire format (UDP, RLP):
    [code, payload...] with
    ANNOUNCE  = [0x01, pubkey64, gossip_ip, gossip_port,
                 consensus_ip, consensus_port, expiry_be, sig65]
                 sig over keccak(rlp([pubkey, gip, gport, cip, cport,
                 expiry])) — identity = address(pubkey)
    GET_PEERS = [0x02, nonce8]
    PEERS     = [0x03, nonce8, [[addr20, gip, gport, cip, cport], ...]]
    ENR_ANNOUNCE = [0x04, record]      signed node record (net/enr.py)
    GET_RECORDS  = [0x05, nonce8]
    RECORDS      = [0x06, nonce8, [record, ...]]

Bootnodes verify announce signatures and expiry, evict stale entries,
and never relay more than ``SAMPLE`` peers per query.  The record path
(codes 4-6) is the upgrade of the ad-hoc signed tuple: the bootnode
keeps the highest-``seq`` record per identity and lookups return the
peer's own signed statement, so a compromised bootnode cannot forge
endpoints — it can only withhold (ref: p2p/enr, p2p/discover/v4_udp.go
ENRRequest).  Both announce paths run endpoint sanity + per-subnet
caps from net/netutil.py (ref: p2p/netutil).
"""

from __future__ import annotations

import asyncio
import time

from eges_tpu_torch.core import rlp
from eges_tpu_torch.crypto.keccak import keccak256
from eges_tpu_torch.utils.log import get_logger

# hostile/malformed datagrams are routine on an open UDP port: dropped
# at GDBUG so default verbosity stays quiet but a -v5 run shows them
log = get_logger("discovery")
from eges_tpu_torch.net import enr as enrlib
from eges_tpu_torch.net import netutil

ANNOUNCE = 1
GET_PEERS = 2
PEERS = 3
ENR_ANNOUNCE = 4
GET_RECORDS = 5
RECORDS = 6

ANNOUNCE_TTL_S = 60.0
SAMPLE = 16


def _sign_announce(priv: bytes, pub: bytes, gip: str, gport: int,
                   cip: str, cport: int, expiry: int) -> bytes:
    from eges_tpu_torch.crypto import secp256k1 as secp

    h = keccak256(rlp.encode([pub, gip.encode(), gport, cip.encode(),
                              cport, expiry]))
    return secp.ecdsa_sign(h, priv)


def encode_announce(priv: bytes, pub: bytes, gip: str, gport: int,
                    cip: str, cport: int,
                    now: float | None = None) -> bytes:
    expiry = int((now if now is not None else time.time()) + ANNOUNCE_TTL_S)
    sig = _sign_announce(priv, pub, gip, gport, cip, cport, expiry)
    return rlp.encode([ANNOUNCE, pub, gip.encode(), gport, cip.encode(),
                       cport, expiry, sig])


class BootnodeService:
    """UDP peer registry (the cmd/bootnode role).

    ``python -m eges_tpu_torch.bootnode --port 30301`` runs one standalone.
    """

    def __init__(self, bind_ip: str, port: int, *,
                 authorize=None, clock=time.time,
                 subnet_limit: int = 16):
        self.bind_ip = bind_ip
        self.port = port
        self.authorize = authorize  # callable(addr20) -> bool
        self.clock = clock
        # addr -> (gip, gport, cip, cport, expires_at)
        self.registry: dict[bytes, tuple] = {}
        # addr -> highest-seq verified Record for ENR announcers
        self.records: dict[bytes, enrlib.Record] = {}
        self._netset = netutil.DistinctNetSet(24, subnet_limit)
        self._transport = None

    # -- message handling (transport-independent, sim-testable) ----------

    def handle(self, data: bytes, reply) -> None:
        """``reply(bytes)`` sends back to the datagram source."""
        # one hostile datagram must never take down the registry, even
        # for direct (transportless) embeddings of handle(): the whole
        # dispatch is guarded, not just the RLP parse
        try:
            item = rlp.decode(data)
            code = rlp.decode_uint(item[0])
            now = self.clock()
            if code == ANNOUNCE:
                self._on_announce(item, now)
            elif code == ENR_ANNOUNCE and len(item) >= 2:
                self._on_enr_announce(bytes(item[1]), now)
            elif code == GET_PEERS and len(item) >= 2:
                self._evict(now)
                peers = [[a, gip.encode(), gp, cip.encode(), cp]
                         for a, (gip, gp, cip, cp, _) in
                         self._sample(self.registry)]
                reply(rlp.encode([PEERS, bytes(item[1]), peers]))
            elif code == GET_RECORDS and len(item) >= 2:
                self._evict(now)
                recs = [r.encode() for _, r in self._sample(self.records)]
                reply(rlp.encode([RECORDS, bytes(item[1]), recs]))
        except Exception as exc:
            log.gdbug("bootnode dropped datagram", nbytes=len(data),
                      err=repr(exc))
            return

    @staticmethod
    def _sample(table: dict) -> list:
        import random

        entries = list(table.items())
        if len(entries) > SAMPLE:
            # a RANDOM sample, not the first insertion-ordered slice:
            # otherwise members past the first SAMPLE are never
            # advertised and late joiners only ever learn one subset
            entries = random.sample(entries, SAMPLE)
        return entries

    def _on_announce(self, item: list, now: float) -> None:
        from eges_tpu_torch.crypto import secp256k1 as secp

        try:
            _, pub, gip, gport, cip, cport, expiry, sig = item
            pub, sig = bytes(pub), bytes(sig)
            gip, cip = bytes(gip).decode(), bytes(cip).decode()
            gport, cport = rlp.decode_uint(gport), rlp.decode_uint(cport)
            expiry = rlp.decode_uint(expiry)
        except Exception as exc:
            log.gdbug("bootnode dropped malformed announce", err=repr(exc))
            return
        if expiry < now:
            return  # stale/replayed announce
        h = keccak256(rlp.encode([pub, gip.encode(), gport, cip.encode(),
                                  cport, expiry]))
        try:
            signer = secp.recover_address(h, sig)
        except Exception as exc:
            log.gdbug("bootnode dropped announce: bad signature",
                      err=repr(exc))
            return
        if signer != secp.pubkey_to_address(pub):
            return
        self._admit(signer, gip, gport, cip, cport, now)

    def _on_enr_announce(self, data: bytes, now: float) -> None:
        try:
            rec = enrlib.Record.decode(data)
        except enrlib.ENRError:
            return
        prev = self.records.get(rec.addr)
        if prev is not None:
            if rec.seq < prev.seq:
                return  # stale record
            if rec.seq == prev.seq and rec != prev:
                return  # conflicting content under one seq: keep first
            # identical record re-announced: fall through, refresh TTL
        gep, cep = rec.gossip_endpoint(), rec.consensus_endpoint()
        if gep is None or cep is None:
            return
        if self._admit(rec.addr, gep[0], gep[1], cep[0], cep[1], now):
            self.records[rec.addr] = rec

    def _admit(self, addr: bytes, gip: str, gport: int,
               cip: str, cport: int, now: float) -> bool:
        if not (netutil.good_endpoint(gip, gport)
                and netutil.good_endpoint(cip, cport)):
            return False
        if self.authorize is not None and not self.authorize(addr):
            return False
        old = self.registry.get(addr)
        if old is None or old[0] != gip:
            # release the identity's old slot BEFORE claiming the new
            # one: a node moving within an at-cap /24 must not be
            # bounced by its own old address (restore on failure)
            if old is not None:
                self._netset.remove(old[0])
            if not self._netset.add(gip):
                if old is not None:
                    self._netset.add(old[0])
                return False  # this /24 already holds its share
        self.registry[addr] = (gip, gport, cip, cport,
                               now + ANNOUNCE_TTL_S)
        return True

    def _evict(self, now: float) -> None:
        for a, rec in list(self.registry.items()):
            if rec[4] < now:
                self._netset.remove(rec[0])
                del self.registry[a]
                self.records.pop(a, None)

    # -- asyncio UDP server ----------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()

        service = self

        class _Proto(asyncio.DatagramProtocol):
            def connection_made(self, transport):
                self.transport = transport

            def datagram_received(self, data, addr):
                try:
                    service.handle(
                        data, lambda out: self.transport.sendto(out, addr))
                except Exception as exc:
                    # handle() guards its own parse; this catches reply
                    # transmit failures (transport mid-close etc.)
                    log.gdbug("bootnode reply failed", peer=str(addr),
                              err=repr(exc))

        self._transport, _ = await loop.create_datagram_endpoint(
            _Proto, local_addr=(self.bind_ip, self.port))

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()


class DiscoveryClient:
    """Announce/lookup loop against one or more bootnodes.

    Re-announces every ``interval_s`` (half the TTL), queries for peers,
    and calls ``on_peer(addr20, gossip_endpoint, consensus_endpoint)``
    for every newly-learned member — the NodeService wires this into
    ``GossipPlane.add_peer``.
    """

    def __init__(self, bootnodes: list[tuple[str, int]], priv: bytes,
                 gip: str, gport: int, cip: str, cport: int, *,
                 on_peer=None, interval_s: float = ANNOUNCE_TTL_S / 2):
        from eges_tpu_torch.crypto import secp256k1 as secp

        self.bootnodes = list(bootnodes)
        self.priv = priv
        self.pub = secp.privkey_to_pubkey(priv)
        self.me = secp.pubkey_to_address(self.pub)
        self.endpoint = (gip, gport, cip, cport)
        # the node's own signed record.  seq must outrank every record
        # this identity ever announced before — a restart with a new
        # endpoint would otherwise be rejected as stale forever — so
        # without persistent state, wall-clock seconds is the seq (ref:
        # p2p/enr seq counters are persisted; geth's discv4 uses the
        # same timestamp trick for endpoint proofs)
        self.record = enrlib.Record.sign(
            priv, int(time.time()), ip=gip, tcp=gport, udp=cport, cip=cip)
        self.on_peer = on_peer
        self.interval_s = interval_s
        self.known: dict[bytes, tuple] = {}
        self.known_seq: dict[bytes, int] = {}
        self._transport = None
        self._task = None

    def _on_datagram(self, data: bytes) -> None:
        try:
            item = rlp.decode(data)
            code = rlp.decode_uint(item[0])
        except Exception as exc:
            log.gdbug("client dropped malformed datagram",
                      nbytes=len(data), err=repr(exc))
            return
        if code == RECORDS:
            try:
                recs = item[2]
            except Exception as exc:
                log.gdbug("client dropped truncated RECORDS", err=repr(exc))
                return
            for raw in recs:
                try:
                    self._on_record(bytes(raw))
                except Exception as exc:
                    # one bad record must not shadow the rest
                    log.gdbug("client skipped bad record", err=repr(exc))
                    continue
            return
        if code != PEERS:
            return
        try:
            peers = item[2]
        except Exception as exc:
            log.gdbug("client dropped truncated PEERS", err=repr(exc))
            return
        for p in peers:
            try:
                addr = bytes(p[0])
                gip, gport = bytes(p[1]).decode(), rlp.decode_uint(p[2])
                cip, cport = bytes(p[3]).decode(), rlp.decode_uint(p[4])
            except Exception as exc:
                log.gdbug("client skipped bad peer entry", err=repr(exc))
                continue
            self._learn(addr, gip, gport, cip, cport, seq=0)

    def _on_record(self, raw: bytes) -> None:
        try:
            rec = enrlib.Record.decode(raw)
        except enrlib.ENRError:
            return
        gep, cep = rec.gossip_endpoint(), rec.consensus_endpoint()
        if gep is None or cep is None:
            return
        self._learn(rec.addr, gep[0], gep[1], cep[0], cep[1],
                    seq=rec.seq)

    def _learn(self, addr: bytes, gip: str, gport: int,
               cip: str, cport: int, *, seq: int) -> None:
        if addr == self.me:
            return
        if not (netutil.good_endpoint(gip, gport)
                and netutil.good_endpoint(cip, cport)):
            return
        if addr in self.known:
            # a signed record with a higher seq may move a known peer's
            # endpoint; the unsigned legacy tuple (seq=0) never does
            if seq <= self.known_seq.get(addr, 0) \
                    or self.known[addr] == (gip, gport, cip, cport):
                return
        self.known[addr] = (gip, gport, cip, cport)
        self.known_seq[addr] = seq
        if self.on_peer is not None:
            self.on_peer(addr, (gip, gport), (cip, cport))

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _ClientProto(self._on_datagram), local_addr=("0.0.0.0", 0))
        self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        import secrets as _secrets

        rounds = 0
        while True:
            gip, gport, cip, cport = self.endpoint
            ann = encode_announce(self.priv, self.pub, gip, gport, cip, cport)
            enr_ann = rlp.encode([ENR_ANNOUNCE, self.record.encode()])
            query = rlp.encode([GET_PEERS, _secrets.token_bytes(8)])
            rquery = rlp.encode([GET_RECORDS, _secrets.token_bytes(8)])
            for bn in self.bootnodes:
                try:
                    # both generations: records are preferred, the
                    # legacy tuple keeps mixed clusters converging
                    self._transport.sendto(enr_ann, bn)
                    self._transport.sendto(ann, bn)
                    self._transport.sendto(rquery, bn)
                    self._transport.sendto(query, bn)
                except Exception as exc:
                    # a dead/unresolvable bootnode must not stall the
                    # announce loop for the remaining ones
                    log.gdbug("announce to bootnode failed", bootnode=bn,
                              err=repr(exc))
            rounds += 1
            # fast-start: tight announce/lookup rounds until the mesh
            # forms (peers only learn each other after BOTH have
            # announced — a cold cluster on the steady cadence would
            # take ~interval_s to converge), then settle down
            await asyncio.sleep(1.0 if rounds < 8 else self.interval_s)

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self._transport is not None:
            self._transport.close()


class _ClientProto(asyncio.DatagramProtocol):
    def __init__(self, on_datagram):
        self._on = on_datagram

    def datagram_received(self, data, addr):
        try:
            self._on(data)
        except Exception as exc:
            log.gdbug("client handler error", peer=str(addr),
                      err=repr(exc))
