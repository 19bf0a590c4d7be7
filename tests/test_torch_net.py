"""The port's network layer against the reference's: signed node records
and discovery packets byte for byte, the endpoint and NAT policies, and
the two packages' planes talking to each other over localhost — a port
gossip plane and a reference one (v3 ECDH frames, a v2-pinned pair, a
plaintext pair), a port discovery client through the reference's
bootnode and the reverse."""

import asyncio
import socket

import pytest

from eges_tpu.core import rlp as ref_rlp
from eges_tpu.crypto import secp256k1 as ref_secp
from eges_tpu.net import discovery as ref_disc
from eges_tpu.net import enr as ref_enr
from eges_tpu.net import nat as ref_nat
from eges_tpu.net import netutil as ref_netutil
from eges_tpu.net import transports as ref_tr
from eges_tpu_torch.core import rlp as port_rlp
from eges_tpu_torch.net import discovery as port_disc
from eges_tpu_torch.net import enr as port_enr
from eges_tpu_torch.net import nat as port_nat
from eges_tpu_torch.net import netutil as port_netutil
from eges_tpu_torch.net import transports as port_tr


def kp(i: int):
    priv = bytes([i]) * 32
    pub = ref_secp.privkey_to_pubkey(priv)
    return priv, pub, ref_secp.pubkey_to_address(pub)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- bytes: records and discovery packets ----------------------------------

@pytest.mark.parametrize("seq,fields", [
    (1, dict(ip="10.0.0.9", tcp=6190, udp=8100)),
    (7, dict(ip="10.0.0.9", tcp=6190, udp=8100, cip="10.0.0.10")),
    (300, dict(ip="127.0.0.1", tcp=1, udp=65535, cip="127.0.0.1")),
])
def test_records_are_byte_equal(seq, fields):
    priv, _, addr = kp(3)
    ref = ref_enr.Record.sign(priv, seq, **fields)
    port = port_enr.Record.sign(priv, seq, **fields)
    assert port.encode() == ref.encode()
    # each package decodes the other's record to the same claims
    back = port_enr.Record.decode(ref.encode())
    assert back.addr == addr == ref_enr.Record.decode(port.encode()).addr
    assert back.gossip_endpoint() == ref.gossip_endpoint()
    assert back.consensus_endpoint() == ref.consensus_endpoint()


def test_discovery_packets_are_byte_equal():
    priv, pub, addr = kp(5)
    now = 1234.5
    args = (priv, pub, "10.0.0.1", 6190, "10.0.0.2", 8100)
    ann = port_disc.encode_announce(*args, now=now)
    assert ann == ref_disc.encode_announce(*args, now=now)
    rec = port_enr.Record.sign(priv, 2, ip="10.0.0.1", tcp=6190, udp=8100)
    queries = [port_rlp.encode([port_disc.GET_PEERS, b"12345678"]),
               port_rlp.encode([port_disc.GET_RECORDS, b"abcdefgh"])]
    replies = []
    for mod in (ref_disc, port_disc):
        bn = mod.BootnodeService("0.0.0.0", 0, clock=lambda: now)
        bn.handle(ann, lambda d: None)
        bn.handle(ref_rlp.encode([mod.ENR_ANNOUNCE, rec.encode()]),
                  lambda d: None)
        got = []
        for q in queries:
            bn.handle(q, got.append)
        assert addr in bn.registry
        replies.append(got)
    assert replies[0] == replies[1] and len(replies[0]) == 2


def test_netutil_and_nat_agree():
    ips = ["127.0.0.1", "10.1.2.3", "192.168.0.5", "169.254.1.1",
           "224.0.0.1", "0.0.0.0", "255.255.255.255", "not-an-ip",
           "8.8.8.8", "172.16.0.1", "100.64.0.1"]
    for ip in ips:
        assert port_netutil.classify(ip) == ref_netutil.classify(ip)
        for port in (0, 1, 30303):
            assert (port_netutil.good_endpoint(ip, port)
                    == ref_netutil.good_endpoint(ip, port))
    for spec in ("none", "extip:198.51.100.9", "", "NONE"):
        assert (port_nat.resolve(spec, "10.0.0.7")
                == ref_nat.resolve(spec, "10.0.0.7"))
    for spec in ("auto", "any"):
        assert port_nat.parse(spec).mode == ref_nat.parse(spec).mode
    for bad in ("extip:999.1.1.1", "upnp", "pmp", "carrier-pigeon"):
        with pytest.raises(ref_nat.NATError) as want:
            ref_nat.parse(bad)
        with pytest.raises(port_nat.NATError) as got:
            port_nat.parse(bad)
        assert str(got.value) == str(want.value)
    ns_r, ns_p = ref_netutil.DistinctNetSet(24, 2), \
        port_netutil.DistinctNetSet(24, 2)
    for ip in ["10.0.0.1", "10.0.0.2", "10.0.0.3", "10.0.1.1",
               "127.0.0.1", "127.0.0.1"]:
        assert ns_p.add(ip) == ns_r.add(ip)
    assert len(ns_p) == len(ns_r)


# -- interop over localhost sockets -----------------------------------------

def _plane_kwargs(mode: str, priv: bytes) -> dict:
    if mode == "plaintext":
        return {}
    kw = {"secret": b"\xAA" * 32}
    if mode == "v3":
        kw["keypair"] = (priv, ref_secp.privkey_to_pubkey(priv))
    elif mode == "v2":
        kw.update(keypair=(priv, ref_secp.privkey_to_pubkey(priv)),
                  version=2)
    return kw


@pytest.mark.parametrize("mode", ["v3", "v2", "plaintext"])
def test_port_and_reference_gossip_planes_interoperate(mode):
    """A port plane and a reference plane dial each other, finish the
    handshake of ``mode`` and deliver frames both ways; on v3 both ends
    of every connection encrypt."""

    async def run():
        got_p, got_r = [], []
        pp, pr = _free_port(), _free_port()
        port = port_tr.GossipPlane("127.0.0.1", pp, [("127.0.0.1", pr)],
                                   got_p.append,
                                   **_plane_kwargs(mode, b"\x07" * 32))
        ref = ref_tr.GossipPlane("127.0.0.1", pr, [("127.0.0.1", pp)],
                                 got_r.append,
                                 **_plane_kwargs(mode, b"\x08" * 32))
        await port.start()
        await ref.start()
        try:
            for _ in range(40):
                await asyncio.sleep(0.05)
                if port._writers and ref._writers:
                    break
            port.broadcast(b"from-port-" + mode.encode())
            ref.broadcast(b"from-ref-" + mode.encode())
            for _ in range(40):
                await asyncio.sleep(0.05)
                if got_p and got_r:
                    break
            assert got_r == [b"from-port-" + mode.encode()]
            assert got_p == [b"from-ref-" + mode.encode()]
            for plane in (port, ref):
                assert plane._writers
                for sess in plane._writers.values():
                    if mode == "plaintext":
                        assert sess.auth is None
                    else:
                        assert sess.auth.encrypts == (mode == "v3")
            assert port.auth_failures == ref.auth_failures == 0
        finally:
            port.close()
            ref.close()

    asyncio.run(run())


@pytest.mark.parametrize("boot,client", [(ref_disc, port_disc),
                                         (port_disc, ref_disc)],
                         ids=["port_client_ref_bootnode",
                              "ref_client_port_bootnode"])
def test_discovery_across_packages(boot, client):
    """A discovery client of one package learns a peer announced by a
    client of the other through the first package's bootnode."""

    async def run():
        bn = boot.BootnodeService("127.0.0.1", 0)
        await bn.start()
        bport = bn._transport.get_extra_info("sockname")[1]
        learned = []
        p1, _, a1 = kp(13)
        p2, _, _ = kp(14)
        other = ref_disc if client is port_disc else port_disc
        c1 = other.DiscoveryClient([("127.0.0.1", bport)], p1, "127.0.0.1",
                                   7001, "127.0.0.1", 8001, interval_s=0.1)
        c2 = client.DiscoveryClient(
            [("127.0.0.1", bport)], p2, "127.0.0.1", 7002, "127.0.0.1",
            8002, interval_s=0.1,
            on_peer=lambda addr, gep, cep: learned.append((addr, gep)))
        await c1.start()
        await asyncio.sleep(0.2)
        await c2.start()
        try:
            for _ in range(40):
                await asyncio.sleep(0.1)
                if learned:
                    break
        finally:
            c1.close()
            c2.close()
            bn.close()
        assert (a1, ("127.0.0.1", 7001)) in learned

    asyncio.run(run())
