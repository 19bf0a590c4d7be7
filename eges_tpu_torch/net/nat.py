"""External-address resolution (the p2p/nat role).

The port's copy of ``eges_tpu/net/nat.py``, unchanged.

The reference resolves the address a node should *advertise* — as
opposed to the one it binds — through a pluggable NAT interface
selected by ``--nat`` (ref: p2p/nat/nat.go Parse: "none", "any",
"extip:<ip>", "upnp", "pmp").  The protocol-speaking traversal modes
(UPnP/NAT-PMP) assume consumer gateways; a permissioned committee
deployment pins addresses in config instead, so here those modes are
explicit unsupported errors rather than silent fallbacks, and "auto"
resolves the host's primary outbound interface locally:

    none           advertise the bind address unchanged
    extip:<ip>     advertise exactly <ip> (static NAT / public VIP)
    auto | any     advertise the primary outbound interface address,
                   discovered via a connected UDP socket (no packet is
                   sent — connect() on a datagram socket only selects
                   the route)

``resolve(spec, bind_ip)`` is the single entry point the node CLI
uses: it returns the IP to put in the signed node record.
"""

from __future__ import annotations

import socket


class NATError(ValueError):
    pass


class NAT:
    """Resolved advertisement policy."""

    def __init__(self, mode: str, extip: str | None = None):
        self.mode = mode
        self.extip = extip

    def external_ip(self, bind_ip: str) -> str:
        if self.mode == "none":
            return bind_ip
        if self.mode == "extip":
            return self.extip  # type: ignore[return-value]
        # auto: route-table lookup via an unconnected-send-free socket
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(1.0)  # connect() on UDP is local-only, but be safe
        try:
            s.connect(("192.0.2.1", 9))  # TEST-NET-1: never dialed
            ip = s.getsockname()[0]
        except OSError:
            ip = bind_ip
        finally:
            s.close()
        # a host with no route at all answers 0.0.0.0 — fall back
        return ip if ip != "0.0.0.0" else bind_ip


def parse(spec: str) -> NAT:
    spec = (spec or "none").strip().lower()
    if spec == "none":
        return NAT("none")
    if spec in ("auto", "any"):
        return NAT("auto")
    if spec.startswith("extip:"):
        ip = spec[len("extip:"):]
        try:
            socket.inet_aton(ip)
        except OSError:
            raise NATError("bad extip address: %r" % ip) from None
        return NAT("extip", ip)
    if spec in ("upnp", "pmp"):
        raise NATError(
            "%s is not supported in a pinned-address deployment; "
            "use extip:<ip> or auto" % spec)
    raise NATError("unknown nat spec: %r" % spec)


def resolve(spec: str, bind_ip: str) -> str:
    return parse(spec).external_ip(bind_ip)
