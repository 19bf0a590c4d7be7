"""Endpoint sanity for the discovery plane (the p2p/netutil role).

The port's copy of ``eges_tpu/net/netutil.py``, unchanged.

The reference gates which announced endpoints it will relay or dial:
special-purpose networks are rejected outright and a table never holds
too many nodes from one subnet (ref: p2p/netutil/net.go — IsLAN /
IsSpecialNetwork / DistinctNetSet).  This module is the same defense
for the bootnode registry: a permissioned committee is exactly the
kind of small table one hostile /24 could otherwise flood.

Classification is deliberately coarse — four buckets that drive
policy, not a full IANA registry walk:

    loopback   127/8            always dialable locally (dev clusters)
    lan        RFC1918 + link-local + CGN
    special    multicast, unspecified, reserved, broadcast
    routable   everything else
"""

from __future__ import annotations

import ipaddress


def classify(ip: str) -> str:
    try:
        a = ipaddress.ip_address(ip)
    except ValueError:
        return "special"
    if a.is_loopback:
        return "loopback"
    if a.is_multicast or a.is_unspecified or a.is_reserved \
            or ip == "255.255.255.255":
        return "special"
    if a.is_private or a.is_link_local:
        return "lan"
    return "routable"


def good_endpoint(ip: str, port: int) -> bool:
    """Would the reference relay this endpoint?  Ports must be real and
    the address must be something a peer could actually dial."""
    return 0 < port < 65536 and classify(ip) != "special"


class DistinctNetSet:
    """Bound how many tracked items share one subnet.

    ``bits`` is the prefix length defining "one subnet" (24 ⇒ /24) and
    ``limit`` the per-subnet cap.  Loopback addresses are exempt: local
    dev clusters put every node on 127.0.0.1 and are not a flooding
    vector.  (ref: p2p/netutil/net.go DistinctNetSet{Subnet,Limit})
    """

    def __init__(self, bits: int = 24, limit: int = 16):
        self.bits = bits
        self.limit = limit
        self._counts: dict[int, int] = {}

    def _key(self, ip: str) -> int | None:
        a = ipaddress.ip_address(ip)
        if a.is_loopback:
            return None
        return int(a) >> (32 - self.bits)

    def add(self, ip: str) -> bool:
        """Track ip; False (and no change) if its subnet is full."""
        k = self._key(ip)
        if k is None:
            return True
        n = self._counts.get(k, 0)
        if n >= self.limit:
            return False
        self._counts[k] = n + 1
        return True

    def remove(self, ip: str) -> None:
        k = self._key(ip)
        if k is None:
            return
        n = self._counts.get(k, 0)
        if n <= 1:
            self._counts.pop(k, None)
        else:
            self._counts[k] = n - 1

    def __len__(self) -> int:
        return sum(self._counts.values())
