"""UDP transaction clients — the ``Geec_Client`` parity tools.

The port's copy of the JAX repo's ``harness/txn_client.py``, unchanged:
``python -m eges_tpu_torch.harness.txn_client rate --port PORT``.

* ``rate`` mode: async fixed-rate sender (ref: Geec_Client/client_async/
  main.go:20-28 — 100 tx/s of "hello_100charsworth" payloads).
* ``interactive`` mode: stdin lines become transactions
  (ref: Geec_Client/client_interactive/main.go).

Target is any node's ``--geecTxnPort``; each datagram becomes one
unsigned Geec transaction (consensus/geec/geec_api.go:28-41).
"""

from __future__ import annotations

import argparse
import socket
import sys
import time


def run_rate(host: str, port: int, rate: float, size: int, count: int) -> None:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(1.0)  # send-only UDP; bounded just in case
    interval = 1.0 / rate if rate > 0 else 0
    sent = 0
    t0 = time.time()
    while count <= 0 or sent < count:
        payload = (f"txn-{sent}-".encode() + b"x" * size)[:size]
        sock.sendto(payload, (host, port))
        sent += 1
        target = t0 + sent * interval
        delay = target - time.time()
        if delay > 0:
            time.sleep(delay)
        if sent % 1000 == 0:
            print(f"sent {sent} txns ({sent / (time.time() - t0):.0f}/s)")


def run_interactive(host: str, port: int) -> None:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(1.0)  # send-only UDP; bounded just in case
    print(f"sending stdin lines to {host}:{port} (^D to stop)")
    for line in sys.stdin:
        data = line.rstrip("\n").encode()
        if data:
            sock.sendto(data, (host, port))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["rate", "interactive"])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=10000)
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--size", type=int, default=100)
    ap.add_argument("--count", type=int, default=0, help="0 = unlimited")
    args = ap.parse_args()
    if args.mode == "rate":
        run_rate(args.host, args.port, args.rate, args.size, args.count)
    else:
        run_interactive(args.host, args.port)


if __name__ == "__main__":
    main()
