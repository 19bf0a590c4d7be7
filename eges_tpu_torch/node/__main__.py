"""CLI entry: ``python -m eges_tpu_torch.node`` — the geth-command
equivalent.

The port's copy of ``eges_tpu/node/__main__.py``: ``--verifier`` takes
``torch`` (the default: the port's kernels on the card), ``native`` or
``none``; ``--verifierDevice`` (``cuda`` by default, ``cpu`` for the
plain versions of the kernels) says where ``torch`` runs; the
reference's ``--tpuVerify`` is ``--deviceVerify``.  A node started
without a card raises unless it asks for the CPU or another verifier.

Flag set mirrors the reference's Geec CLI surface
(ref: cmd/utils/flags.go:540-591, registered cmd/geth/main.go:125-135),
plus the transport flags the permissioned static-peer design needs.
"""

from __future__ import annotations

import argparse
import asyncio

from eges_tpu_torch.consensus.config import NodeConfig
from eges_tpu_torch.node.service import NodeService, ServiceConfig


def parse_peers(spec: str) -> tuple[tuple[str, int], ...]:
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, port = part.rsplit(":", 1)
        out.append((host, int(port)))
    return tuple(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eges-tpu-torch-node",
        description="Geec consensus node on a CUDA card")
    p.add_argument("--datadir", required=True)
    p.add_argument("--genesis", required=True, help="genesis JSON with config.thw")
    p.add_argument("--keyhex", required=True, help="32-byte private key, hex")
    p.add_argument("--mine", action="store_true")
    p.add_argument("--verbosity", type=int, default=3)
    # Geec flags (ref: cmd/utils/flags.go:540-591)
    p.add_argument("--consensusIP", default="127.0.0.1")
    p.add_argument("--consensusPort", type=int, default=8100)
    p.add_argument("--geecTxnPort", type=int, default=0)
    p.add_argument("--nCandidates", type=int, default=3)
    p.add_argument("--nAcceptors", type=int, default=4)
    p.add_argument("--blockTimeout", type=float, default=20.0)
    p.add_argument("--txnPerBlock", type=int, default=1000)
    p.add_argument("--txnSize", type=int, default=100)
    p.add_argument("--breakdown", action="store_true")
    p.add_argument("--failureTest", action="store_true")
    p.add_argument("--totalNodes", type=int, default=3)
    p.add_argument("--syncmode", default="full", choices=["full", "fast"],
                   help="fast: a late joiner downloads the state at a "
                        "quorum-certified pivot block and replays only "
                        "the tail — O(state) not O(chain) (ref: "
                        "eth/downloader/statesync.go role)")
    # transport
    p.add_argument("--gossipIP", default="127.0.0.1")
    p.add_argument("--gossipPort", type=int, default=6190)
    p.add_argument("--peers", default="", help="ip:port,ip:port gossip peers")
    p.add_argument("--nat", default="none",
                   help="advertised-address policy for discovery: "
                        "none | auto | extip:<ip> (ref p2p/nat)")
    p.add_argument("--bootnodes", default="",
                   help="ip:port,... discovery bootnodes (makes --peers "
                        "optional)")
    p.add_argument("--deviceVerify", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="batch-verify signatures on the card's kernels "
                        "(--no-deviceVerify to run host-only)")
    p.add_argument("--verifier", default="", choices=["", "torch", "native",
                                                      "none"],
                   help="verifier backend override: torch device batches "
                        "(default), native C++ batches, or none")
    p.add_argument("--verifierDevice", default="cuda",
                   help="device of the torch verifier: cuda (default; "
                        "raises without a card) or cpu (the plain "
                        "versions of the kernels)")
    p.add_argument("--rpcPort", type=int, default=0,
                   help="JSON-RPC HTTP port (0 = disabled)")
    p.add_argument("--collector", default="",
                   help="host:port of a telemetry collector "
                        "(harness/collector.py CollectorServer); the "
                        "node pushes sampled metric deltas + its "
                        "journal tail there every "
                        "--telemetryInterval seconds")
    p.add_argument("--telemetryInterval", type=float, default=5.0,
                   help="seconds between telemetry pushes")
    p.add_argument("--netSecret", default="",
                   help="hex gossip-plane auth secret (default: derived "
                        "from the genesis hash)")
    p.add_argument("--plaintextGossip", action="store_true",
                   help="disable the gossip auth layer")
    p.add_argument("--gossipAllowlist", default="",
                   help="comma-separated hex addresses; when set, only "
                        "listed peers or current members may hold gossip "
                        "connections (membership gate on the v2 "
                        "handshake identity)")
    p.add_argument("--allowV1Peers", action="store_true",
                   help="accept legacy v1 symmetric hellos on a keyed "
                        "node (mixed-mode upgrades; bypasses per-peer "
                        "identity, so off by default)")
    p.add_argument("--allowV2Peers", action="store_true",
                   help="accept MAC-only v2 hellos on a v3 node "
                        "(mixed-mode upgrades; those links lose "
                        "confidentiality, so off by default)")
    p.add_argument("--gossipVersion", type=int, default=3, choices=[2, 3],
                   help="gossip-plane generation: 3 = encrypted frames "
                        "(default), 2 = MAC-only (staged upgrades)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    node_cfg = NodeConfig(
        consensus_ip=args.consensusIP, consensus_port=args.consensusPort,
        geec_txn_port=args.geecTxnPort, n_candidates=args.nCandidates,
        n_acceptors=args.nAcceptors, block_timeout_s=args.blockTimeout,
        txn_per_block=args.txnPerBlock, txn_size=args.txnSize,
        breakdown=args.breakdown, failure_test=args.failureTest,
        total_nodes=args.totalNodes, fast_sync=args.syncmode == "fast")
    cfg = ServiceConfig(
        datadir=args.datadir, genesis_path=args.genesis, key_hex=args.keyhex,
        gossip_ip=args.gossipIP, gossip_port=args.gossipPort,
        peers=parse_peers(args.peers), node=node_cfg, mine=args.mine,
        verbosity=args.verbosity, use_device_verifier=args.deviceVerify,
        rpc_port=args.rpcPort, net_secret_hex=args.netSecret,
        plaintext_gossip=args.plaintextGossip,
        allow_v1_peers=args.allowV1Peers,
        allow_v2_peers=args.allowV2Peers,
        gossip_version=args.gossipVersion,
        gossip_allowlist=tuple(a for a in args.gossipAllowlist.split(",")
                               if a),
        bootnodes=parse_peers(args.bootnodes),
        nat=args.nat,
        verifier_mode=args.verifier,
        verifier_device=args.verifierDevice,
        collector_addr=args.collector,
        telemetry_interval_s=args.telemetryInterval)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    service = NodeService(cfg)
    try:
        loop.run_until_complete(service.run_forever())
    except KeyboardInterrupt:
        pass
    finally:
        service.close()


if __name__ == "__main__":
    main()
