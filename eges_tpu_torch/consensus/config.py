"""Geec consensus configuration.

The port's copy of ``eges_tpu/consensus/config.py``, unchanged but for
its imports.

Merges the reference's two config tiers into explicit dataclasses:

* chain-wide consensus config from the genesis ``"thw"`` section
  (ref: params/config.go:154-174 GeecConfig) — consensus-critical,
  must agree across nodes;
* per-node operational knobs from CLI flags -> node.Config
  (ref: cmd/utils/flags.go:540-591, node/config.go:152-163).

Time quantities keep the reference's (mixed) units, documented per field.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class BootstrapNode:
    """Genesis committee seed entry (ref: params/config.go:156-161)."""

    account: bytes  # 20-byte address
    ip: str
    port: int

    @classmethod
    def from_json(cls, obj: dict) -> "BootstrapNode":
        return cls(account=bytes.fromhex(obj["account"]), ip=obj["ip"],
                   port=int(obj["port"]))

    def to_json(self) -> dict:
        return {"account": self.account.hex(), "ip": self.ip,
                "port": str(self.port)}


@dataclass(frozen=True)
class ChainGeecConfig:
    """The genesis ``"thw"`` section (ref: params/config.go:154-174)."""

    bootstrap: tuple[BootstrapNode, ...] = ()
    max_reg_per_blk: int = 10          # reg_per_blk
    reg_timeout_s: float = 10.0        # registration_timeout (seconds)
    validate_timeout_ms: float = 500.0  # validate_timeout (ms) — ACK retry
    election_timeout_ms: float = 100.0  # election_timeout (ms)
    backoff_time_ms: float = 0.0       # backoff_time (ms) before confirm
    # This build's upgrade over the reference's trustedHW assumption
    # (unsigned ValidateReply, core/geec_state.go:528-591): when True,
    # election votes / ACKs / query replies / confirms must carry valid
    # secp256k1 signatures, tallied through the device batch verifier.
    # Consensus-critical: must agree across the chain.  ON by default;
    # set "signed_votes": false in genesis for reference-parity
    # trustedHW-style deployments.
    signed_votes: bool = True

    @classmethod
    def from_json(cls, obj: dict) -> "ChainGeecConfig":
        if "bootstrap" in obj and "signed_votes" not in obj:
            # consensus-critical default: a genesis that omits the key is
            # ambiguous across build generations — pin it explicitly
            from eges_tpu_torch.utils.log import get_logger
            get_logger("geec.config").warn(
                "genesis thw section omits 'signed_votes'; defaulting to "
                "true — pin it explicitly so every node generation agrees")
        return cls(
            bootstrap=tuple(BootstrapNode.from_json(n)
                            for n in obj.get("bootstrap", [])),
            max_reg_per_blk=int(obj.get("reg_per_blk", 10)),
            reg_timeout_s=float(obj.get("registration_timeout", 10)),
            validate_timeout_ms=float(obj.get("validate_timeout", 500)),
            election_timeout_ms=float(obj.get("election_timeout", 100)),
            backoff_time_ms=float(obj.get("backoff_time", 0)),
            signed_votes=bool(obj.get("signed_votes", True)),
        )

    def to_json(self) -> dict:
        return {
            "bootstrap": [n.to_json() for n in self.bootstrap],
            "reg_per_blk": self.max_reg_per_blk,
            "registration_timeout": self.reg_timeout_s,
            "validate_timeout": self.validate_timeout_ms,
            "election_timeout": self.election_timeout_ms,
            "backoff_time": self.backoff_time_ms,
            "signed_votes": self.signed_votes,
        }


@dataclass(frozen=True)
class NodeConfig:
    """Per-node Geec knobs (ref: node/config.go:152-163 + flags)."""

    coinbase: bytes = bytes(20)
    consensus_ip: str = "127.0.0.1"     # --consensusIP
    consensus_port: int = 8100          # --consensusPort (UDP control plane)
    geec_txn_port: int = 0              # --geecTxnPort (0 = no txn service)
    n_candidates: int = 3               # --nCandidates (committee size)
    n_acceptors: int = 4                # --nAcceptors (validator set size)
    block_timeout_s: float = 20.0       # --blockTimeout (seconds)
    txn_per_block: int = 1000           # --txnPerBlock
    txn_size: int = 100                 # --txnSize (fake txn payload bytes)
    breakdown: bool = False             # --breakdown (phase timing logs)
    failure_test: bool = False          # --failureTest (TTL economy on)
    total_nodes: int = 3                # --totalNodes
    privkey: bytes = b""                # consensus signing key (32 bytes)
    #                                     — required when the chain runs
    #                                     with signed_votes
    fast_sync: bool = False             # --syncmode fast: a late joiner
    #                                     downloads the state at a pivot
    #                                     block (root-verified against a
    #                                     quorum-certified header) and
    #                                     replays only the tail — O(state)
    #                                     not O(chain).  Requires
    #                                     signed_votes for the cert check.

    checkpoint_every: int = 0           # durable state-checkpoint cadence
    #                                     in blocks (0 = off): every Nth
    #                                     committed block writes a
    #                                     root-verified snapshot sidecar so
    #                                     a restart replays only the tail
    #                                     past the newest checkpoint —
    #                                     O(tail), not O(chain)

    # TPU-native addition: verify signatures in device batches of up to
    # this many rows (the reference has no analogue — it verifies one
    # cgo call at a time, crypto/secp256k1/secp256.go:105).
    verify_batch_rows: int = 1024


def ttl_params(total_nodes: int) -> dict:
    """TTL economy constants (ref: core/geec_state.go:262-272)."""
    if total_nodes > 200:
        initial = 200
    elif total_nodes < 50:
        initial = 50
    else:
        initial = total_nodes
    return dict(initial_ttl=initial, bonus_ttl=20, renew_ttl_threshold=20,
                max_ttl=initial, ttl_interval=10)


# Consensus constants (ref: core/geec_state.go:230, geecCore/utils.go:5-11)
CONFIDENCE_THRESHOLD = 9999
CONFIDENCE_STEP = 1000
CONFIDENCE_CAP = 10000


def calc_confidence(parent_confidence: int) -> int:
    """(ref: core/geecCore/utils.go:5-11)"""
    return min(parent_confidence + CONFIDENCE_STEP, CONFIDENCE_CAP)
