"""Pluggable consensus-engine seam.

Role parity with the reference's ``consensus.Engine`` interface
(ref: consensus/consensus.go:57 — VerifyHeader/Prepare/Finalize/Seal,
implemented by ethash, clique and geec): the chain layer calls the
engine for header verification and block assembly, so the Geec state
machine is ONE engine rather than a hardwired assumption.

This module lives in ``core`` — the interface belongs to the layer
that CONSUMES it (the chain calls the engine, never the reverse), so
L1 ``core.chain`` depending on an L2 ``consensus`` module would invert
the declared layer map.  ``eges_tpu_torch.consensus.engine`` re-exports the
same names for the consensus layer and existing callers.

Engines here:

* :class:`GeecEngine` — the production engine: header verification is
  intentionally near-no-op (ancestry only, ref: consensus/geec/
  geec.go:186-210 verifyHeader); sealing is driven by the event-loop
  consensus node (:mod:`eges_tpu_torch.consensus.node`), not a Seal() call.
* :class:`DevEngine` — single-authority instant-seal PoA (the clique
  role, ref: consensus/clique/clique.go's signed-extra scheme,
  re-designed: one signer, no epoch/voting): every sealed header
  carries the authority's signature over the header's signing hash in
  ``extra``; verification recovers and checks the signer.  This is the
  dev-chain mode (geth --dev analogue) and proves the seam carries a
  second, structurally different engine.
* :class:`PowEngine` — the ethash ROLE (ref: consensus/ethash/
  consensus.go VerifyHeader + sealer.go mine): nonce-searched
  keccak proof-of-work with parent-relative difficulty retargeting.
  NOT ethash's DAG/hashimoto (memory-hardness buys nothing in a
  permissioned deployment) — the TPU-first redesign instead makes the
  *search* the interesting part: candidate nonces are swept in device
  batches through :func:`eges_tpu_torch.ops.keccak.keccak256_fixed`,
  thousands of hashes per dispatch (kernel #13 ``k_keccak_block`` on the
  card).

The port's copy of ``eges_tpu/core/engine.py``.  :class:`PowEngine`
takes a ``device`` (the card by default, ``"cpu"`` for the plain
Keccak) and, unlike the reference, has no hidden host fallback: a
device sweep that fails raises out of :meth:`PowEngine.seal` instead of
switching the engine to the host loop for good.
"""

from __future__ import annotations

import dataclasses

from eges_tpu_torch.core.types import Block, Header, new_block


class EngineError(Exception):
    """Header/seal verification failure."""


class Engine:
    """The minimal engine surface the chain layer consumes."""

    name = "base"

    def verify_header(self, chain, header: Header) -> None:
        """Raise :class:`EngineError` on a bad header.  Ancestry/number
        checks are the chain layer's; engines add their own rules."""

    def prepare(self, chain, header: Header) -> Header:
        """Fill engine-owned header fields before execution."""
        return header

    def seal(self, chain, block: Block) -> Block:
        """Produce the sealed block (synchronous engines only)."""
        return block


class GeecEngine(Engine):
    """Geec: verification rides the quorum certificates, not the header
    (ref: geec.go:186-210 — the header check is deliberately minimal;
    VerifySeal is a stub, geec.go:223-226).  Sealing happens in the
    consensus node's phase machine, so :meth:`seal` is unused."""

    name = "geec"

    def verify_header(self, chain, header: Header) -> None:
        if header.number > 0 and header.time == 0:
            raise EngineError("missing timestamp")


class DevEngine(Engine):
    """Single-authority instant seal.  ``extra`` carries the 65-byte
    authority signature over the unsigned header hash."""

    name = "dev"

    def __init__(self, authority: bytes, priv: bytes | None = None):
        self.authority = authority  # 20-byte address
        self.priv = priv            # present on the sealing node only

    @staticmethod
    def _signing_hash(header: Header) -> bytes:
        from eges_tpu_torch.core import rlp
        from eges_tpu_torch.crypto.keccak import keccak256

        bare = dataclasses.replace(header, extra=b"")
        return keccak256(rlp.encode(bare.to_rlp()))

    def verify_header(self, chain, header: Header) -> None:
        from eges_tpu_torch.crypto import secp256k1 as secp

        if header.number == 0:
            return
        if len(header.extra) != 65:
            raise EngineError("dev seal missing")
        try:
            signer = secp.recover_address(self._signing_hash(header),
                                          header.extra)
        except Exception:
            raise EngineError("unrecoverable dev seal")
        if signer != self.authority:
            raise EngineError("dev seal from a non-authority signer")

    def seal(self, chain, block: Block) -> Block:
        from eges_tpu_torch.crypto import secp256k1 as secp

        if self.priv is None:
            raise EngineError("not the authority (no key)")
        sig = secp.ecdsa_sign(self._signing_hash(block.header), self.priv)
        header = dataclasses.replace(block.header, extra=sig)
        return dataclasses.replace(block, header=header)

    def seal_next(self, chain, txs=(), coinbase: bytes | None = None) -> Block:
        """Convenience dev-chain block producer: preview ``txs`` on the
        head state, assemble, seal, and offer — the geth --dev
        instant-mining loop collapsed to one call."""
        coinbase = coinbase if coinbase is not None else self.authority
        parent = chain.head()
        kept, root, receipt_hash, gas, bloom = chain.execute_preview(
            list(txs), coinbase)
        header = Header(parent_hash=parent.hash, number=parent.number + 1,
                        coinbase=coinbase, time=parent.header.time + 1,
                        root=root, receipt_hash=receipt_hash, gas_used=gas,
                        bloom=bloom)
        block = self.seal(chain, new_block(header, txs=kept))
        inserted = chain.offer(block)
        if not inserted:
            raise EngineError(f"dev block rejected: {chain.last_error}")
        return block


class PowEngine(Engine):
    """Keccak proof-of-work with device-batched nonce search.

    Verification (ref role: consensus/ethash/consensus.go
    verifyHeader + VerifySeal): ``keccak256(seal_hash || nonce)``
    interpreted big-endian must not exceed ``2**256 // difficulty``,
    and the header's difficulty must equal the parent-relative
    retarget.  Sealing sweeps nonce candidates in batches — on the card
    through the batched Keccak (one launch of kernel #13 hashes
    ``sweep_batch`` candidates), or a host loop when the caller passes
    ``use_device=False``.

    ``device`` is resolved by :func:`eges_tpu_torch.resolve_device`: the
    card by default, which raises without one; ``"cpu"`` runs the plain
    Keccak.  A failing device sweep raises out of :meth:`seal` and
    leaves ``use_device`` as it was: the reference's silent switch to
    the host loop would hide a kernel that fails to build or launch."""

    name = "pow"

    TARGET_BLOCK_S = 13          # retarget setpoint (ethash's cadence)
    MIN_DIFFICULTY = 1

    def __init__(self, sweep_batch: int = 4096, use_device: bool = True,
                 max_sweeps: int = 1 << 16, clock=None, device=None):
        self.sweep_batch = sweep_batch
        self.use_device = use_device
        self.max_sweeps = max_sweeps  # gives up (re-prepare with new time)
        self.device = None
        if use_device:
            from eges_tpu_torch import resolve_device
            self.device = resolve_device(device)
        # injectable wall-clock for the future-drift bound: sims hand in
        # their virtual clock so a chaos run's accept/reject decisions
        # replay byte-identically regardless of host time
        if clock is None:
            import time as _time
            clock = _time.time
        self.clock = clock

    # -- difficulty ----------------------------------------------------

    @classmethod
    def calc_difficulty(cls, parent: Header, time: int) -> int:
        """Parent-relative retarget (the Homestead-family rule shape,
        ref: consensus/ethash/consensus.go CalcDifficulty — re-derived,
        no bomb: permissioned chains do not schedule their own
        obsolescence): faster than the setpoint raises difficulty by
        parent/2048, slower lowers it, clamped to the minimum."""
        delta = max(1 - (time - parent.time) // cls.TARGET_BLOCK_S, -99)
        return max(parent.difficulty + delta * (parent.difficulty // 2048 + 1),
                   cls.MIN_DIFFICULTY)

    # -- hashing -------------------------------------------------------

    @staticmethod
    def seal_hash(header: Header) -> bytes:
        """Hash of the header with the engine-owned fields zeroed."""
        from eges_tpu_torch.core import rlp
        from eges_tpu_torch.crypto.keccak import keccak256

        bare = dataclasses.replace(header, nonce=bytes(8),
                                   mix_digest=bytes(32))
        return keccak256(rlp.encode(bare.to_rlp()))

    @staticmethod
    def _target(difficulty: int) -> int:
        return (1 << 256) // max(difficulty, 1)

    @staticmethod
    def pow_value(seal_hash: bytes, nonce: bytes) -> int:
        from eges_tpu_torch.crypto.keccak import keccak256

        return int.from_bytes(keccak256(seal_hash + nonce), "big")

    FUTURE_DRIFT_S = 15          # max claimable lead over wall clock
    #                              (ref: consensus/ethash allowedFutureBlockTime
    #                              role — without it, a far-future
    #                              timestamp grinds difficulty to the
    #                              floor and seals for free)

    def verify_header(self, chain, header: Header) -> None:
        if header.number == 0:
            return
        if header.time > self.clock() + self.FUTURE_DRIFT_S:
            raise EngineError("pow timestamp too far in the future")
        parent = chain.get_block_by_number(header.number - 1)
        if parent is not None:  # behind-sync callers may lack the parent
            if header.time <= parent.header.time:
                raise EngineError("pow timestamp not after parent")
            want = self.calc_difficulty(parent.header, header.time)
            if header.difficulty != want:
                raise EngineError(
                    f"pow difficulty {header.difficulty} != retarget {want}")
        if header.mix_digest != bytes(32):
            raise EngineError("pow mix_digest must be zero")
        if self.pow_value(self.seal_hash(header), header.nonce) \
                > self._target(header.difficulty):
            raise EngineError("pow seal below difficulty")

    def prepare(self, chain, header: Header) -> Header:
        parent = chain.get_block_by_number(header.number - 1)
        if parent is None:
            raise EngineError("unknown parent")
        return dataclasses.replace(
            header,
            difficulty=self.calc_difficulty(parent.header, header.time))

    # -- sealing -------------------------------------------------------

    def _sweep_device(self, sh: bytes, start: int, target: int):
        """One device dispatch: hash ``sweep_batch`` consecutive nonces
        (mod 2**64) with :func:`~eges_tpu_torch.ops.keccak.keccak256_fixed`
        on ``self.device``, return the first winning nonce or None.  The
        ``[n, 40]`` messages are built on the device; the digests come
        back to the host for the compare, as in the reference."""
        import numpy as np
        import torch

        from eges_tpu_torch.ops.keccak import keccak256_fixed

        n = self.sweep_batch
        dev = self.device
        # nonces as int64 two's complement: the add wraps mod 2**64 and
        # the low byte of each shift is the uint64's byte
        first = start - (1 << 64) if start >= (1 << 63) else start
        nonces = torch.arange(n, dtype=torch.int64, device=dev) + first
        shifts = torch.arange(56, -8, -8, dtype=torch.int64, device=dev)
        msgs = torch.empty((n, 40), dtype=torch.uint8, device=dev)
        msgs[:, :32] = torch.frombuffer(bytearray(sh), dtype=torch.uint8).to(
            dev)
        msgs[:, 32:] = ((nonces[:, None] >> shifts) & 0xFF).to(torch.uint8)
        digests = keccak256_fixed(msgs).cpu().numpy()
        tbytes = (target.to_bytes(33, "big")[-32:]
                  if target < (1 << 256) else b"\xff" * 32)
        # big-endian 256-bit compare, word by word: digest <= target
        words = digests.view(">u8")
        want = np.frombuffer(tbytes, ">u8")
        below = np.zeros(n, bool)
        equal = np.ones(n, bool)
        for k in range(4):
            below |= equal & (words[:, k] < want[k])
            equal &= words[:, k] == want[k]
        wins = np.flatnonzero(below | equal)
        if wins.size == 0:
            return None
        return (start + int(wins[0])) % (1 << 64)

    def seal(self, chain, block: Block) -> Block:
        sh = self.seal_hash(block.header)
        target = self._target(block.header.difficulty)
        start = int.from_bytes(sh[:8], "big")  # deterministic start
        for sweep in range(self.max_sweeps):
            base = (start + sweep * self.sweep_batch) % (1 << 64)
            nonce = None
            if self.use_device:
                # no fallback: a device fault raises out of seal
                nonce = self._sweep_device(sh, base, target)
            else:
                for i in range(self.sweep_batch):
                    cand = ((base + i) % (1 << 64)).to_bytes(8, "big")
                    if self.pow_value(sh, cand) <= target:
                        nonce = int.from_bytes(cand, "big")
                        break
            if nonce is None:
                continue
            header = dataclasses.replace(
                block.header, nonce=int(nonce).to_bytes(8, "big"),
                mix_digest=bytes(32))
            return dataclasses.replace(block, header=header)
        raise EngineError("pow search exhausted; re-prepare with new time")

    def mine_next(self, chain, txs=(),
                  coinbase: bytes = bytes(20)) -> Block:
        """The miner loop collapsed to one call (ref role:
        miner/worker.go commit + ethash sealer): retarget, preview under
        the EXACT ctx the sealed header will carry (validation
        re-executes with block_ctx(header) — a contract reading
        TIMESTAMP/DIFFICULTY must see the same values or the committed
        root is unreproducible), seal, offer."""
        from eges_tpu_torch.core.evm import BlockCtx

        parent = chain.head()
        time = parent.header.time + self.TARGET_BLOCK_S
        difficulty = self.calc_difficulty(parent.header, time)
        ctx = BlockCtx(coinbase=coinbase, number=parent.number + 1,
                       time=time, difficulty=difficulty)
        kept, root, receipt_hash, gas, bloom = chain.execute_preview(
            list(txs), coinbase, ctx=ctx)
        header = Header(parent_hash=parent.hash, number=parent.number + 1,
                        coinbase=coinbase, time=time, difficulty=difficulty,
                        root=root, receipt_hash=receipt_hash, gas_used=gas,
                        bloom=bloom)
        block = self.seal(chain, new_block(header, txs=kept))
        if not chain.offer(block):
            raise EngineError(f"pow block rejected: {chain.last_error}")
        return block
