"""Host-side verification helpers — importable WITHOUT pulling in torch.

The port's copy of ``eges_tpu/crypto/verify_host.py``: the host paths
the scheduler diverts to (``_count_host_rows``), the native batch
verifiers its tests drive (:class:`NativeBatchVerifier`, the split-phase
:class:`PipelinedNativeVerifier`, the N-lane :class:`NativeMeshVerifier`)
and the caller-side helpers (``batch_verify_txns``, ``recover_signers``,
``recover_signers_window``).

Consensus node processes that run with ``verifier=None`` (host fallback)
must never pay the accelerator-runtime import, which initializes the
device and can block an event loop for seconds.  This module therefore
depends on numpy only; the ``verifier`` object passed in (a
:class:`~eges_tpu_torch.crypto.verifier.BatchVerifier`) is constructed
by whichever process actually owns the device.
"""

from __future__ import annotations

import numpy as np


def _count_host_rows(n: int) -> None:  # api: _count_host_rows
    """Count host-fallback recoveries so ``thw_metrics`` can report the
    on-device verify share (BASELINE.md north star: > 95% of verifies on
    the device; the device side counts ``verifier.rows``)."""
    from eges_tpu_torch.utils.metrics import DEFAULT as metrics

    metrics.counter("verifier.host_rows").inc(n)


class NativeBatchVerifier:
    """Batch verifier with the :class:`~eges_tpu_torch.crypto.verifier.
    BatchVerifier` interface but NO torch dependency: rows go through the
    native C++ batch recover (``geec_ec_recover_batch`` — the cgo-batch
    analogue) or, failing that, the pure-Python model.

    For nodes that cannot attach an accelerator.  Marks its OWN metrics
    (``verifier.native_rows``/``verifier.native_batches``): this is
    host work, and counting it as device rows would fake the BASELINE
    ">95% of verifies on the device" share (round-3 verdict weak #3).  The
    RPC's ``thw_metrics`` reports ``verifier.device_share`` from device
    rows only, plus ``verifier.batched_share`` for the routing share
    either batch path achieves."""

    def __init__(self):
        # injectable failure hook, same contract as BatchVerifier's:
        # called with the row count before dispatch; raising models the
        # backing implementation dying (fault-injection test surface)
        self.failure_hook = None

    def recover_addresses(self, sigs, hashes):
        import time

        from eges_tpu_torch.crypto import native
        from eges_tpu_torch.crypto.keccak import keccak256
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        n = sigs.shape[0]
        addrs = np.zeros((n, 20), np.uint8)
        ok = np.zeros((n,), bool)
        if n == 0:
            return addrs, ok
        hook = self.failure_hook
        if hook is not None:
            hook(n)
        if n == 1:
            # same steady-state anti-goal as the device facade: one-row
            # batches mean some caller bypassed the scheduler's
            # coalescer/cache (the cluster sim asserts this stays ~0)
            metrics.counter("verifier.singleton_batches").inc()
        # analysis: allow-determinism(native-path timer metric only; not journaled)
        t0 = time.monotonic()
        if native.available():
            pubs, okb = native.ec_recover_batch(
                hashes.tobytes(), sigs.tobytes(), n)
            for i in range(n):
                if okb[i]:
                    addrs[i] = np.frombuffer(
                        keccak256(pubs[64 * i : 64 * i + 64])[12:], np.uint8)
                    ok[i] = True
        else:
            from eges_tpu_torch.crypto import secp256k1 as host

            for i in range(n):
                try:
                    addrs[i] = np.frombuffer(
                        host.recover_address(bytes(hashes[i]),
                                             bytes(sigs[i])), np.uint8)
                    ok[i] = True
                # analysis: allow-swallow(invalid row reported via ok mask)
                except Exception:
                    pass
        # analysis: allow-determinism(timer metric only; not journaled)
        metrics.timer("verifier.native").update(time.monotonic() - t0)
        metrics.meter("verifier.native_rows").mark(n)
        metrics.counter("verifier.native_batches").inc()
        return addrs, ok

    def ecrecover(self, sigs, hashes):
        addrs, ok = self.recover_addresses(sigs, hashes)
        return addrs, np.zeros((sigs.shape[0], 64), np.uint8), ok

    def verify(self, sigs, hashes, pubs):
        from eges_tpu_torch.crypto import secp256k1 as host

        addrs, ok = self.recover_addresses(sigs, hashes)
        want = np.stack([
            np.frombuffer(host.pubkey_to_address(bytes(p)), np.uint8)
            for p in pubs]) if len(pubs) else addrs
        return ok & (addrs == want).all(axis=1)


class _StagedHost:
    """One window in flight through :class:`PipelinedNativeVerifier`:
    the staged input copies (the H2D analogue) plus the worker future
    the commit phase submitted."""

    __slots__ = ("sigs", "hashes", "future")


class PipelinedNativeVerifier(NativeBatchVerifier):
    """A host verifier exposing the split-phase ``stage_recover`` /
    ``commit_recover`` / ``collect_recover`` trio, so the scheduler's
    double-buffered lane pipeline is testable (and benchable) without
    a card: stage copies the arrays (the H2D analogue), commit hands the
    recover to a single background worker (the device analogue — one
    computation in flight, FIFO), collect blocks on its future.
    Results are bit-identical to :class:`NativeBatchVerifier`; only
    the overlap differs.  NOT the sim default — the chaos harness's
    byte-determinism rides the inline path."""

    def __init__(self):
        super().__init__()
        self._pool = None

    def _ensure_pool(self):
        from concurrent.futures import ThreadPoolExecutor

        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="native-pipeline")
        return self._pool

    def stage_recover(self, sigs, hashes) -> _StagedHost:
        # the failure hook fires inside the worker's recover_addresses
        # (exactly once per window), surfacing at collect_recover — the
        # same place a real device error would
        st = _StagedHost()
        st.sigs = np.array(sigs, np.uint8, copy=True)
        st.hashes = np.array(hashes, np.uint8, copy=True)
        st.future = None
        return st

    def commit_recover(self, st: _StagedHost) -> _StagedHost:
        st.future = self._ensure_pool().submit(
            NativeBatchVerifier.recover_addresses, self,
            st.sigs, st.hashes)
        return st

    def collect_recover(self, st: _StagedHost):
        return st.future.result()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class NativeMeshVerifier(NativeBatchVerifier):
    """An N-lane *virtual mesh* of host verifiers — the card-free
    analogue of the reference's mesh facade (``MeshBatchVerifier``,
    which the port has not copied yet).

    ``device_targets()`` hands the scheduler one independent
    :class:`NativeBatchVerifier` per virtual device, so sims, tier-1
    tests, and chaos scenarios exercise the full mesh dispatch machinery
    (per-device window lanes, placement, splitting, per-lane breakers)
    on hosts with no accelerator at all.  Results are bit-identical to a
    single :class:`NativeBatchVerifier` — only the dispatch fan-out
    differs."""

    def __init__(self, n_devices: int):
        super().__init__()
        if n_devices < 1:
            raise ValueError("a mesh needs at least one device")
        self._targets = [NativeBatchVerifier() for _ in range(n_devices)]

    def device_targets(self) -> list:
        return list(self._targets)


def batch_verify_txns(txns, verifier, priority: str = "bulk") -> bool:
    """Verify the signed (non-Geec) transactions of a block as one device
    batch; the single shared implementation behind both the acceptor ACK
    check and the insert-path body validation (SURVEY §3.5's two verify
    sites, core/tx_pool.go:571 and core/state_processor.go:93).

    Returns False if any signed txn is malformed or fails recovery.
    ``verifier=None`` falls back to per-txn host recovery (the
    signature_nocgo.go role).  ``priority`` is the scheduler's window
    class (``"consensus"`` preempts bulk tx-ingest windows); it only
    applies when the verifier is a scheduler.
    """
    signed = [t for t in txns if not t.is_geec and (t.r or t.s or t.v)]
    if not signed:
        return True
    parts = [t.signature_parts() for t in signed]
    if any(p is None for p in parts):
        return False
    if verifier is None:
        _count_host_rows(len(signed))
        try:
            for t in signed:
                t.sender()
        except ValueError:
            return False
        return True
    if hasattr(verifier, "recover_signers"):
        # a VerifierScheduler: entries ride the coalescing window and
        # the sender cache — the acceptor-ACK check and the insert-path
        # body validation (the two sites below) verify the SAME block's
        # signatures, so the second site becomes pure cache hits
        kw = {"priority": priority} if hasattr(verifier, "submit") else {}
        rec = verifier.recover_signers(
            [(h, sig) for sig, h in parts], **kw)
        return all(r is not None for r in rec)
    sigs = np.zeros((len(parts), 65), np.uint8)
    hashes = np.zeros((len(parts), 32), np.uint8)
    for i, (sig, h) in enumerate(parts):
        sigs[i] = np.frombuffer(sig, np.uint8)
        hashes[i] = np.frombuffer(h, np.uint8)
    _, ok = verifier.recover_addresses(sigs, hashes)
    return bool(ok.all())


def recover_signers(entries, verifier, priority: str = "bulk") -> list:
    """Batch-recover the signer address of each ``(sighash32, sig65)``
    entry; returns one 20-byte address or ``None`` per entry.

    This is the vote-authentication path (BASELINE config 3: validator
    ACK votes and election votes ride the device batch): a quorum tally
    collects signed votes, then recovers ALL signers in one device call
    and counts only votes whose signer matches the claimed author.
    ``verifier=None`` falls back to per-entry host recovery.
    ``priority="consensus"`` marks the rows consensus-critical when the
    verifier is a scheduler (vote quorums block consensus, so node.py
    passes it on every quorum/single-vote verify).
    """
    out = []
    if verifier is None:
        from eges_tpu_torch.crypto import secp256k1 as host

        _count_host_rows(len(entries))
        for h, sig in entries:
            try:
                out.append(host.recover_address(h, sig))
            except Exception:
                out.append(None)
        return out
    if hasattr(verifier, "recover_signers"):
        # a VerifierScheduler front-end: per-entry cache hits + cross-
        # caller coalescing replace the dedicated one-shot device batch
        kw = {"priority": priority} if hasattr(verifier, "submit") else {}
        return verifier.recover_signers(entries, **kw)
    sigs = np.zeros((len(entries), 65), np.uint8)
    hashes = np.zeros((len(entries), 32), np.uint8)
    for i, (h, sig) in enumerate(entries):
        if len(sig) != 65 or len(h) != 32:
            continue  # left zeroed: an all-zero sig recovers as invalid
        sigs[i] = np.frombuffer(sig, np.uint8)
        hashes[i] = np.frombuffer(h, np.uint8)
    addrs, ok = verifier.recover_addresses(sigs, hashes)
    for i in range(len(entries)):
        out.append(bytes(addrs[i]) if ok[i] else None)
    return out


def recover_signers_window(hashes, sigs, verifier,
                           priority: str = "bulk") -> list:
    """Array-native :func:`recover_signers` for the columnar ingest
    path: ``hashes`` (n,32) / ``sigs`` (n,65) uint8 arrays sliced
    straight out of a ``TxColumns`` window, one 20-byte address or
    ``None`` per row.  Per-row results are identical to
    ``recover_signers([(h, sig), ...])`` — the difference is purely
    mechanical: no per-row entry tuples, no per-row zero-fill copy, the
    arrays land in the verifier's staging buffers as-is.  Dispatch
    mirrors the entry path's three verifier shapes:

    * a :class:`~eges_tpu_torch.crypto.scheduler.VerifierScheduler` takes the
      window whole (``recover_window`` — ONE lock hold, batched cache
      probe, one window future);
    * a plain batch verifier gets the arrays directly
      (``recover_addresses`` — zero conversion);
    * ``verifier=None`` falls back to per-row host recovery, same as
      the entry path's nocgo role.
    """
    n = len(hashes)
    if n == 0:
        return []
    if verifier is None:
        from eges_tpu_torch.crypto import secp256k1 as host

        _count_host_rows(n)
        out = []
        for i in range(n):
            try:
                out.append(host.recover_address(bytes(hashes[i]),
                                                bytes(sigs[i])))
            # analysis: allow-swallow(invalid row reported as None —
            # same mask-don't-raise contract as recover_signers)
            except Exception:
                out.append(None)
        return out
    if hasattr(verifier, "recover_window"):
        return verifier.recover_window(hashes, sigs, priority=priority)
    if hasattr(verifier, "recover_signers"):
        # a scheduler-shaped verifier predating the window API: fall
        # back to entry tuples so results stay identical
        kw = {"priority": priority} if hasattr(verifier, "submit") else {}
        return verifier.recover_signers(
            [(bytes(hashes[i]), bytes(sigs[i])) for i in range(n)], **kw)
    addrs, ok = verifier.recover_addresses(sigs, hashes)
    return [bytes(addrs[i]) if ok[i] else None for i in range(n)]
