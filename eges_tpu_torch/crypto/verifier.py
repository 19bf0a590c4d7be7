"""Batched sender recovery and classic verify on the card:
``ecrecover_batch``, ``verify_batch`` and the ``BatchVerifier`` facade
that the transaction pool, the block validator and the consensus vote
checks call.

The port of ``eges_tpu/crypto/verifier.py``.  On a ``[N, ...]`` batch
the fused path runs: 18 kernel launches turn ``[N, W]`` wire
signatures (W >= 65, bytes of any integer dtype) and ``[N, 32]``
hashes into 20-byte addresses, 64-byte public keys and a validity
mask; 26 turn signatures, hashes and known ``[N, 64]`` public keys
into a validity mask.  A single row (``[65]``)
or a stacked window (``[K, N, 65]``) takes the un-fused path of
``ops/ec.py`` (about 8,400 launches, whatever the rows), as the
reference does for every shape but 2-D.  Nothing leaves the device
until the caller copies the results back.
"""

from __future__ import annotations

import functools
import os
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from eges_tpu_torch import resolve_device
from eges_tpu_torch.crypto.bucketing import bucket_round
from eges_tpu_torch.ops import ec, field, keccak
from eges_tpu_torch.ops import kernels as K
from eges_tpu_torch.ops.bigint import limbs_to_bytes_be


def _limbs(rows: torch.Tensor, *offsets: int) -> list[torch.Tensor]:
    """The big-endian 32-byte values at ``offsets`` of ``[..., n]`` uint8
    rows (any layout: the limbs come out contiguous, as the kernels take
    them) -> ``[..., 16]`` int32 limb tensors."""
    wide = rows.to(torch.int32).contiguous()
    return [field.unpack_be(wide, off) for off in offsets]


def _unpack(sigs: torch.Tensor, hashes: torch.Tensor):
    """``sigs [..., 65 or more]`` u8 (r || s || v, then any bytes),
    ``hashes [..., 32]`` u8 ->
    ``(z, r, s)`` limbs ``[..., 16]`` and ``v [...]``, all int32."""
    z, r, s = _limbs(torch.cat([hashes, sigs[..., :64]], -1), 0, 32, 64)
    return z, r, s, sigs[..., 64].to(torch.int32)


def _check_rows(sigs: torch.Tensor, hashes: torch.Tensor,
                narrowest: int = 65, widest: int | None = 65) -> None:
    """Rows of ``narrowest`` to ``widest`` bytes (no upper bound for
    ``None``) with ``[..., 32]`` hashes beside them, else ValueError."""
    width = sigs.shape[-1] if sigs.dim() else 0
    if width < narrowest or (widest is not None and width > widest):
        want = (f"{narrowest}" if widest == narrowest
                else f"{narrowest} or more")
        raise ValueError(f"sigs must be [..., {want}], got "
                         f"{tuple(sigs.shape)}")
    if tuple(hashes.shape) != (*sigs.shape[:-1], 32):
        raise ValueError(f"hashes must be [..., 32] beside sigs "
                         f"{tuple(sigs.shape)}, got {tuple(hashes.shape)}")


def words_to_bytes(rows: torch.Tensor, B: int) -> torch.Tensor:
    """``[W, Bpad]`` little-endian 32-bit words -> ``[B, 4*W]`` uint8 byte
    stream (word LSB first: the keccak byte order both the digest and the
    packed qx || qy block use)."""
    wb = rows[:, :B].to(torch.int64)
    b = torch.stack([(wb >> (8 * j)) & 0xFF for j in range(4)], dim=1)
    return b.permute(2, 0, 1).reshape(B, 4 * rows.shape[0]).to(torch.uint8)


def addr_from_digest_rows(dig: torch.Tensor, B: int) -> torch.Tensor:
    """``[8, Bpad]`` keccak digest words -> ``[B, 20]`` addresses (digest
    bytes 12..31, i.e. words 3..7)."""
    return words_to_bytes(dig[3:8], B)


@torch.inference_mode()
def ecrecover_batch(sigs: torch.Tensor, hashes: torch.Tensor):
    """Batched sender recovery.

    ``sigs [..., W]`` wire signatures for any ``W >= 65`` (r, s and v
    from bytes 0..64, as the reference's ``_unpack`` reads them; bytes
    after them are ignored) and ``hashes [..., 32]`` message hashes, byte
    values of any integer dtype (cast to uint8 once), on one device.
    Returns ``(addrs [..., 20] uint8, pubs [..., 64] uint8, ok [...]
    int32)``; invalid rows are zero with ``ok == 0``.  A ``[N, W]`` batch
    takes the fused path, whose prelude reads the rows where they lie and
    whose finish kernel already packed the masked keccak block (its first
    16 words are the big-endian bytes of qx || qy); any other shape the
    un-fused ``ecrecover_point``, then keccak of the key bytes.  A
    ``[0, W]`` batch gives empty outputs after the width checks and
    launches nothing.
    """
    sigs = keccak.as_bytes(sigs, "sigs")
    hashes = keccak.as_bytes(hashes, "hashes")
    _check_rows(sigs, hashes, 65, None)
    if sigs.dim() == 2:
        B = sigs.shape[0]
        if B == 0:  # the kernels take 1..Bpad rows
            return (sigs.new_zeros(0, 20), sigs.new_zeros(0, 64),
                    sigs.new_zeros(0, dtype=torch.int32))
        _qx, _qy, ok, words = ec.ecrecover_point_fused(sigs, hashes)
        addrs = addr_from_digest_rows(K.keccak_rows_pallas(words), B)
        pubs = words_to_bytes(words[:16], B)
        return addrs * ok[:, None].to(torch.uint8), pubs, ok
    z, r, s, v = _unpack(sigs, hashes)
    qx, qy, ok = ec.ecrecover_point(z, r, s, v)
    qx_b, qy_b = limbs_to_bytes_be(qx), limbs_to_bytes_be(qy)
    mask = ok[..., None].to(torch.uint8)
    addrs = keccak.pubkey_to_address(qx_b, qy_b)
    pubs = torch.cat([qx_b, qy_b], -1) * mask
    return addrs * mask, pubs, ok


@torch.inference_mode()
def verify_batch(sigs: torch.Tensor, hashes: torch.Tensor,
                 pubs: torch.Tensor) -> torch.Tensor:
    """Batched classic ECDSA verify against known public keys.

    ``sigs [..., W]`` uint8 for any ``W >= 64`` (r || s from bytes
    0..63; byte 64, the recovery byte, and any bytes after it are
    ignored, as the reference's ``_unpack`` reads them), ``hashes [...,
    32]`` uint8, ``pubs [..., 64]`` uint8 (x || y, big-endian), on one
    device.  Returns ``ok [...]`` int32.  Narrower rows raise
    ValueError, where the reference fails to reshape them.  A ``[N,
    ...]`` batch takes the fused path, any other shape the un-fused one;
    a ``[0, W]`` batch gives an empty ``ok`` after the width checks and
    launches nothing.
    """
    _check_rows(sigs, hashes, 64, None)
    if tuple(pubs.shape) != (*sigs.shape[:-1], 64):
        raise ValueError(f"pubs must be [..., 64] beside sigs, got "
                         f"{tuple(pubs.shape)}")
    if sigs.dim() == 2 and sigs.shape[0] == 0:  # as ecrecover_batch
        return sigs.new_zeros(0, dtype=torch.int32)
    if sigs.shape[-1] == 64:
        sigs = F.pad(sigs, (0, 1))
    z, r, s, _ = _unpack(sigs, hashes)
    return ec.ecdsa_verify_point(z, r, s, *_limbs(pubs, 0, 32))


class _StagedBatch:
    """One window mid-flight through the split-phase pipeline:
    ``stage_recover`` filled a buffer pair and started its H2D copy on
    the verifier's copy stream, ``commit_recover`` queued the recovery
    and the D2H copies on the current stream, ``collect_recover`` waits
    for them, unpads and records the batch.  Holding two of these is
    what lets the next window's fill, upload and launches overlap the
    current window's compute."""

    __slots__ = ("op", "n", "b", "pair", "done", "t0", "t1", "cached")


class _PipePair:
    """One of a bucket's two buffer pairs: pinned host inputs (plain
    tensors on the CPU), their device copies, pinned outputs, and the
    events that say when the pair's buffers are free again: ``h2d``
    after the upload that last read the host inputs, ``done`` after the
    recovery that last read the device inputs.  ``window`` is the
    window staged on the pair and not yet collected."""

    __slots__ = ("host_sigs", "host_hashes", "dev_sigs", "dev_hashes",
                 "out_addrs", "out_ok", "h2d", "done", "window")


class BatchVerifier:
    """Host facade over :func:`ecrecover_batch` and :func:`verify_batch`.

    Pads each request up to a power-of-two bucket, stages it through a
    pool of host buffers (pinned when the device is a card), runs the
    batch and returns numpy.  Runs on the card unless ``device="cpu"``
    is asked for, and raises when there is no card.

    Every batch records the reference's ``verifier.*`` metric families
    and ``verifier.batch`` span (:meth:`_record_batch`) into the port's
    registry and tracer.  Recovery also runs split-phase
    (``stage_recover`` / ``commit_recover`` / ``collect_recover``) for
    the scheduler's lane worker: two buffer pairs per bucket, the H2D
    copies on a copy stream the verifier owns, the recovery and the D2H
    copies on the caller's current stream, so at most two windows are
    in flight and window k+1's fill, upload and launches overlap window
    k's compute.  The trio is driven from one thread at a time.
    """

    # the verifier scheduler serves no row of this facade from the host
    # model: a device error fails the window instead of being answered
    # on the CPU
    host_fallback = False

    def __init__(self, device=None, min_bucket: int = 16,
                 debug_timing: bool | None = None):
        self.device = resolve_device(device)
        self._min_bucket = min_bucket
        self._pinned = self.device.type == "cuda"
        # per-bucket pool of host staging buffers; the lock covers only
        # the pop and push, so concurrent callers overlap
        self._stage_bufs: dict[int, list[dict[str, torch.Tensor]]] = {}
        self._staging_lock = threading.Lock()
        # buckets each op has already run: the port's compile-cache
        # hit/miss (a bucket's first batch pays the first launches of
        # its shapes); grow-only sets mutated GIL-atomically, a lost add
        # only stales a 'cached' flag
        self._compiled_buckets: set[int] = set()  # guarded-by: gil-monotone
        self._verify_buckets: set[int] = set()  # guarded-by: gil-monotone
        # the transfer split (h2d_seconds, d2h_seconds) waits on an
        # event after the upload, which serializes it against the
        # launches: only under the debug flag
        if debug_timing is None:
            debug_timing = os.environ.get("EGES_VERIFIER_TIMING") == "1"
        self.debug_timing = bool(debug_timing)
        # split-phase pipeline: two buffer pairs per bucket, toggled per
        # stage_recover, kept for the verifier's life so the caching
        # allocator never hands an input buffer to another stream
        self._pipe_bufs: dict[int, list[_PipePair]] = {}
        self._pipe_toggle: dict[int, int] = {}
        self._pipe_stream = None  # the copy stream, made at first stage
        # injectable device-failure hook: called with the row count at
        # the head of every device entry point (fault injection)
        self.failure_hook = None
        # the artifact store's load-vs-build account and whether this
        # verifier has its library (aot_prewarm); under _staging_lock
        self._aot_stats = {"aot_loads": 0, "aot_compiles": 0,
                           "load_s": 0.0, "compile_s": 0.0}
        self._aot_library: str | None = None  # guarded-by: _staging_lock
        self._aot_inflight = False  # guarded-by: _staging_lock

    def _maybe_fail(self, n: int) -> None:
        hook = self.failure_hook
        if hook is not None:
            hook(n)

    @property
    def device_kind(self) -> str:
        """Platform plus hardware name, e.g. ``cuda:NVIDIA H100 80GB
        HBM3`` or ``cpu:cpu``."""
        return f"{self.device.type}:{self.device_name}"

    @property
    def device_name(self) -> str:
        """The card's name (``torch.cuda.get_device_name``), or ``cpu``:
        the ``verifier.device_name`` gauge that names the hardware."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def _pad(self, n: int) -> int:
        return bucket_round(max(n, 1), self._min_bucket)

    # -- warm-up and the artifact store ------------------------------------

    def _zero_args(self, b: int) -> tuple:
        return np.zeros((b, 65), np.uint8), np.zeros((b, 32), np.uint8)

    def _warm_bucket(self, b: int) -> bool:
        """One recovery of ``b`` zero rows on the verifier's device, once
        per bucket; whether it ran.  It goes through the facade's own
        entry, so it also warms the upload and the copy back, and is
        recorded as a device batch: the bucket's compile-cache miss."""
        if b in self._compiled_buckets:
            return False
        self.recover_addresses(*self._zero_args(b))
        return True

    def prewarm(self, buckets=(16, 32, 64), background: bool = True):
        """Run the small power-of-two recover buckets once off the
        critical path, so the first block does not pay the library's
        load and the first launches; the library comes from
        ``ops/build.py`` alone, without the artifact store.  Returns the
        warmer thread in background mode, ``None`` after a synchronous
        warm."""
        buckets = tuple(dict.fromkeys(self._pad(b) for b in buckets))
        if not background:
            self._prewarm(buckets)
            return None
        t = threading.Thread(target=self._prewarm, args=(buckets,),
                             name="verifier-prewarm", daemon=True)
        t.start()
        return t

    def _prewarm(self, buckets) -> None:
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        for b in buckets:
            if self._warm_bucket(b):
                metrics.counter("verifier.prewarmed_buckets").inc()

    def _library_needed(self) -> bool:
        """Whether this verifier's batches launch the CUDA kernels: the
        plain versions on the CPU need no library."""
        return self.device.type == "cuda"

    def _build_library(self) -> dict:
        """``ops/build.py``'s build: nvcc unless the build directory
        holds the library for these sources; ``{"path", "built", ...}``.
        A failed build raises."""
        from eges_tpu_torch.ops import build
        return build.build()

    def _library_target(self) -> str:
        """Where ``ops/build.py`` loads the library from."""
        from eges_tpu_torch.ops import build
        return str(build.library_path())

    def _open_library(self) -> None:
        K.library()

    def aot_prewarm(self, buckets=(16, 32, 64), store=None,
                    background: bool = False):
        """Warm the verifier through the artifact store — the restart
        path's replacement for :meth:`prewarm`.  Puts the kernel library
        where ``ops/build.py`` loads it (``aotstore.load_or_build``: the
        build directory's own copy, else the store's, else an nvcc
        build saved for the next checkout), then runs one recovery per
        bucket on that many zero rows on the verifier's device.
        Synchronous calls return the reference's info dict
        (``buckets``, ``device_kind``, ``aot_loads``/``aot_compiles`` —
        the library loaded from the store / built by nvcc —,
        ``load_s``, ``compile_s``) for the ``verifier_aot_load`` journal
        event, plus ``library``, the mode (``"load"``, ``"compile"``,
        ``"build_dir"``, or ``None`` where no library was needed or this
        verifier had it); background mode returns the warmer thread.
        The library is this verifier's once: later calls only warm
        buckets not yet run."""
        if store is None:
            from eges_tpu_torch.crypto.aotstore import default_store
            store = default_store()
        buckets = tuple(dict.fromkeys(self._pad(b) for b in buckets))
        if background:
            t = threading.Thread(target=self._aot_prewarm,
                                 args=(buckets, store),
                                 name="verifier-aot-prewarm", daemon=True)
            t.start()
            return t
        return self._aot_prewarm(buckets, store)

    def _aot_prewarm(self, buckets, store) -> dict:
        info = {"buckets": list(buckets), "device_kind": self.device_kind,
                "aot_loads": 0, "aot_compiles": 0,
                "load_s": 0.0, "compile_s": 0.0, "library": None}
        if self._library_needed():
            mode, dt = self._aot_library_once(store)
            info["library"] = mode
            if mode == "load":
                info["aot_loads"], info["load_s"] = 1, dt
            elif mode == "compile":
                info["aot_compiles"], info["compile_s"] = 1, dt
        self._prewarm(buckets)
        return info

    def _aot_library_once(self, store):
        """Get the library unless this verifier has it (or another
        thread is getting it).  Returns ``("load"|"compile"|"build_dir",
        seconds)`` or ``(None, 0.0)``; a build-directory hit counts as
        neither a load nor a compile."""
        from eges_tpu_torch.crypto.aotstore import load_or_build
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        with self._staging_lock:
            if self._aot_library is not None or self._aot_inflight:
                return None, 0.0
            self._aot_inflight = True
        try:
            mode, dt, _ = load_or_build(store, self.device_kind,
                                        self._build_library,
                                        self._library_target())
            self._open_library()
            with self._staging_lock:
                self._aot_library = mode
                if mode == "load":
                    self._aot_stats["aot_loads"] += 1
                    self._aot_stats["load_s"] += dt
                elif mode == "compile":
                    self._aot_stats["aot_compiles"] += 1
                    self._aot_stats["compile_s"] += dt
            if mode == "load":
                metrics.counter("verifier.aot_loads").inc()
                metrics.histogram("verifier.aot_load_seconds").observe(dt)
            elif mode == "compile":
                metrics.counter("verifier.aot_compiles").inc()
                metrics.histogram("verifier.aot_export_seconds").observe(dt)
            return mode, dt
        finally:
            with self._staging_lock:
                self._aot_inflight = False

    def aot_stats(self) -> dict:
        """Load-vs-build accounting since construction (the restart
        test's "zero rebuilds" witness)."""
        with self._staging_lock:
            return dict(self._aot_stats)

    def _stage_acquire(self, b: int,
                       with_pubs: bool = False) -> dict[str, torch.Tensor]:
        """A host staging buffer set from the per-bucket pool; with
        ``with_pubs`` it also holds a ``[b, 64]`` public-key buffer."""
        with self._staging_lock:
            pool = self._stage_bufs.setdefault(b, [])
            st = pool.pop() if pool else None
        if st is None:
            st = {"sigs": self._host_buf(b, 65),
                  "hashes": self._host_buf(b, 32)}
        if with_pubs and "pubs" not in st:
            st["pubs"] = self._host_buf(b, 64)
        return st

    def _host_buf(self, b: int, width: int) -> torch.Tensor:
        return torch.zeros((b, width), dtype=torch.uint8,
                           pin_memory=self._pinned)

    def _stage_release(self, b: int, st: dict[str, torch.Tensor]) -> None:
        # only after the results are back: the upload has been consumed
        with self._staging_lock:
            self._stage_bufs.setdefault(b, []).append(st)

    def _event(self):
        """A CUDA event recorded on the current stream now; ``None`` on
        the CPU, where every copy and kernel has finished on return."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _record_batch(self, op: str, n: int, b: int, cached: bool,
                      t0: float, t1: float, t2: float, t3: float) -> None:
        """Device-batch observability shared by both device paths, as
        the reference records it (``eges_tpu/crypto/verifier.py``
        ``_record_batch``): aggregate and per-bucket device time, pad
        waste, compile-cache behavior, and — under the debug-timing flag
        only, since measuring them waits on the upload — the transfer
        halves.

        ``t0`` is taken before the upload, ``t1`` after it (after an
        event recorded behind the H2D copies under ``debug_timing``),
        ``t2`` after the event recorded behind the last kernel has
        completed and ``t3`` after the D2H copy.  In the split-phase
        path ``t1`` is taken when ``stage_recover`` has queued its
        upload, with no wait (waiting there would destroy the overlap
        the pipeline exists for), so the ``h2d_seconds``/``d2h_seconds``
        split is meaningful only on the synchronous path, as in the
        reference."""
        from eges_tpu_torch.utils import tracing
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        metrics.timer("verifier.device").update(t3 - t0)
        metrics.meter("verifier.rows").mark(n)
        metrics.counter("verifier.padded_rows").inc(b - n)
        metrics.counter("verifier.batches").inc()
        if n == 1:
            # the steady-state anti-goal: a padded one-row dispatch —
            # the scheduler diverts these to the host path, so outside
            # deliberate warmups this counter should stay at zero
            metrics.counter("verifier.singleton_batches").inc()
        metrics.histogram("verifier.device_seconds").observe(t2 - t1)
        metrics.histogram(f"verifier.device_seconds;bucket={b}") \
            .observe(t2 - t1)
        if self.debug_timing:
            metrics.histogram("verifier.h2d_seconds").observe(t1 - t0)
            metrics.histogram("verifier.d2h_seconds").observe(t3 - t2)
        metrics.histogram("verifier.pad_waste").observe((b - n) / b)
        metrics.counter("verifier.compile_cache_hits" if cached
                        else "verifier.compile_cache_misses").inc()
        tracing.DEFAULT.record_span(
            "verifier.batch", t3 - t0, op=op, rows=n, bucket=b,
            pad_rows=b - n, compile_cache="hit" if cached else "miss",
            h2d_s=round(t1 - t0, 6), device_s=round(t2 - t1, 6),
            d2h_s=round(t3 - t2, 6))

    def ecrecover(self, sigs: np.ndarray, hashes: np.ndarray):
        """``sigs [N, W]`` u8, ``hashes [N, 32]`` u8 -> ``(addrs [N, 20]
        u8, pubs [N, 64] u8, ok [N] bool)`` as numpy, after the device
        has finished.  A batch on its bucket in uint8-contiguous arrays
        goes up as it is, any ``W >= 65``; the others are staged 65 bytes
        wide, so other widths raise ValueError there, as the reference's
        staging copy does."""
        n = sigs.shape[0]
        if n == 0:
            return (np.zeros((0, 20), np.uint8), np.zeros((0, 64), np.uint8),
                    np.zeros((0,), bool))
        self._maybe_fail(n)
        b = self._pad(n)
        cached = b in self._compiled_buckets
        self._compiled_buckets.add(b)
        # a batch that lands exactly on its bucket in uint8-contiguous
        # arrays is uploaded as it is, with no staging copy
        direct = (n == b and sigs.dtype == np.uint8
                  and hashes.dtype == np.uint8
                  and sigs.flags.c_contiguous and hashes.flags.c_contiguous)
        if not direct and sigs.shape[1:] != (65,):
            raise ValueError(f"sigs: staged rows are 65 bytes wide, got "
                             f"{tuple(sigs.shape)} ({n} rows, bucket {b})")
        st = None if direct else self._stage_acquire(b)
        try:
            if direct:
                hs, hh = torch.from_numpy(sigs), torch.from_numpy(hashes)
            else:
                hs, hh = st["sigs"], st["hashes"]
                hs[:n] = torch.from_numpy(np.asarray(sigs, np.uint8))
                hs[n:] = 0
                hh[:n] = torch.from_numpy(np.asarray(hashes, np.uint8))
                hh[n:] = 0
            async_copy = st is not None and self._pinned
            t0 = time.monotonic()
            ds = hs.to(self.device, non_blocking=async_copy)
            dh = hh.to(self.device, non_blocking=async_copy)
            if self.debug_timing and self._pinned:
                self._event().synchronize()
            t1 = time.monotonic()
            addrs, pubs, ok = ecrecover_batch(ds, dh)
            done = self._event()
            if done is not None:
                done.synchronize()
            t2 = time.monotonic()
            # copying back: the staging buffers are free for the next
            # batch after this
            out = (addrs[:n].cpu().numpy(), pubs[:n].cpu().numpy(),
                   ok[:n].cpu().numpy().astype(bool))
            t3 = time.monotonic()
        finally:
            if st is not None:
                self._stage_release(b, st)
        self._record_batch("ecrecover", n, b, cached, t0, t1, t2, t3)
        return out

    def recover_addresses(self, sigs: np.ndarray, hashes: np.ndarray):
        """``(addrs [N, 20] u8, ok [N] bool)``."""
        addrs, _, ok = self.ecrecover(sigs, hashes)
        return addrs, ok

    def verify(self, sigs: np.ndarray, hashes: np.ndarray,
               pubs: np.ndarray) -> np.ndarray:
        """Classic verify: ``sigs [N, W]`` u8 of any width, ``hashes [N,
        32]`` u8, ``pubs [N, 64]`` u8 -> ``ok [N]`` bool as numpy, after
        the device has finished.  Rows are staged 65 bytes wide: wider
        ones are cut, narrower ones zero-padded, as the reference's
        facade does (``eges_tpu/crypto/verifier.py`` ``verify``).
        Bucketed, staged and recorded like :meth:`ecrecover`; the padded
        rows of every staging buffer are zeroed, so no row of an earlier
        batch reaches this one."""
        n = sigs.shape[0]
        if n == 0:
            return np.zeros((0,), bool)
        self._maybe_fail(n)
        b = self._pad(n)
        cached = b in self._verify_buckets
        self._verify_buckets.add(b)
        w = min(sigs.shape[1], 65)
        st = self._stage_acquire(b, with_pubs=True)
        try:
            hs, hh, hq = st["sigs"], st["hashes"], st["pubs"]
            hs[:n, :w] = torch.from_numpy(np.asarray(sigs[:, :w], np.uint8))
            hs[:n, w:] = 0
            hs[n:] = 0
            hh[:n] = torch.from_numpy(np.asarray(hashes, np.uint8))
            hh[n:] = 0
            hq[:n] = torch.from_numpy(np.asarray(pubs, np.uint8))
            hq[n:] = 0
            t0 = time.monotonic()
            ds, dh, dq = (t.to(self.device, non_blocking=self._pinned)
                          for t in (hs, hh, hq))
            if self.debug_timing and self._pinned:
                self._event().synchronize()
            t1 = time.monotonic()
            ok = verify_batch(ds, dh, dq)
            done = self._event()
            if done is not None:
                done.synchronize()
            t2 = time.monotonic()
            # copying back: the staging buffers are free for the next
            # batch after this
            out = ok[:n].cpu().numpy().astype(bool)
            t3 = time.monotonic()
        finally:
            self._stage_release(b, st)
        self._record_batch("verify", n, b, cached, t0, t1, t2, t3)
        return out

    # -- split-phase recovery (the scheduler's pipelined lane) -----------

    def _new_pair(self, b: int) -> _PipePair:
        p = _PipePair()
        p.host_sigs = self._host_buf(b, 65)
        p.host_hashes = self._host_buf(b, 32)
        # every upload writes all b rows: nothing to clear
        p.dev_sigs = torch.empty((b, 65), dtype=torch.uint8,
                                 device=self.device)
        p.dev_hashes = torch.empty((b, 32), dtype=torch.uint8,
                                   device=self.device)
        p.out_addrs = self._host_buf(b, 20)
        p.out_ok = torch.zeros((b,), dtype=torch.int32,
                               pin_memory=self._pinned)
        p.h2d = p.done = p.window = None
        return p

    def _pipeline_pair(self, b: int) -> _PipePair:
        # caller holds self._staging_lock; toggle between the bucket's
        # two buffer pairs so staging window k+1 never scribbles over the
        # buffers window k is still uploading from or computing on; a
        # pair whose window is still in flight is refused, and the
        # toggle stays
        pairs = self._pipe_bufs.get(b)
        if pairs is None:
            pairs = [self._new_pair(b), self._new_pair(b)]
            self._pipe_bufs[b] = pairs
        i = self._pipe_toggle.get(b, 0)
        if pairs[i].window is not None:
            raise RuntimeError("a third window in flight: collect the "
                               "window staged two before this one first")
        self._pipe_toggle[b] = i ^ 1
        return pairs[i]

    def stage_recover(self, sigs: np.ndarray,
                      hashes: np.ndarray) -> _StagedBatch:
        """Phase 1 of the pipelined dispatch: pad, fill one of the
        bucket's two pinned buffer pairs and start its H2D copy on the
        verifier's copy stream.  Returns the staged window for
        :meth:`commit_recover` / :meth:`collect_recover` — the
        scheduler's lane worker stages window k+1 while window k
        computes.  Rows are 65 bytes wide (ValueError otherwise).

        A pair is refilled only after the window that last used it has
        been collected: its done event has completed, and with it the
        upload that its recovery waited for, so the host inputs are free;
        the copy stream waits on that done event before it overwrites
        the device inputs.  So at most two windows are in flight, as on
        the scheduler's lane: staging a third before the first is
        collected raises RuntimeError."""
        n = sigs.shape[0]
        self._maybe_fail(n)
        b = self._pad(n)
        if sigs.shape[1:] != (65,) or hashes.shape[1:] != (32,):
            raise ValueError(f"staged rows are 65-byte sigs and 32-byte "
                             f"hashes, got {tuple(sigs.shape)} and "
                             f"{tuple(hashes.shape)}")
        st = _StagedBatch()
        st.op, st.n, st.b = "ecrecover", n, b
        st.done = None
        st.cached = b in self._compiled_buckets
        self._compiled_buckets.add(b)
        with self._staging_lock:
            pair = self._pipeline_pair(b)
            pair.window = st
            if self.device.type == "cuda" and self._pipe_stream is None:
                self._pipe_stream = torch.cuda.Stream(device=self.device)
        st.pair = pair
        pair.host_sigs[:n] = torch.from_numpy(np.asarray(sigs, np.uint8))
        pair.host_sigs[n:] = 0
        pair.host_hashes[:n] = torch.from_numpy(
            np.asarray(hashes, np.uint8))
        pair.host_hashes[n:] = 0
        st.t0 = time.monotonic()
        if self._pipe_stream is None:
            pair.dev_sigs.copy_(pair.host_sigs)
            pair.dev_hashes.copy_(pair.host_hashes)
        else:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._pipe_stream):
                if pair.done is None:
                    # a new pair: the caching allocator gave its device
                    # inputs out for the compute stream, where kernels
                    # queued before may still use the block; the copy
                    # stream waits for them once
                    self._pipe_stream.wait_stream(compute)
                else:
                    # the device inputs are overwritten only after the
                    # recovery that last read them
                    self._pipe_stream.wait_event(pair.done)
                pair.dev_sigs.copy_(pair.host_sigs, non_blocking=True)
                pair.dev_hashes.copy_(pair.host_hashes, non_blocking=True)
                pair.h2d = torch.cuda.Event()
                pair.h2d.record(self._pipe_stream)
        st.t1 = time.monotonic()
        return st

    def commit_recover(self, st: _StagedBatch) -> _StagedBatch:
        """Phase 2: the current stream waits for the window's upload,
        runs :func:`ecrecover_batch` on it, queues the D2H copies of
        ``addrs`` and ``ok`` into the pair's pinned outputs and records
        the window's done event.  Returns at once: nothing here waits
        for the card."""
        pair = st.pair
        try:
            if pair.h2d is not None:
                torch.cuda.current_stream(self.device).wait_event(pair.h2d)
            addrs, _pubs, ok = ecrecover_batch(pair.dev_sigs,
                                               pair.dev_hashes)
            pair.out_addrs.copy_(addrs, non_blocking=self._pinned)
            pair.out_ok.copy_(ok, non_blocking=self._pinned)
        except BaseException:
            # the window is abandoned and lets go of its pair; the next
            # upload into it is ordered after this one on the copy
            # stream, and waits for all this stream has queued
            pair.window = pair.done = None
            raise
        st.done = pair.done = self._event()
        return st

    def collect_recover(self, st: _StagedBatch):
        """Phase 3: wait for the window's done event, copy its first
        ``n`` rows out of the pinned outputs into arrays of its own, free
        the pair and record the batch.  Returns ``(addrs [n, 20] u8, ok
        [n] bool)``."""
        pair = st.pair
        if pair.window is not st:
            raise RuntimeError("collect_recover of a window that is not in "
                               "flight (collected, or its commit failed)")
        if st.done is not None:
            st.done.synchronize()
        t2 = time.monotonic()
        out = (pair.out_addrs[:st.n].numpy().copy(),
               pair.out_ok[:st.n].numpy().astype(bool))
        t3 = time.monotonic()
        pair.window = None
        self._record_batch(st.op, st.n, st.b, st.cached, st.t0, st.t1,
                           t2, t3)
        return out


@functools.lru_cache(maxsize=None)
def default_verifier(device=None) -> BatchVerifier:
    """The process-wide verifier on ``device`` (the default card unless
    the caller asks for the CPU).  It sets the ``verifier.device_name``
    gauge to the card's name, as the reference's does, so a cluster
    run's device share names its hardware (``thw_metrics``)."""
    from eges_tpu_torch.utils.metrics import DEFAULT as metrics

    v = BatchVerifier(device=device)
    metrics.gauge("verifier.device_name").set(v.device_name)
    return v
