"""The port's facade metrics (A2), split-phase recovery (A4) and device
stats (A6) on the CPU, against the reference.

* ``BatchVerifier(device="cpu")``'s ``stage_recover`` /
  ``commit_recover`` / ``collect_recover`` give the bytes ``ecrecover``
  gives on the same rows, with window k+1 staged before window k is
  collected, the bucket's two buffer pairs toggling, and a third window
  in flight refused.  These cases swap the
  recovery graph for a cheap stand-in (the reference's tests do the
  same with ``_graph_fns``), so the plumbing runs in milliseconds; the
  real recovery runs three times in this file (a plain recovery is some
  5 s here), once through the synchronous facade and twice through the
  trio under the scheduler, which must answer as the synchronous facade
  does on 9 signed rows and an invalid one.
* ``_record_batch`` writes the same families, labels and values into
  the port's registry, and the same ``verifier.batch`` span into its
  tracer, as the reference's ``eges_tpu.crypto.verifier.BatchVerifier.
  _record_batch`` does into the reference's, with ``debug_timing`` off
  and on.
* ``GoodputLedger`` and ``DevstatsAssembler`` give the reference's
  snapshots and reports on the same sequence; ``sample_memory`` is
  ``{}`` without CUDA; ``DeviceTraceArmer`` writes a trace from the
  first armed window's dispatch to the last one's end.
* The scheduler over the port's facade serves no row from the host
  model: a device error fails the window.
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch

from eges_tpu.crypto import secp256k1 as host
from eges_tpu.utils import devstats as ref_devstats
from eges_tpu.utils import metrics as ref_metrics
from eges_tpu.utils import tracing as ref_tracing
from eges_tpu_torch import testing as tt
from eges_tpu_torch.crypto import scheduler as S
from eges_tpu_torch.crypto import verifier as V
from eges_tpu_torch.utils import devstats, metrics, tracing

torch.set_num_threads(1)


def _entries():
    """9 signed rows and one invalid (r = 0), as ``(hash, sig)``."""
    rng = np.random.default_rng(20261018)
    sigs, hashes, _ = tt.signed_rows(rng, 9)
    out = [(bytes(h), bytes(s)) for s, h in zip(sigs, hashes)]
    out.append((b"\x07" * 32, bytes(64) + b"\x01"))
    return out


def _arrays(entries):
    return (np.stack([np.frombuffer(s, np.uint8) for _h, s in entries]),
            np.stack([np.frombuffer(h, np.uint8) for h, _s in entries]))


@pytest.fixture(scope="module")
def sync_answers():
    """One recovery through the synchronous facade."""
    entries = _entries()
    sigs, hashes = _arrays(entries)
    addrs, ok = V.BatchVerifier(device="cpu").recover_addresses(sigs, hashes)
    answers = [bytes(addrs[i]) if ok[i] else None
               for i in range(len(entries))]
    want = []
    for h, s in entries:
        try:
            want.append(host.recover_address(h, s))
        except ValueError:
            want.append(None)
    assert answers == want
    return entries, answers


def test_scheduler_over_the_cpu_facade_answers_as_the_facade(sync_answers):
    """Two windows of 5 rows through the scheduler's pipelined lane (the
    facade's trio, the second staged before the first is collected)
    answer as the synchronous facade; a second pass is served from the
    cache with no new window."""
    entries, want = sync_answers
    bv = V.BatchVerifier(device="cpu")
    sched = S.scheduler_for(bv, max_batch=5, window_ms=10_000.0)
    try:
        assert sched.recover_signers(entries) == want
        st0 = sched.stats()
        assert st0["batches"] == 2 and st0["pipeline_windows"] == 2
        assert st0["pipeline_overlapped"] == 1
        assert st0["host_diverted"] == st0["breaker_diverted"] == 0
        assert st0["device_errors"] == 0 and st0["breaker"] == "closed"
        assert [len(p) for p in bv._pipe_bufs.values()] == [2]
        assert sched.recover_signers(entries) == want
        st1 = sched.stats()
        assert st1["batches"] == st0["batches"]
        assert st1["cache_hits"] - st0["cache_hits"] == len(entries)
    finally:
        sched.close()
    assert S.scheduler_for(bv) is not sched  # closed: replaced


# -- the trio's plumbing, on a stand-in graph -----------------------------

def _stand_in(sigs, hashes):
    """A cheap graph of the recovery's shapes: ``addrs`` the rows' first
    20 bytes xor their hash's, ``pubs`` zero, ``ok`` where v < 2."""
    addrs = sigs[:, :20] ^ hashes[:, :20]
    ok = (sigs[:, 64] < 2).to(torch.int32)
    return addrs * ok[:, None].to(torch.uint8), sigs.new_zeros(
        sigs.shape[0], 64), ok


def _rows(rng, n):
    sigs = rng.integers(0, 256, (n, 65), dtype=np.uint8)
    sigs[:, 64] = rng.integers(0, 3, n)
    return sigs, rng.integers(0, 256, (n, 32), dtype=np.uint8)


def test_trio_gives_ecrecover_bytes_and_toggles_pairs(monkeypatch):
    monkeypatch.setattr(V, "ecrecover_batch", _stand_in)
    rng = np.random.default_rng(3)
    bv = V.BatchVerifier(device="cpu")
    wins = [_rows(rng, n) for n in (5, 16, 11, 3)]
    want = []
    for s, h in wins:
        a, _p, ok = bv.ecrecover(s, h)
        want.append((a, ok))
    # window k+1 staged and committed before window k is collected
    st = [bv.commit_recover(bv.stage_recover(*wins[0]))]
    got = []
    for k in range(1, len(wins)):
        st.append(bv.commit_recover(bv.stage_recover(*wins[k])))
        got.append(bv.collect_recover(st[k - 1]))
    got.append(bv.collect_recover(st[-1]))
    for (a, ok), (wa, wok) in zip(got, want):
        assert a.dtype == np.uint8 and ok.dtype == bool
        assert np.array_equal(a, wa) and np.array_equal(ok, wok)
    # one bucket (16): its two pairs alternate
    assert {w.b for w in st} == {16}
    assert st[0].pair is not st[1].pair
    assert st[0].pair is st[2].pair and st[1].pair is st[3].pair
    assert len(bv._pipe_bufs[16]) == 2
    # collected rows are the window's own: refilling its pair later
    # leaves them as they were
    assert np.array_equal(got[0][0], want[0][0])


def test_third_window_in_flight_is_refused(monkeypatch):
    monkeypatch.setattr(V, "ecrecover_batch", _stand_in)
    rng = np.random.default_rng(4)
    bv = V.BatchVerifier(device="cpu")
    wins = [_rows(rng, 7) for _ in range(3)]
    want = [bv.recover_addresses(*w) for w in wins]
    st = [bv.commit_recover(bv.stage_recover(*w)) for w in wins[:2]]
    # the third window would take the first one's pair while it is in
    # flight
    with pytest.raises(RuntimeError, match="third window in flight"):
        bv.stage_recover(*wins[2])
    # the refusal takes no pair: once the first window is collected, the
    # third takes its pair while the second is still in flight
    got = [bv.collect_recover(st[0])]
    st.append(bv.commit_recover(bv.stage_recover(*wins[2])))
    assert st[2].pair is st[0].pair
    got += [bv.collect_recover(s) for s in st[1:]]
    for (a, ok), (wa, wok) in zip(got, want):
        assert np.array_equal(a, wa) and np.array_equal(ok, wok)
    # a collected window cannot be collected again
    with pytest.raises(RuntimeError, match="not in flight"):
        bv.collect_recover(st[0])


def test_failed_commit_frees_its_pair(monkeypatch):
    rng = np.random.default_rng(5)
    bv = V.BatchVerifier(device="cpu")
    win = _rows(rng, 7)

    def broken(s, h):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(V, "ecrecover_batch", broken)
    for _ in range(2):
        st = bv.stage_recover(*win)
        with pytest.raises(RuntimeError, match="launch failed"):
            bv.commit_recover(st)
        with pytest.raises(RuntimeError, match="not in flight"):
            bv.collect_recover(st)
    monkeypatch.setattr(V, "ecrecover_batch", _stand_in)
    want = bv.recover_addresses(*win)
    got = bv.collect_recover(bv.commit_recover(bv.stage_recover(*win)))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])


def test_stage_checks_widths_and_runs_the_failure_hook(monkeypatch):
    monkeypatch.setattr(V, "ecrecover_batch", _stand_in)
    bv = V.BatchVerifier(device="cpu")
    s, h = _rows(np.random.default_rng(5), 4)
    with pytest.raises(ValueError, match="65-byte"):
        bv.stage_recover(np.pad(s, ((0, 0), (0, 1))), h)
    seen = []
    bv.failure_hook = seen.append
    bv.collect_recover(bv.commit_recover(bv.stage_recover(s, h)))
    assert seen == [4]


# -- _record_batch against the reference ----------------------------------

_ARGS = [("ecrecover", 5, 16, False, 1.0, 1.25, 1.5, 1.75),
         ("ecrecover", 1, 16, True, 2.0, 2.5, 3.0, 3.5),
         ("verify", 100, 128, False, 4.0, 4.125, 4.625, 5.0)]


def _comparable(snap: dict) -> dict:
    """A registry snapshot without the meters' rates (wall time)."""
    return {k: ({kk: vv for kk, vv in v.items()
                 if not kk.startswith("rate")} if isinstance(v, dict)
                else v) for k, v in snap.items()}


@pytest.mark.parametrize("debug_timing", [False, True])
def test_record_batch_matches_the_reference(monkeypatch, debug_timing):
    from eges_tpu.crypto import verifier as RV

    regs = {"ref": ref_metrics.Registry(), "port": metrics.Registry()}
    tracers = {"ref": ref_tracing.Tracer(), "port": tracing.Tracer()}
    monkeypatch.setattr(ref_metrics, "DEFAULT", regs["ref"])
    monkeypatch.setattr(metrics, "DEFAULT", regs["port"])
    monkeypatch.setattr(ref_tracing, "DEFAULT", tracers["ref"])
    monkeypatch.setattr(tracing, "DEFAULT", tracers["port"])
    stub = types.SimpleNamespace(debug_timing=debug_timing)
    port = V.BatchVerifier(device="cpu", debug_timing=debug_timing)
    for args in _ARGS:
        RV.BatchVerifier._record_batch(stub, *args)
        port._record_batch(*args)
    snaps = {k: _comparable(r.snapshot()) for k, r in regs.items()}
    assert snaps["port"] == snaps["ref"]
    assert ("verifier.h2d_seconds" in snaps["port"]) == debug_timing
    assert snaps["port"]["verifier.device_seconds;bucket=16"]["count"] == 2
    assert snaps["port"]["verifier.singleton_batches"] == 1
    assert snaps["port"]["verifier.compile_cache_hits"] == 1
    spans = {k: [(s["name"], s["duration_s"], s["attrs"])
                 for s in t.finished()] for k, t in tracers.items()}
    assert spans["port"] == spans["ref"]
    assert [s[0] for s in spans["port"]] == ["verifier.batch"] * 3


def test_debug_timing_reads_the_environment(monkeypatch):
    monkeypatch.setenv("EGES_VERIFIER_TIMING", "1")
    assert V.BatchVerifier(device="cpu").debug_timing is True
    assert V.BatchVerifier(device="cpu",
                           debug_timing=False).debug_timing is False
    monkeypatch.setenv("EGES_VERIFIER_TIMING", "0")
    assert V.BatchVerifier(device="cpu").debug_timing is False


def test_facade_records_every_batch_with_cache_hits(monkeypatch):
    monkeypatch.setattr(V, "ecrecover_batch", _stand_in)
    reg = metrics.Registry()
    monkeypatch.setattr(metrics, "DEFAULT", reg)
    bv = V.BatchVerifier(device="cpu")
    s, h = _rows(np.random.default_rng(6), 12)
    bv.ecrecover(s, h)
    bv.ecrecover(s[:3], h[:3])
    bv.collect_recover(bv.commit_recover(bv.stage_recover(s, h)))
    snap = reg.snapshot()
    assert snap["verifier.batches"] == 3
    assert snap["verifier.compile_cache_misses"] == 1
    assert snap["verifier.compile_cache_hits"] == 2
    assert snap["verifier.padded_rows"] == 4 + 13 + 4
    assert snap["verifier.rows"]["count"] == 27
    assert snap["verifier.device_seconds;bucket=16"]["count"] == 3
    assert "verifier.h2d_seconds" not in snap


# -- device stats ---------------------------------------------------------

def _windows(led):
    led.observe_window(0, 10, 16, cache_rows=3, dedup_rows=1)
    led.observe_window(0, 16, 16, hedged=True)
    led.observe_window(1, 1, 1, diverted=True)
    led.observe_hedge_waste(1, 12, 16)
    first = led.snap()
    led.observe_window(1, 100, 128, cache_rows=7)
    led.observe_window(0, 5, 16)
    led.note_memory({0: {"bytes_in_use": 5, "peak_bytes": 9,
                         "limit_bytes": 80}})
    return first, led.snap(), led.stats()


def test_goodput_ledger_matches_the_reference():
    ref = _windows(ref_devstats.GoodputLedger())
    port = _windows(devstats.GoodputLedger())
    assert port == ref
    assert port[0]["devices"]["0"]["rows"] == 26
    assert port[2]["goodput_ratio"] == round(131 / 176, 4)


def test_assembler_matches_the_reference_and_takes_the_ports_roofline():
    led = devstats.GoodputLedger()
    journal = []

    class J:
        def record(self, type_, **attrs):
            journal.append({"type": type_, "node": "n0",
                            "seq": len(journal), "ts": float(len(journal)),
                            **attrs})

    led.observe_window(0, 10, 16, cache_rows=2)
    led.journal_snapshot(J())
    led.observe_window(0, 60, 64)
    led.observe_window(1, 30, 32)
    led.journal_snapshot(J())
    ref = ref_devstats.assemble({"n0": journal})
    port = devstats.assemble({"n0": journal})
    # the reference anchors its roofline to a TPU capture; the port has
    # none until one is set from its own bound
    for rep in (ref, port):
        rep.pop("roofline_source")
        for d in rep["devices"].values():
            d.pop("fraction_of_roofline")
            for b in d["buckets"].values():
                b.pop("ceiling_rows_per_s")
    assert port == ref
    try:
        ceil = devstats.roofline_from_bounds({64: 0.032})
        assert ceil == {64: 2_000_000.0}
        devstats.set_roofline(ceil, "test bound")
        rep = devstats.assemble({"n0": journal})
        assert rep["roofline_source"] == "test bound"
        assert rep["devices"]["0"]["buckets"]["64"][
            "ceiling_rows_per_s"] == 2_000_000.0
        assert rep["devices"]["0"]["fraction_of_roofline"] is not None
    finally:
        devstats.set_roofline({}, "")
    assert devstats.load_roofline() == {"source": None, "ceilings": {}}


def test_sample_memory_is_empty_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert devstats.sample_memory() == {}
    assert devstats.sample_memory(devices=[0]) == {}


def test_trace_armer_traces_the_windows_it_claims(tmp_path):
    """The capture starts at the first armed window's claim (its
    dispatch) and stops at the last claimed window's step, whatever
    was recorded between."""
    arm = devstats.GoodputLedger().trace
    st = arm.arm(2, outdir=str(tmp_path))
    assert st["state"] == "armed" and st["armed_windows"] == 2
    assert arm.claim()
    assert arm.status()["state"] == "tracing"
    torch.ones(8).add_(1)
    assert arm.claim()
    assert not arm.claim()  # only two windows were armed
    arm.step()
    assert arm.status()["state"] == "tracing"  # one claimed window left
    arm.step()
    st = arm.status()
    assert st["state"] == "captured" and st["captures"] == 1
    path = os.path.join(st["path"], "trace.json")
    assert st["path"] == str(tmp_path / "device_trace.000")
    with open(path) as fh:
        assert "traceEvents" in json.load(fh)
    assert not arm.claim()  # disarmed: no second capture
    assert arm.status()["captures"] == 1
    # disarmed mid-capture: the claimed window still ends it
    arm.arm(3)
    assert arm.claim()
    assert arm.disarm()["state"] == "tracing"
    arm.step()
    assert arm.status()["captures"] == 2


def test_trace_armer_over_the_scheduler_claims_device_windows(tmp_path):
    """Armed for 2 windows, a scheduler over a host target claims its
    first two windows at their dispatch and stops the capture when the
    second is done; the third is not traced."""
    from eges_tpu_torch.crypto.verify_host import NativeBatchVerifier

    arm = devstats.DEFAULT.trace
    captures = arm.status()["captures"]
    arm.arm(2, outdir=str(tmp_path))
    sched = S.VerifierScheduler(NativeBatchVerifier(), max_batch=4,
                                window_ms=10_000.0)
    try:
        sched.recover_window(*reversed(_rows(np.random.default_rng(6), 12)))
    finally:
        sched.close()
    st = arm.status()
    assert st["state"] == "captured" and st["captures"] == captures + 1
    assert st["armed_windows"] == 0 and not st["active"]


def test_scheduler_drives_the_trio_from_its_lane_worker_only(monkeypatch):
    """Over the port's facade every window, a singleton too, runs on the
    lane worker: the trio is driven from one thread, so a singleton
    dispatched inline beside the lane's two windows in flight cannot
    stage a third."""
    import threading

    threads = []

    def stand_in(sigs, hashes):
        threads.append(threading.get_ident())
        return _stand_in(sigs, hashes)

    monkeypatch.setattr(V, "ecrecover_batch", stand_in)
    bv = V.BatchVerifier(device="cpu")
    sigs, hashes = _rows(np.random.default_rng(8), 9)
    sched = S.VerifierScheduler(bv, max_batch=4, window_ms=10_000.0)
    try:
        want = [bytes(a) if o else None
                for a, o in zip(*bv.recover_addresses(sigs, hashes))]
        threads.clear()
        assert sched.recover_window(hashes[:8], sigs[:8]) == want[:8]
        assert sched.recover_signers([(bytes(hashes[8]),
                                       bytes(sigs[8]))]) == want[8:]
        st = sched.stats()
    finally:
        sched.close()
    assert len(threads) == 3 and len(set(threads)) == 1
    assert threads[0] != threading.get_ident()
    assert st["pipeline_windows"] == st["batches"] == 3
    assert st["host_diverted"] == 0


def _raise(rows):
    raise RuntimeError(f"device lost ({rows} rows)")


def test_scheduler_over_the_facade_serves_nothing_from_the_host():
    """Over the port's facade (``host_fallback = False``) a device error
    fails the window's futures instead of being answered by the host
    model, the breaker stays closed, a singleton goes to the device,
    and a row submitted after close fails."""
    from eges_tpu_torch.crypto import verify_host

    rng = np.random.default_rng(7)
    sigs, hashes = _rows(rng, 10)
    entries = [(bytes(h), bytes(s)) for s, h in zip(sigs, hashes)]
    bv = V.BatchVerifier(device="cpu")
    assert bv.host_fallback is False
    sched = S.VerifierScheduler(bv, max_batch=16, window_ms=10_000.0)
    seen = []
    sched.failure_hook = lambda rows: (seen.append(rows), _raise(rows))
    host_rows = metrics.DEFAULT.snapshot().get("verifier.host_rows", 0)
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            sched.recover_signers(entries)
        with pytest.raises(RuntimeError, match="device lost"):
            sched.recover_window(hashes[:3], sigs[:3])
        single = sched.submit(*entries[0])
        sched.kick()
        with pytest.raises(RuntimeError, match=r"device lost \(1 rows\)"):
            single.result(30)
        st = sched.stats()
        assert seen == [10, 3, 1]
        assert st["device_errors"] == 3
        assert st["host_diverted"] == st["breaker_diverted"] == 0
        assert st["breaker_trips"] == 0 and st["breaker"] == "closed"
    finally:
        sched.close()
    late = sched.submit(*entries[1])
    with pytest.raises(RuntimeError, match="closed"):
        late.result(0)
    assert metrics.DEFAULT.snapshot().get("verifier.host_rows",
                                          0) == host_rows
    # a host target keeps the reference's divert: the same failure is
    # answered by the host model and trips the breaker
    ref = S.VerifierScheduler(verify_host.NativeBatchVerifier(),
                              max_batch=16, window_ms=10_000.0)
    ref.failure_hook = _raise
    try:
        got = ref.recover_signers(entries[:4])
        assert not any(isinstance(g, BaseException) for g in got)
        st = ref.stats()
        assert st["breaker_trips"] == st["device_errors"] == 1
        assert st["breaker"] == "open"
    finally:
        ref.close()
