"""The port's verifier scheduler (``eges_tpu_torch/crypto/scheduler.py``)
held against the reference's (``eges_tpu/crypto/scheduler.py``).

Every case of the reference's ``tests/test_scheduler.py``,
``tests/test_mesh_scheduler.py``, ``tests/test_adaptive_sched.py`` and
the pipeline cases of ``tests/test_aotstore.py`` that needs no device
runs here on both packages (``pkg`` is ``"ref"`` or ``"port"``): each
package's scheduler over its own ``NativeBatchVerifier``,
``PipelinedNativeVerifier`` and ``NativeMeshVerifier``, answers held
against the reference's host model.  The two cases that drive
``SimCluster`` run each package's own sim copy.

The differential cases run the same seeded entries, kick by kick,
through both packages' schedulers over each of the three targets and
compare the answers, every ``stats()`` value that does not depend on
wall time, and the journal events the chaos dump keeps (type, rows,
reason, diverted).  Everything here is host code: no torch tensor is
made.
"""

from __future__ import annotations

import importlib
import threading
import time
import types

import numpy as np
import pytest

from eges_tpu.crypto import native as ref_native
from eges_tpu.crypto import secp256k1 as host

_MODS = {
    "ref": ("eges_tpu", "eges_tpu.crypto.scheduler",
            "eges_tpu.crypto.verify_host", "eges_tpu.utils.ledger",
            "eges_tpu.utils.metrics", "eges_tpu.crypto.bucketing"),
    "port": ("eges_tpu_torch", "eges_tpu_torch.crypto.scheduler",
             "eges_tpu_torch.crypto.verify_host",
             "eges_tpu_torch.utils.ledger", "eges_tpu_torch.utils.metrics",
             "eges_tpu_torch.crypto.bucketing"),
}


def _load(which: str) -> types.SimpleNamespace:
    root, sched, vh, led, met, bk = (importlib.import_module(m)
                                     for m in _MODS[which])
    return types.SimpleNamespace(
        name=which, root=root, sched=sched, vh=vh, ledger=led,
        metrics=met.DEFAULT, bucketing=bk,
        VerifierScheduler=sched.VerifierScheduler,
        SchedulerConfig=sched.SchedulerConfig,
        scheduler_for=sched.scheduler_for,
        Native=vh.NativeBatchVerifier, Mesh=vh.NativeMeshVerifier,
        Pipelined=vh.PipelinedNativeVerifier)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return _load(request.param)


def _sign_entries(n: int, salt: int = 0) -> list[tuple[bytes, bytes]]:
    """n distinct valid ``(sighash, sig)`` entries (native-signed when
    the lib is built, pure-Python otherwise): the reference tests'
    seeded entries."""
    out = []
    for i in range(n):
        msg = (salt * 100_000 + i + 1).to_bytes(4, "big") * 8
        priv = bytes([((salt + i) % 200) + 7]) * 32
        sig = (ref_native.ec_sign(msg, priv) if ref_native.available()
               else host.ecdsa_sign(msg, priv))
        out.append((msg, sig))
    return out


def _host_model(entries) -> list:
    out = []
    for h, sig in entries:
        try:
            out.append(host.recover_address(h, sig)
                       if len(sig) == 65 and len(h) == 32 else None)
        except Exception:
            out.append(None)
    return out


def _await(sched, cond) -> None:
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        with sched._lock:
            if cond():
                return
        time.sleep(0.002)
    raise AssertionError("scheduler never reached expected state")


def test_the_port_scheduler_imports_only_the_port():
    """The copy's imports point at the port: its module-level names come
    from ``eges_tpu_torch``, and its lazy imports resolve there."""
    port = _load("port")
    assert port.sched.bucket_round is port.bucketing.bucket_round
    assert port.sched.ledger is port.ledger
    assert port.sched.profiler.__name__ == "eges_tpu_torch.utils.profiler"
    src = open(port.sched.__file__).read()
    assert "from eges_tpu." not in src and "import eges_tpu." not in src


# -- tests/test_scheduler.py ----------------------------------------------

def test_concurrent_submitters_match_host_model(pkg):
    """N threads submitting overlapping/duplicate/invalid sigs all get
    exactly the host model's answers back."""
    entries = _sign_entries(24)
    entries.append((b"\x01" * 32, b"\x00" * 65))  # valid shape, bad sig
    entries.append((b"\x02" * 32, b"\x00" * 10))  # malformed length
    expect = _host_model(entries)

    sched = pkg.scheduler_for(pkg.Native(), window_ms=2.0)
    results: dict[int, list] = {}
    errs: list = []

    def worker(k: int) -> None:
        try:
            rotated = entries[k:] + entries[:k]  # overlap across threads
            results[k] = sched.recover_signers(rotated)
        except Exception as e:  # pragma: no cover - surfaced via errs
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs
    for k, got in results.items():
        assert got == expect[k:] + expect[:k], f"thread {k} mismatch"
    st = sched.stats()
    assert st["rows"] < 6 * len(entries), st
    assert st["cache_hits"] + st["coalesced_rows"] > 0, st
    sched.close()


def test_cache_eviction_lru(pkg):
    sched = pkg.VerifierScheduler(pkg.Native(), cache_size=8)
    entries = _sign_entries(12, salt=1)
    assert sched.recover_signers(entries) == _host_model(entries)
    assert sched.stats()["cached_entries"] == 8  # first 4 evicted
    st0 = sched.stats()
    sched.recover_signers(entries[:4])
    st1 = sched.stats()
    assert st1["cache_misses"] - st0["cache_misses"] == 4
    sched.recover_signers(entries[-4:])
    st2 = sched.stats()
    assert st2["cache_hits"] - st1["cache_hits"] == 4
    assert st2["cache_misses"] == st1["cache_misses"]
    sched.close()


def test_bucket_full_flush_beats_deadline(pkg):
    """With a long window, a bucket-full batch flushes immediately while
    a lone entry waits out the deadline, and the flush reasons record
    that ordering."""
    sched = pkg.VerifierScheduler(pkg.Native(), window_ms=400.0,
                                  max_batch=4)
    entries = _sign_entries(5, salt=2)
    expect = _host_model(entries)
    t0 = time.monotonic()
    futs = [sched.submit(h, s) for h, s in entries[:4]]
    assert [f.result(30) for f in futs] == expect[:4]
    assert time.monotonic() - t0 < 0.35, "bucket-full flush waited"
    assert sched.stats()["flush_full"] == 1
    t0 = time.monotonic()
    lone = sched.submit(*entries[4])
    assert lone.result(30) == expect[4]
    assert time.monotonic() - t0 >= 0.35, "deadline flush fired early"
    st = sched.stats()
    assert st["flush_deadline"] == 1
    # the lone row was diverted to the host path, not a padded device row
    assert st["host_diverted"] == 1
    sched.close()


def test_kick_skips_deadline(pkg):
    sched = pkg.VerifierScheduler(pkg.Native(), window_ms=2000.0)
    entries = _sign_entries(3, salt=3)
    t0 = time.monotonic()
    assert sched.recover_signers(entries) == _host_model(entries)
    assert time.monotonic() - t0 < 1.5
    assert sched.stats()["flush_kick"] == 1
    sched.close()


def test_inflight_dedup_shares_one_row(pkg):
    sched = pkg.VerifierScheduler(pkg.Native(), window_ms=200.0)
    (h, s), = _sign_entries(1, salt=4)
    f1 = sched.submit(h, s)
    f2 = sched.submit(h, s)  # identical in-flight key -> same batch row
    sched.kick()
    want = _host_model([(h, s)])[0]
    assert f1.result(30) == want and f2.result(30) == want
    st = sched.stats()
    assert st["coalesced_rows"] == 1 and st["rows"] == 1
    sched.close()


def test_shutdown_drains_every_future_and_joins_thread(pkg):
    sched = pkg.VerifierScheduler(pkg.Native(), window_ms=10_000.0)
    entries = _sign_entries(6, salt=5)
    futs = [sched.submit(h, s) for h, s in entries]
    assert not any(f.done() for f in futs)  # deadline is far away
    sched.close()
    assert [f.result(0) for f in futs] == _host_model(entries)
    assert sched._thread is not None and not sched._thread.is_alive()
    f = sched.submit(*entries[0])  # post-close: inline on the caller
    assert f.result(0) == _host_model(entries[:1])[0]


def test_cluster_sim_no_singleton_batches_and_warm_cache(pkg):
    """4-node signed cluster over one shared scheduler: the chain
    advances, no steady-state one-row device batch ever happens, the
    recovery cache absorbs gossip re-verification, and every cached
    answer is bit-identical to a fresh synchronous batch-verifier run."""
    SimCluster = importlib.import_module(
        f"{pkg.root.__name__}.sim.cluster").SimCluster
    metrics = pkg.metrics

    single0 = metrics.counter("verifier.singleton_batches").value
    c = SimCluster(4, txn_per_block=2, seed=3, signed=True,
                   verifier=pkg.Native())
    c.start()
    c.run(120, stop_condition=lambda: c.min_height() >= 5)
    assert c.min_height() >= 5, c.heights()
    h = c.min_height()
    assert len({sn.chain.get_block_by_number(h).hash
                for sn in c.nodes}) == 1

    st = c.verifier.stats()
    assert metrics.counter("verifier.singleton_batches").value == single0
    assert st["cache_hits"] > 0, st
    assert st["rows"] + st["cache_hits"] >= st["cache_misses"]
    # flush decisions landed in the first node's journal
    flushes = [e for e in c.nodes[0].node.journal.events()
               if e["type"] == "verifier_flush"]
    assert len(flushes) == st["batches"]

    # bit-identical: replay a sample of the scheduler's cached answers
    # through a fresh synchronous verifier
    with c.verifier._lock:
        sample = list(c.verifier._cache.items())[:32]
    entries = [k for k, _ in sample]
    sync = pkg.Native()
    sigs = np.zeros((len(entries), 65), np.uint8)
    hashes = np.zeros((len(entries), 32), np.uint8)
    for i, (hh, ss) in enumerate(entries):
        sigs[i] = np.frombuffer(ss, np.uint8)
        hashes[i] = np.frombuffer(hh, np.uint8)
    addrs, ok = sync.recover_addresses(sigs, hashes)
    for i, (_, cached) in enumerate(sample):
        assert cached == (bytes(addrs[i]) if ok[i] else None)
    c.verifier.close()


def test_bucket16_model(pkg):
    bucket_round = pkg.bucketing.bucket_round
    assert pkg.sched._bucket16 is bucket_round
    assert [pkg.sched._bucket16(n) for n in (1, 15, 16, 17, 129)] == \
        [16, 16, 16, 32, 256]
    assert [bucket_round(n, 4) for n in (1, 4, 5, 9)] == [4, 4, 8, 16]


# -- tests/test_mesh_scheduler.py -----------------------------------------

def test_saturated_window_reaches_every_device(pkg):
    n_dev, rows = 8, 192
    # no hedging: under a loaded host a 24-row chunk can outlive the
    # hedge floor (25 ms) and be won on a sibling lane, which moves its
    # rows there (the placement this case checks is hedging's input)
    sched = pkg.VerifierScheduler(pkg.Mesh(n_dev), window_ms=10_000.0,
                                  max_batch=rows, min_split=8, hedge=False)
    entries = _sign_entries(rows, salt=10)
    futs = [sched.submit(h, s) for h, s in entries]  # fills the bucket
    assert [f.result(60) for f in futs] == _host_model(entries)
    st = sched.stats()
    assert st["lanes"] == n_dev
    assert st["flush_full"] == 1 and st["window_splits"] == 1
    devs = st["devices"]
    assert [d["device"] for d in devs] == list(range(n_dev))
    for d in devs:
        assert d["rows"] == rows // n_dev and d["batches"] == 1, devs
        assert d["occupancy"] is not None and 0 < d["occupancy"] <= 1.0
        assert d["breaker"] == "closed"
    assert sum(d["rows"] for d in devs) == st["rows"] == rows
    sched.close()


def test_concurrent_mesh_submitters_bit_identical(pkg):
    sched = pkg.VerifierScheduler(pkg.Mesh(4), window_ms=5.0,
                                  max_batch=32, min_split=4)
    entries = _sign_entries(96, salt=11)
    expect = _host_model(entries)
    results: dict[int, list] = {}
    errs: list = []
    barrier = threading.Barrier(8)

    def worker(k: int) -> None:
        try:
            barrier.wait()
            results[k] = sched.recover_signers(entries[k * 12:(k + 1) * 12])
        except Exception as e:  # pragma: no cover - surfaced via errs
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs
    for k, got in results.items():
        assert got == expect[k * 12:(k + 1) * 12], f"thread {k} mismatch"
    st = sched.stats()
    assert sum(d["rows"] for d in st["devices"]) == st["rows"]
    assert sum(d["batches"] for d in st["devices"]) == st["batches"]
    assert sum(1 for d in st["devices"] if d["rows"] > 0) >= 2, st
    sched.close()


def test_straggler_lane_diverts_only_its_own_windows(pkg):
    n_dev, victim = 4, 1
    mesh = pkg.Mesh(n_dev)

    def boom(_rows: int) -> None:
        raise RuntimeError("injected: device lost")

    # no hedging, as in the saturated case: each lane's rows stay its own
    sched = pkg.VerifierScheduler(mesh, window_ms=10_000.0, max_batch=64,
                                  min_split=8, hedge=False)
    sched._lanes[victim].target.failure_hook = boom
    entries = _sign_entries(64, salt=12)
    futs = [sched.submit(h, s) for h, s in entries]
    assert [f.result(60) for f in futs] == _host_model(entries)
    st = sched.stats()
    dv = st["devices"][victim]
    assert dv["breaker"] == "open" and dv["device_errors"] == 1
    assert dv["straggler_diverts"] >= 1
    for d in st["devices"]:
        if d["device"] != victim:
            assert d["breaker"] == "closed" and d["device_errors"] == 0
            assert d["rows"] > 0, st
    assert st["breaker"] == "open"
    entries2 = _sign_entries(64, salt=13)
    futs2 = [sched.submit(h, s) for h, s in entries2]
    assert [f.result(60) for f in futs2] == _host_model(entries2)
    st2 = sched.stats()
    assert st2["devices"][victim]["breaker_diverted"] >= 16
    assert st2["devices"][victim]["device_errors"] == 1
    sched.close()


def test_close_drains_lanes_then_stops_threads(pkg):
    sched = pkg.VerifierScheduler(pkg.Mesh(4), window_ms=10_000.0,
                                  max_batch=256, min_split=4)
    entries = _sign_entries(32, salt=14)
    futs = [sched.submit(h, s) for h, s in entries]
    assert not any(f.done() for f in futs)
    sched.close()
    assert [f.result(0) for f in futs] == _host_model(entries)
    assert sched.stats()["flush_close"] == 1
    assert sched._thread is not None and not sched._thread.is_alive()
    for lane in sched._lanes:
        assert lane.thread is None or not lane.thread.is_alive()
        assert not lane.queue and lane.queued_rows == 0
    f = sched.submit(*entries[0])
    assert f.result(0) == _host_model(entries[:1])[0]


def test_stats_per_device_breakdown_keeps_legacy_keys(pkg):
    sched = pkg.VerifierScheduler(pkg.Mesh(2), window_ms=2.0)
    entries = _sign_entries(8, salt=15)
    assert sched.recover_signers(entries) == _host_model(entries)
    st = sched.stats()
    for k in ("cache_hits", "cache_misses", "coalesced_rows", "batches",
              "rows", "bucket_rows", "host_diverted", "kicks",
              "flush_full", "flush_deadline", "flush_kick",
              "flush_close", "invalid", "device_errors", "breaker_trips",
              "breaker_probes", "breaker_diverted", "cached_entries",
              "pending", "breaker"):
        assert k in st, k
    assert st["lanes"] == 2 and st["window_splits"] >= 0
    assert [d["device"] for d in st["devices"]] == [0, 1]
    for d in st["devices"]:
        for k in ("queue_depth", "max_queue_depth", "inflight_rows",
                  "breaker", "batches", "rows", "bucket_rows",
                  "host_diverted", "straggler_diverts", "device_errors",
                  "breaker_trips", "breaker_probes", "breaker_diverted",
                  "occupancy"):
            assert k in d, k
    sched.close()


def test_single_lane_scheduler_spawns_no_lane_workers(pkg):
    sched = pkg.VerifierScheduler(pkg.Native(), window_ms=2.0)
    entries = _sign_entries(4, salt=16)
    assert sched.recover_signers(entries) == _host_model(entries)
    assert sched.stats()["lanes"] == 1
    assert sched._lanes[0].thread is None
    sched.close()


def test_scheduler_for_attaches_mesh_scheduler_once(pkg):
    mesh = pkg.Mesh(2)
    s1 = pkg.scheduler_for(mesh)
    assert s1.stats()["lanes"] == 2
    assert pkg.scheduler_for(mesh) is s1
    s1.close()
    s2 = pkg.scheduler_for(mesh)  # a closed scheduler is replaced
    assert s2 is not s1 and s2.stats()["lanes"] == 2
    s2.close()


# -- tests/test_adaptive_sched.py -----------------------------------------

def test_mesh_cluster_sim_advances_and_uses_lanes(pkg):
    """4-node signed sim over an 8-lane virtual mesh (the
    ``mesh_devices`` wiring in sim/cluster.py): consensus converges and
    the shared scheduler reports the per-device surface."""
    SimCluster = importlib.import_module(
        f"{pkg.root.__name__}.sim.cluster").SimCluster

    c = SimCluster(4, txn_per_block=2, seed=5, signed=True,
                   mesh_devices=8)
    c.start()
    c.run(120, stop_condition=lambda: c.min_height() >= 4)
    assert c.min_height() >= 4, c.heights()
    h = c.min_height()
    assert len({sn.chain.get_block_by_number(h).hash
                for sn in c.nodes}) == 1
    st = c.verifier.stats()
    assert st["lanes"] == 8
    assert sum(d["rows"] for d in st["devices"]) == st["rows"]
    # mesh dispatch decisions landed in the journal stream
    events = [e for sn in c.nodes for e in sn.node.journal.events()
              if e["type"] == "verifier_mesh_dispatch"]
    assert sum(d["batches"] for d in st["devices"]) == st["batches"]
    assert events, "mesh dispatch events missing from the journal"
    assert all(e["rows"] >= 1 and "device" in e for e in events)
    c.verifier.close()


def test_config_env_overrides(pkg):
    cfg = pkg.SchedulerConfig.from_env({
        "EGES_SCHED_WINDOW_MS": "7.5", "EGES_SCHED_FLIGHT_RING": "8",
        "EGES_SCHED_ADAPTIVE": "yes", "EGES_SCHED_HEDGE": "0"})
    assert cfg.window_ms == 7.5 and cfg.flight_ring == 8
    assert cfg.adaptive is True and cfg.hedge is False
    assert cfg.max_batch == pkg.SchedulerConfig().max_batch


def test_config_malformed_env_raises(pkg):
    with pytest.raises(ValueError):
        pkg.SchedulerConfig.from_env({"EGES_SCHED_MAX_BATCH": "lots"})


def test_config_reaches_scheduler_and_legacy_kwargs_win(pkg, monkeypatch):
    monkeypatch.setenv("EGES_SCHED_WINDOW_MS", "7.5")
    monkeypatch.setenv("EGES_SCHED_FLIGHT_RING", "8")
    sched = pkg.VerifierScheduler(pkg.Native())
    try:
        assert sched.config.window_ms == 7.5
        assert sched._flights.maxlen == 8
    finally:
        sched.close()
    sched = pkg.VerifierScheduler(pkg.Native(), window_ms=3.0)
    try:
        assert sched.config.window_ms == 3.0
        assert sched.config.flight_ring == 8
    finally:
        sched.close()


def test_flight_ring_size_and_dropped_counter(pkg):
    sched = pkg.VerifierScheduler(pkg.Native(), window_ms=10_000.0,
                                  flight_ring=4)
    try:
        for k in range(6):
            futs = [sched.submit(h, s)
                    for h, s in _sign_entries(3, salt=k + 1)]
            sched.kick()
            for f in futs:
                assert f.result(30) is not None
        st = sched.stats()
        assert st["batches"] == 6
        assert len(sched.flights()) == 4
        assert st["flight_dropped"] == 2 and st["flight_capacity"] == 4
    finally:
        sched.close()


def _window(sched, n: int, salt: int) -> list:
    """One kicked window of ``n`` signed rows, entered in one lock hold."""
    entries = _sign_entries(n, salt=salt)
    h = np.stack([np.frombuffer(e[0], np.uint8) for e in entries])
    s = np.stack([np.frombuffer(e[1], np.uint8) for e in entries])
    return sched.recover_window(h, s)


def test_adaptive_controller_shrinks_and_grows_on_burn(pkg):
    cfg = pkg.SchedulerConfig(window_ms=4.0, max_batch=64, adaptive=True,
                              min_window_ms=0.5, max_window_ms=8.0,
                              min_target_rows=4, adapt_recent=4)
    sched = pkg.VerifierScheduler(pkg.Native(), config=cfg)
    burn = [2.0]
    sched.burn_probe = lambda: (burn[0], burn[0])
    try:
        def window(salt: int) -> None:
            # the rows enter in one lock hold (submit_window): row by row
            # (the reference's case) the shrinking deadline can flush a
            # window before its last row, one decision more
            assert all(r is not None for r in _window(sched, 3, salt))

        for k in range(3):
            window(k + 1)
        st = sched.stats()
        assert st["adapt_decisions"] == 3
        assert st["window_ms"] == 0.5 and st["target_rows"] == 8
        burn[0] = 0.0
        for k in range(3):
            window(k + 10)
        st = sched.stats()
        assert st["adapt_decisions"] == 6
        assert st["window_ms"] > 0.5 and st["target_rows"] == 64
    finally:
        sched.close()


def test_adaptive_derived_burn_without_probe(pkg):
    cfg = pkg.SchedulerConfig(window_ms=4.0, max_batch=64, adaptive=True,
                              slo_p99_ms=1e-4, min_window_ms=0.25,
                              min_target_rows=4)
    sched = pkg.VerifierScheduler(pkg.Native(), config=cfg)
    try:
        for k in range(5):
            assert all(r is not None for r in _window(sched, 2, k + 20))
        st = sched.stats()
        assert st["adapt_decisions"] == 5 and st["window_ms"] == 0.25
    finally:
        sched.close()


def test_hedge_bit_identical_results_and_exactly_once_billing(pkg):
    mesh = pkg.Mesh(2)
    cfg = pkg.SchedulerConfig(window_ms=10_000.0, hedge=True,
                              hedge_floor_ms=10.0, hedge_poll_ms=2.0)
    sched = pkg.VerifierScheduler(mesh, config=cfg)
    release = threading.Event()
    victim = mesh.device_targets()[0]
    orig = victim.recover_addresses

    def _stuck(sigs, hashes):
        release.wait(30)
        return orig(sigs, hashes)

    victim.recover_addresses = _stuck
    entries = _sign_entries(6, salt=3)
    entries.append((b"\x01" * 32, b"\x00" * 65))   # invalid row rides too
    expect = _host_model(entries)
    led = pkg.ledger.IngressLedger(clock=time.monotonic)
    try:
        with pkg.ledger.bind(led, "peerX"):
            futs = [sched.submit(h, s) for h, s in entries]
        sched.kick()
        assert [f.result(30) for f in futs] == expect
        st = sched.stats()
        assert st["hedges"] >= 1 and st["hedge_wins"] >= 1
        billed = dict(led.snapshot()["costs"].get("peerX", {}))
        assert billed.get("device_ms", 0.0) > 0.0
        rows_before = st["rows"]
        flights_before = len(sched.flights())
        release.set()
        sched.close()
        st = sched.stats()
        assert st["rows"] == rows_before
        assert len(sched.flights()) == flights_before
        assert st["hedges"] == st["hedge_cancelled"] + st["hedge_wasted"]
        after = led.snapshot()["costs"].get("peerX", {})
        assert abs(after["device_ms"] - billed["device_ms"]) < 0.05
        assert after["host_ms"] == billed["host_ms"] == 0.0
    finally:
        release.set()
        sched.close()


def test_hedge_loser_cancelled_before_execution(pkg):
    mesh = pkg.Mesh(2)
    # a hedge floor of 200 ms (the reference's case: 10 ms): on a loaded
    # host window A may otherwise be hedged onto lane 1 before window B
    # lands there, and B never occupies lane 1
    cfg = pkg.SchedulerConfig(window_ms=10_000.0, hedge=True,
                              hedge_floor_ms=200.0, hedge_poll_ms=2.0)
    sched = pkg.VerifierScheduler(mesh, config=cfg)
    gates = [threading.Event(), threading.Event()]
    served: list[tuple[int, int]] = []
    for lane_i, tgt in enumerate(mesh.device_targets()):
        orig = tgt.recover_addresses

        def _gate(sigs, hashes, _i=lane_i, _orig=orig, _ev=gates[lane_i]):
            _ev.wait(30)
            served.append((_i, len(sigs)))
            return _orig(sigs, hashes)

        tgt.recover_addresses = _gate
    ent_a = _sign_entries(2, salt=40)     # -> lane 0, inflight, stuck
    ent_b = _sign_entries(4, salt=41)     # -> lane 1, inflight, stuck
    ent_c = _sign_entries(2, salt=42)     # -> lane 0 queue, behind A
    expect = _host_model(ent_a + ent_b + ent_c)
    futs = [sched.submit(h, s) for h, s in ent_a]
    sched.kick()
    _await(sched, lambda: sched._lanes[0].inflight_rows == 2)
    futs += [sched.submit(h, s) for h, s in ent_b]
    sched.kick()
    _await(sched, lambda: sched._lanes[1].inflight_rows == 4)
    futs += [sched.submit(h, s) for h, s in ent_c]
    sched.kick()
    _await(sched, lambda: len(sched._lanes[0].queue) == 1)
    try:
        # wait for the hedge thread to copy C onto lane 1's queue, then
        # release lane 1 alone: every future must resolve without lane 0
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with sched._lock:
                if sched._stats["hedges"] >= 3:
                    break
            time.sleep(0.005)
        gates[1].set()
        assert [f.result(30) for f in futs] == expect
        assert all(i == 1 for i, _n in served)
        gates[0].set()
        sched.close()
        st = sched.stats()
        assert st["hedges"] == 3 and st["hedge_wins"] >= 2
        assert st["hedge_cancelled"] >= 1
        assert st["hedges"] == st["hedge_cancelled"] + st["hedge_wasted"]
        wasted_rows = sum(n for i, n in served if i == 0)
        assert sum(n for _i, n in served) == 8 + wasted_rows
    finally:
        for ev in gates:
            ev.set()
        sched.close()


def test_consensus_preempts_bulk_at_placement(pkg):
    mesh = pkg.Mesh(2)
    sched = pkg.VerifierScheduler(
        mesh, config=pkg.SchedulerConfig(window_ms=10_000.0, hedge=False))
    gates = [threading.Event(), threading.Event()]
    for lane_i, tgt in enumerate(mesh.device_targets()):
        orig = tgt.recover_addresses

        def _gate(sigs, hashes, _orig=orig, _ev=gates[lane_i]):
            _ev.wait(30)
            return _orig(sigs, hashes)

        tgt.recover_addresses = _gate

    def window(n: int, salt: int, priority: str) -> list:
        futs = [sched.submit(h, s, priority=priority)
                for h, s in _sign_entries(n, salt=salt)]
        sched.kick()
        return futs

    futs = window(4, 50, "bulk")
    _await(sched, lambda: sched._lanes[0].inflight_rows == 4)
    futs += window(10, 51, "bulk")
    _await(sched, lambda: sched._lanes[1].inflight_rows == 10)
    futs += window(4, 52, "bulk")
    _await(sched, lambda: len(sched._lanes[0].queue) == 1)
    futs += window(2, 53, "consensus")
    _await(sched, lambda: len(sched._lanes[0].queue) == 2)
    with sched._lock:
        queued = [tk.klass for tk in sched._lanes[0].queue]
    try:
        assert queued == ["consensus", "bulk"]
        for ev in gates:
            ev.set()
        for f in futs:
            assert f.result(30) is not None
        waits = sched.stats()["class_wait_ms"]
        assert waits["consensus"]["count"] == 2
        assert waits["bulk"]["count"] == 18
        assert waits["consensus"]["p99_ms"] >= 0.0
    finally:
        for ev in gates:
            ev.set()
        sched.close()


# -- tests/test_aotstore.py: the double-buffered window pipeline ----------

def _slow_pipelined(pkg, delay_s: float):
    class Slow(pkg.Pipelined):
        def recover_addresses(self, sigs, hashes):
            time.sleep(delay_s)
            return super().recover_addresses(sigs, hashes)

    return Slow()


def test_pipelined_scheduler_matches_host_and_overlaps(pkg):
    entries = _sign_entries(96, salt=60)
    expect = _host_model(entries)
    sched = pkg.VerifierScheduler(_slow_pipelined(pkg, 0.01), window_ms=1.0,
                                  max_batch=16)
    try:
        futs = [sched.submit(h, s) for h, s in entries]
        assert [f.result(60) for f in futs] == expect
    finally:
        sched.close()
    st = sched.stats()
    assert st["pipeline_windows"] > 0
    # a deep queue over a slow lane MUST overlap
    assert st["pipeline_overlapped"] >= 1
    assert 0.0 < st["pipeline_overlap_ratio"] <= 1.0
    assert st["devices"][0]["pipeline_overlap_ratio"] == \
        st["pipeline_overlap_ratio"]


def test_pipelined_failure_surfaces_at_collect(pkg):
    v = pkg.Pipelined()
    calls = {"n": 0}

    def hook(n):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device fault")

    v.failure_hook = hook
    sched = pkg.VerifierScheduler(v, window_ms=1.0, max_batch=16)
    try:
        entries = _sign_entries(48, salt=61)
        futs = [sched.submit(h, s) for h, s in entries]
        assert [f.result(60) for f in futs] == _host_model(entries)
    finally:
        sched.close()
    assert calls["n"] >= 1
    assert sched.stats()["device_errors"] == 1


def test_inline_path_untouched_for_plain_verifier(pkg):
    sched = pkg.VerifierScheduler(pkg.Native(), window_ms=1.0,
                                  max_batch=16)
    try:
        entries = _sign_entries(24, salt=62)
        futs = [sched.submit(h, s) for h, s in entries]
        assert [f.result(60) for f in futs] == _host_model(entries)
    finally:
        sched.close()
    st = sched.stats()
    assert st["pipeline_windows"] == 0
    assert st["pipeline_overlap_ratio"] == 0.0


# -- the port against the reference, kick by kick -------------------------

# stats() keys whose values depend on wall time: latencies, whether a
# lane worker found its next window queued in time to overlap it, how
# deep a lane's queue got before its worker popped, and whether a kick
# found rows still pending (a window past max_batch flushes without one)
_WALL_KEYS = {"pipeline_overlapped", "pipeline_overlap_ratio",
              "class_wait_ms", "window_ms", "target_rows",
              "max_queue_depth", "kicks"}


class _Journal:
    """The scheduler's journal surface: ``record(type, **attrs)``."""

    def __init__(self):
        self.events: list[tuple] = []

    def record(self, type_: str, **attrs) -> None:
        # what the chaos dump keeps of a window event
        self.events.append((type_, attrs.get("rows"), attrs.get("reason"),
                            attrs.get("diverted")))


def _rounds():
    """Seeded rounds of entries, each entering whole before its kick (a
    window in one lock hold, or entries no more than a window holds), so
    the windows they form do not depend on timing: duplicates within a
    window, repeats of earlier rounds (cache hits), an invalid and a
    malformed row, a window past ``max_batch`` (split on the mesh) and a
    singleton (host-diverted)."""
    a, b, c = (_sign_entries(n, salt=s) for n, s in ((20, 70), (9, 71),
                                                     (1, 72)))
    bad = [(b"\x01" * 32, b"\x00" * 65), (b"\x02" * 32, b"\x00" * 10)]
    return [("window", a + a[:3]), ("signers", a[:2] + bad + b[:4]),
            ("signers", c), ("window", b + a[10:14]),
            ("signers", a[:4] + c)]


def _drive(pkg, kind: str):
    target = {"native": pkg.Native, "pipelined": pkg.Pipelined,
              "mesh": lambda: pkg.Mesh(2)}[kind]()
    journal = _Journal()
    sched = pkg.VerifierScheduler(target, window_ms=10_000.0,
                                  max_batch=16, min_split=4, hedge=False)
    sched.journal = journal
    answers = []
    try:
        for how, entries in _rounds():
            if how == "signers":
                answers.append(sched.recover_signers(entries))
                continue
            h = np.stack([np.frombuffer(e[0], np.uint8) for e in entries])
            s = np.stack([np.frombuffer(e[1], np.uint8) for e in entries])
            answers.append(sched.recover_window(h, s))
    finally:
        sched.close()
        if kind == "pipelined":
            target.close()
    st = sched.stats()
    flat = {k: v for k, v in st.items() if k not in _WALL_KEYS | {"devices"}}
    devices = [{k: v for k, v in d.items() if k not in _WALL_KEYS}
               for d in st["devices"]]
    events = journal.events
    if kind == "mesh":
        # which lane a chunk lands on follows the lanes' loads at the
        # moment it is placed, and the lanes record their windows
        # concurrently: per lane only the keys, over the lanes the sums
        # and the events as a multiset
        devices = [sorted(devices[0]), len(devices), {
            k: sum(d[k] for d in devices) for k in devices[0]
            if isinstance(devices[0][k], int) and k != "device"}]
        events = sorted(events, key=repr)
    return answers, flat, devices, events


@pytest.mark.parametrize("kind", ["native", "pipelined", "mesh"])
def test_port_scheduler_equals_the_reference(kind):
    """Same entries, kick by kick: the same answers (and the host
    model's), the same counts and the same journal events."""
    ref = _drive(_load("ref"), kind)
    port = _drive(_load("port"), kind)
    assert port[0] == ref[0]
    assert port[0] == [_host_model(e) for _how, e in _rounds()]
    assert set(port[1]) == set(ref[1])
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert port[1]["batches"] == len([e for e in port[3]
                                      if e[0] == "verifier_flush"])
    assert (port[1]["pipeline_windows"] > 0) == (kind == "pipelined")
