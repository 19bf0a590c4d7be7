"""Drive eges_tpu_torch's paths on one CUDA card: batched sender
recovery, classic ECDSA verify and Keccak-256, the un-fused
recovery and verify of stacked windows, the same paths under the
reference's TPU-tiling configuration, the profiling harness, the
static-analysis gate with the analysis fixture's kernel (#21), a
simulated 64-validator Geec cluster over the card's verifier, the
PoW engine's nonce sweep and a 3-node chain of node processes on the
card.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a
machine with a card and the CUDA toolkit.  Phases, one JSON line each:

1. build: compile ``eges_tpu_torch/ops/csrc`` with nvcc for sm_90a (one
   nvcc for each source, ``ladder.cu`` one for each lane count, all
   started together); seconds, and registers, stack frame and spills
   per kernel, which must be 0 and 0 for every pow, table and ladder
   instance ``lanes_for`` can pick and for every prelude, y_fix, u1u2,
   GLV, fp_mul, fp_canon, finish and keccak_rows instance.  Then sass:
   the built code (``cuobjdump``) issues at least the operations
   ``ops/opcount.py`` counts, in every kernel without a branch or a call
   and in every loop of the product chain and of the pow (a T-lane pow's
   loops against a lane's share, the count over T, and so on the
   shortest path through each prelude, y_fix, u1u2, GLV, fp_mul,
   fp_canon, finish and keccak_rows instance, keccak_rows' round loop
   taken as many trips as its 24 rounds need and held to a lane's share
   of a trip's rounds), so no operation bound counts more than the card
   does; with the instruction mix of the chain's loop.
2. kernel: each of the twenty-one kernels at its path's shapes on
   seeded random and extreme inputs, held bit for bit against its plain
   PyTorch version on the same CUDA tensors (tolerance 0: the arithmetic
   is integer), and timed against it with CUDA events; registers and
   spills beside each.  Recovery's eleven at B = 8192 rows (16*B =
   131072 for fp_mul, fp_canon and the table pow); fn_mul, fn_red17
   and fp_add at B = 1024 (the verify batch cap); keccak_block at
   B = 4000 (a config-4 block's transaction hashes); the six glue
   kernels of the un-fused path at its shapes for a [4, 1024] window
   (K*N = 4096 rows, 8192 for the GLV split of both scalars), each also
   checked at a ragged 4097 rows (keccak_rows at 4097 columns; fp_mul,
   fp_canon, y_fix and u1u2 also on views 4, 8 and 12 bytes off a
   16-byte boundary, the prelude at
   pitches 66 and 70 and 1, 4 and 8 bytes off; the GLV split on the edge
   scalars, fp_canon on values at and past P).  Every kernel of the
   recovery path, and the verify and keccak paths' own four, also timed
   one call at a time on cold L2 (``cold_ms``),
   with the share of the bound that time reaches, fp_mul, fp_canon and
   the prelude beside a cold stream of the same bytes
   (``stream_cold_ms``).
3. slice: one block of BASELINE config 4 (1024 validators / 32-member
   committee, 4000 transactions: 4000 sender recoveries plus 1024 vote
   signatures, 5024 rows) through ``BatchVerifier().recover_addresses``,
   every row held against the host model, with the launch counts of
   that run (18 per batch); then ``ecrecover_batch`` on the same rows as
   ``[N, 66]`` uint8 and ``[N, 65]`` int32, byte-equal to ``[N, 65]``
   uint8; batches of no rows through ``ecrecover_batch`` and
   ``verify_batch`` (empty on the card, no launch) and int32/int64 byte
   rows through ``keccak256_fixed`` and ``pubkey_to_address`` (the uint8
   rows' digests; faults C5 and C6).
3b. lanes: every (T, block) instance of the pow, the point table, the
   ladder, the GLV split, fp_mul, the finish, the prelude, u1u2, y_fix
   and keccak_rows (T = 1, 2, 4, 8 lanes a row; 64, 128, 256 threads),
   and every block size of fp_canon (one lane a row), at 256, 1024, 4096
   and 8192 rows (mod P and mod N for the pow, and the table's 16384 and
   131072 rows mod P, fp_mul and fp_canon also at 16384 and 131072,
   fp_mul on a ragged view 4 bytes off, fp_canon on a view 4 bytes off
   at 131072, the prelude on every class of its checks and at a pitch of
   66 and 1 byte off, u1u2 with r^-1 = 0 rows and on a view 4 bytes off,
   y_fix on roots equal to P and squares and on a view 4 bytes off,
   keccak_rows also at 4097 columns; the ladder also on a recovery's own
   inputs at 1024 and 8192; the point table on seeded
   points and on the R of phase 3's block padded to its bucket, invalid
   rows and zero-byte pad rows among them), bit for bit against the
   plain version, timed by events and cold beside the bound, with
   registers, stack and spills and the instance ``lanes_for`` picks,
   which must beat T = 1 (the GLV split, fp_mul, fp_canon, the finish,
   the prelude, u1u2, y_fix and keccak_rows by cold times; fp_mul and
   the finish within 3%, and fp_mul may pick T = 1; fp_canon's block and
   the prelude's, u1u2's and y_fix's picks within 3% of the fastest, and
   the prelude and y_fix may pick T = 1; keccak_rows' pick faster than
   every one-lane instance).  Cold times are taken every instance once
   a round; a pick they put behind its rival is timed again against it
   alone in fresh rounds, and fails if it is behind there too.
4. e2e: verifies/s at 8192 rows (all rows of 20 batches over their
   summed time; p50 and p90 of the batch times beside it), p50/p99
   latency of recover_addresses at 1024 rows (1000 calls), peak device
   memory; the SM clock, power draw and throttle reasons, sampled by
   ``nvidia-smi`` every 20 ms over 1.5 s of back-to-back 8192-row
   batches (an ``sm_clock`` line); under the profiler, the device ms of
   each of the four pow launches and of the ladder in one recovery of
   8192 and of 1024 rows
   (a traced window that lacks a launch is traced again, three windows
   at most: the profiler has dropped a window's first kernel).
4b. sched: the block of phase 3 through the verifier scheduler,
   ``scheduler_for(BatchVerifier())``, from four threads (two by
   ``recover_signers``, two by ``submit_window`` in windows of 1024
   rows): every answer equal to the host model's and the synchronous
   facade's, then the same entries again, served from the cache with no
   window; nothing served by the host model (no breaker trip, no divert,
   singleton windows on the card too), every window pipelined through
   the facade's split-phase trio (18 launches each, the ``sched`` path
   of the ``kernels`` line), and a device error under the scheduler
   failing its window instead of being answered on the host; the
   facade's A2 metric families against those windows,
   ``verifier.batch`` spans, device memory (``devstats.sample_memory``)
   and a ``DeviceTraceArmer`` trace armed for two windows of three sent,
   which must hold both windows' 18 kernels.  Then 20 back-to-back
   windows of 1024 distinct rows and 10 of 8192 in ABBA rounds: through
   the trio with two windows in flight, through the trio with one
   window in flight (the same work, no overlap) and through serial
   ``recover_addresses`` (verifies/s of each, the card's busy and idle
   share under the profiler); through a scheduler (its
   ``pipeline_overlap_ratio``); and one ``commit_recover``'s enqueue
   time against its done time (it fails if the enqueue takes 0.8 of it,
   naming the host waits in it).
5. verify slice: a BASELINE config-3 vote round (256 committee
   signatures against the validators' 64-byte keys) and a config-4 one
   (1024 rows, the consensus verify batch cap), every row class of
   ``testing.VERIFY_CLASSES`` among mostly valid rows, through
   ``BatchVerifier().verify``; every row held against the host model's
   ``ecdsa_verify``, with the launch counts of one batch (26).
6. keccak slice: 4000 one-block messages of 110 bytes, 8192 public keys
   through ``pubkey_to_address`` and 1024 two-block messages of 200
   bytes through ``keccak256_fixed``, every digest held against the
   host ``keccak256``.
7. verify e2e: p50/p99 of ``verify`` at 1024 and 256 rows (1000 calls
   each) and verifies/s over the 1024-row window; then, at 1024 rows
   on device tensors, the host's time to enqueue one ``verify_batch``
   and one ``ecrecover_batch`` against the time until the card is done
   (p50 of 100 each).

8. stacked: a [4, 1024, 65] window cut from phase 3's config-4 rows
   (recovery ids 2 and 3 and every invalid class among them) through
   ``ecrecover_batch``, and a [4, 256, ...] window of config-3 vote rows
   through ``verify_batch``: the un-fused path, every row held byte for
   byte against the fused path on the same rows flattened and against
   the host model, launches by kernel equal to the pinned counts of
   ``testing.UNFUSED_*_LAUNCHES`` (about 8,400 a batch); p50 of a few
   batches, and the host's enqueue time against the done time.
9. tiling: the reference's TPU-tiling configuration
   (``EGES_TPU_LANE_BLOCK=1024 EGES_TPU_ROWS8=1 EGES_TPU_KECCAK_GRID=1``,
   ``testing.tiling_config``).  First its three kernels (``tiling.cu``),
   one ``tiling_kernel`` line each: pow_mod_rows8 at the four pow
   launches of a recovery batch (8192 rows, 131072 for the table's pow;
   p and n), strauss_tab_rows8 at 8192 rows, the keccak round kernel at
   8192 columns, each held bit for bit against its plain version on the
   same tiles, also at a ragged count (1030 pow rows, a 1000-row ladder
   of two windows, 4097 keccak columns), and timed beside its
   default-layout twin (#2, #9, #11) on the same values, with the
   reference-contract wrapper's time (re-lay included), the plain
   version's, the bound and registers and spills.  Then the slice under
   the configuration: phase 3's block through ``recover_addresses``
   (byte-equal to phase 3 and the host model, 18 launches as
   ``testing.TILING_RECOVER_LAUNCHES`` pins them), the config-3 and
   config-4 vote rounds through ``verify`` (26 launches), phase 6's 4000
   one-block messages through ``keccak256_fixed`` (one round-kernel
   launch) and a stacked ``[4, 1024]`` recovery window (equal to the
   fused default path, 4 of its launches pow_mod_rows8).
10. tiling_ab: the default and tiling configurations in turns (three
   rounds each, ABBA order) in this one call: recovery verifies/s at
   8192 rows and p50 at 1024 rows, verify p50 at 1024 and 256 rows;
   each configuration's median and spread.
11. profile: the eight harness modules through their ``main``s on the
   card, each line prefixed with the module's name: ``profile_mulchain``
   at 4096 and 131072, ``profile_mul8b`` (``correct=`` must hold),
   ``profile_floor`` (all eight child configs must report),
   ``measure_recover`` at 1024 and 8192 (its gate must hold),
   ``profile_kernels2`` at 4096 (into ``build/``), ``profile_stages``
   at 1024 and the launch census ``hlo_census`` at 1024 and 8192 (its
   hand-written kernels by name must equal the fused path's 18 launches,
   a short window traced again as in phase 4; the device time of each
   launch, by kernel, and the card's idle share of the window), then a
   census of one 1024-row ``verify_batch`` (its 26 launches; verify's
   own kernels' device times, the window's idle share) and the device
   time of the keccak_block launch of 4000 110-byte messages.  Then the
   harness's four kernels (``profile.cu``), one ``profile_kernel`` line
   for each kernel and shape: the 64-multiply chain on ``[16, B]``
   columns at lane blocks of 256 and 1024 (#20a, also at a ragged 4096 +
   128 columns with lane 128), on rows8 tiles (#20b), one multiply on
   tiles (#20c, with #7 ``fp_mul``'s time on the same values), each at
   B = 4096 and 131072, and the copy kernel on one (8, 128) float32 tile
   (#20d, with ``x + 1.0``'s time as its library time), and #21
   ``mul_scalar_f32`` on that tile and on 2^24 float32 elements (with
   ATen's ``x * s`` as its library time, which must not beat the byte
   bound either; at 2^24 also on views that start off 16 bytes and
   counts that leave a scalar tail); each held bit for bit against its
   plain version (float32 by bit pattern), timed with CUDA events back
   to back and one call at a time on cold L2 (the kernel alone) beside
   its bound and the plain version's time.  #21 and #20d then run
   against their library calls in ABBA rounds (``profile_ab`` lines:
   events and cold, medians and spreads).
12. analysis: the port's static-analysis gate
   (``eges_tpu_torch.harness.analysis``) over this checkout, which must
   show no unsuppressed finding, no error and no stale baseline (finding
   counts by rule, seconds); the seeded launch-purity fixture must
   still fire; then #21's path, the reference fixture's ``run(x)`` (x
   times the host clock) on one (8, 128) tile through
   ``mul_scalar_f32``, against its plain version.

13. sim: BASELINE config 2 on the port, ``SimCluster(64,
   n_candidates=8, n_acceptors=16, txn_per_block=1000, txpool=True,
   columnar=True, verifier=BatchVerifier())`` with SIM_BLOCKS x 1000
   signed transfers from 100 funded senders, which every pool admits in
   flooder windows of 250 through the columnar seam before the first
   block (``testing.flood_sim``), until every node's chain holds every
   transfer; the same committee with a flooder that gossips
   SIM_GOSSIP's transfers over the network, which every node admits
   and relays; then a 64-node signed-vote sim to height 5
   (``tests/test_scale.py:63``'s setting).  Each run on the card under
   the profiler, then its twin over the port's ``NativeBatchVerifier``
   on the same seed, one after the other in this process, after phases
   2-12: heights, block hashes, the height of each transfer, txpool
   stats, network counts and the canonical journal dump without
   ``testing.VERIFIER_ONLY`` events, node for node; ``host_diverted`` 0
   and 18 launches a device window.  One line a run: wall seconds,
   device windows, rows, cache hits, rows a window (p50, max), rows a
   second, the card's idle share (its kernels' device time by
   ``torch.profiler`` over the wall), launches.
14. pow: ``PowEngine()`` on the card (sweeps of 4096 nonces, one
   keccak_block launch each) mines 3 blocks at difficulty 2^15 with the
   headers of ``PowEngine(use_device=False)``'s host loop.
15. node: BASELINE config 1 on the port's node service: the port's
   ``harness/cluster.py`` banks the kernel library in the artifact store
   (``warm_kernel_store``: the build directory's library since phase 1)
   and takes it out of the build directory, then starts 3 ``python -m
   eges_tpu_torch.node --verifier torch`` processes on localhost (real
   sockets on free port bases, 1000 txn a block, signed votes, RPC on),
   each loading the library from the store as in a new checkout; 1000
   signed transfers from 100 senders over ``eth_sendRawTransaction``
   round robin on the three RPC ports and 300 UDP Geec txns through
   ``txn_client`` into node 0, sent before the transfers (ROADMAP C9:
   a card node under the transfers' flood wins few elections, and only
   its own blocks take its UDP txns); every transfer
   mined with status 0x1, every sender's nonce its transfers' count,
   balances, nonces and the head hash at a common height equal across
   nodes, 80% of the UDP txns on chain; each node's ``thw_metrics``:
   device rows, a device share above 0.95 (host rows beside it), no
   host-diverted row, the card's name (``verifier.device_name``), 18
   launches a device batch over the traffic, the cold start and the
   store's loads and builds; a ``thw_device_trace`` armed on node 0 for
   2 windows holding 18 kernels a window; then the same traffic on a
   ``--verifier native`` twin cluster, which must mine the same
   transfers to the same balances and nonces.  Wall seconds, heights,
   device windows, rows a window and the p50 send-to-receipt time.

Every kernel's time, and each cold time, must lie above its bound:
a bound the card beats is no floor, and the run fails.

Then the ``kernels`` line (launches summed over the paths' runs, and per
path), the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits nonzero; without a CUDA card the script exits 2 and prints no
result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
B_MAIN = 8192                       # the bucket 5024 rows pad to
ROWS_BASELINE4 = 4000 + 1024        # txn senders + vote signatures
DISTINCT = 256                      # distinct signed rows, tiled
RUNS_8192 = 20                      # timed batches at 8192 rows
RUNS_1024 = 1000                    # p99 with ten samples beyond it
B_VERIFY = 1024                     # consensus verify_batch_rows cap
B_KECCAK = 4000                     # transaction hashes of a config-4 block
COMMITTEE = 256                     # BASELINE config 3 committee
RUNS_VERIFY = 1000
RUNS_SPLIT = 100                    # enqueue vs done, per path
STACK = (4, 1024)                   # a stacked recovery window, K x N
STACK_VERIFY = (4, 256)             # a stacked window of config-3 votes
RUNS_STACKED = 5                    # timed stacked batches per path
RAGGED = 4097                       # glue kernels' ragged-edge check
RAGGED_POW8 = 1030                  # rows8 pow: two tiles, one ragged
RAGGED_LADDER = (1000, 2)           # rows8 ladder: rows of one tile, windows
AB_ROUNDS = ("default", "tiling", "tiling", "default", "default",
             "tiling")              # the A/B's order, three rounds each
AB_8192 = 5                         # timed 8192-row batches a round
AB_CALLS = 100                      # timed calls a round for each p50
B_PROFILE = (4096, 131072)          # the harness's batch; one filling 132 SMs
RAGGED_CHAIN = (4096 + 128, 128)    # #20a's ragged check: columns, lane
# phase lanes: the ladder and the point table at the 256-row vote round,
# the latency bucket, half and all of the main batch, the pow's B-row
# launches (p: sqrt and Z^-1, n: r^-1) at the same counts and its table
# launches (16 B rows) of the 1024- and 8192-row batches
LANE_SHAPES = (("strauss_tab", 256), ("strauss_tab", 1024),
               ("strauss_tab", 4096), ("strauss_tab", 8192),
               ("point_table", 256), ("point_table", 1024),
               ("point_table", 4096), ("point_table", 8192),
               ("pow_mod_p", 256), ("pow_mod_p", 1024), ("pow_mod_p", 4096),
               ("pow_mod_p", 8192), ("pow_mod_n", 256), ("pow_mod_n", 1024),
               ("pow_mod_n", 4096), ("pow_mod_n", 8192),
               ("pow_mod_p", 16384), ("pow_mod_p", 131072),
               *(("fp_mul", r) for r in (256, 1024, 4096, 8192, 16384,
                                         131072)),
               *(("recover_finish", r) for r in (256, 1024, 4096, 8192)),
               *(("glv_digits", r) for r in (256, 1024, 4096, 8192)),
               *(("fp_canon", r) for r in (256, 1024, 4096, 8192, 16384,
                                           131072)),
               *(("recover_prelude", r) for r in (256, 1024, 4096, 8192)),
               *(("u1u2", r) for r in (256, 1024, 4096, 8192)),
               *(("y_fix", r) for r in (256, 1024, 4096, 8192)),
               *(("keccak_rows", r) for r in (256, 1024, 4096, 8192)))
# the lane kernels whose launch takes less than the wrapper's host time:
# timed cold beside events (phases kernel and lanes, which picks and
# checks them by cold times); every instance must build clean, and phase
# sass holds each on its shortest path
SHORT_LANE_KERNELS = ("glv_digits", "fp_mul", "fp_canon", "recover_finish",
                      "recover_prelude", "u1u2", "y_fix", "keccak_rows")
# the lanes a row a kernel's instances take where not all of K.LANES
# (fp_canon: one lane a row, its block size swept)
KERNEL_LANES = {"fp_canon": (1,)}
# the lane kernels whose pick must be within 3% of the fastest instance
# cold, and those of them that may keep one lane a row (fp_canon has only
# one; bytes may bound the prelude and y_fix)
NEAR_FASTEST = ("fp_canon", "recover_prelude", "u1u2", "y_fix")
ONE_LANE_OK = ("fp_canon", "recover_prelude", "y_fix")
# keccak_rows' round loop: the 24 rounds of a column, one a trip
KECCAK_ROUNDS = 24
# phase lanes: rounds of the fresh head-to-head that a pick whose first
# times put it behind its rival is held to
CONFIRM_ROUNDS = 25
CENSUS_BATCHES = (1024, 8192)       # hlo_census's recoveries
PROFILE_TRIES = 3                   # traced windows a profiled check takes
# the ladder also on a recovery's own inputs: its digits' zeros are not
# random (window 0 is zero on most rows), which is what parted warps; the
# point table on the R of the config-4 block (its invalid rows, the x = 0
# of r = 0 among them, and its zero-byte pad rows up to the bucket)
LANE_RECOVERY_ROWS = (1024, 8192)
TABLE_RECOVERY_ROWS = (256, 1024, 4096, 8192)
MEASURE_BATCHES = (1024, 8192)      # measure_recover's batches
# phase sched: the config-4 block from this many submitter threads (half
# by recover_signers, half by submit_window in windows of SCHED_WINDOW)
SCHED_THREADS, SCHED_WINDOW = 4, 1024
# DeviceTraceArmer: windows armed, windows sent, seed offset; the trace
# must hold the armed windows' 18 kernels each (_armed_trace)
SCHED_TRACE = (2, 3, 31)
# back-to-back windows of distinct rows: (rows, windows); ABBA rounds of
# the trio with two windows in flight, the trio with one, and serial
# recover_addresses
SCHED_OVERLAP = ((1024, 20), (8192, 10))
SCHED_ROUNDS = ("pipelined", "trio_serial", "serial",
                "serial", "trio_serial", "pipelined") * 2
SCHED_SPLIT_RUNS = 20               # commits timed, enqueue against done
# commit's enqueue must take under this share of its time until done
SCHED_ENQUEUE_SHARE = 0.8
# CPU ops that block the host on the card (the profiler's names)
HOST_WAIT_OPS = frozenset({
    "aten::item", "aten::_local_scalar_dense", "aten::nonzero",
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy"})
# the facade's A2 metric families (eges_tpu/crypto/verifier.py:496-542)
A2_FAMILIES = ("verifier.device", "verifier.rows", "verifier.padded_rows",
               "verifier.batches", "verifier.singleton_batches",
               "verifier.device_seconds", "verifier.pad_waste",
               "verifier.compile_cache_hits",
               "verifier.compile_cache_misses")
CLOCK_SECONDS = 1.5                 # batches the clock sampler sees, s
# native/Makefile's flags less -fopenmp, for a toolchain without libgomp
NATIVE_CXXFLAGS = "-O3 -fPIC -std=c++17 -Wall"
# phase sim: BASELINE config 2 (a 64-validator committee, 1000 txn a
# block; candidates and acceptors as tests/test_scale.py) over
# SimCluster(verifier=BatchVerifier()); SIM_BLOCKS blocks' worth of
# signed transfers from SIM_SENDERS funded accounts, SIM_WINDOW a
# flooder window; the gossip run: SIM_GOSSIP's transfers gossiped by the
# flooder (blocks of as many txns: a 1000-txn block costs the host about
# two minutes a height at 64 nodes; 5 transfers, 64 x 5 x 63 relays, so
# that the script with phase node stays well inside its limit); then the
# signed-vote run of
# tests/test_scale.py:63 to its height.  Each run's native-verifier twin
# runs after it on the same seed.
SIM_NODES, SIM_CANDIDATES, SIM_ACCEPTORS = 64, 8, 16
SIM_TXN_PER_BLOCK, SIM_BLOCKS, SIM_SENDERS, SIM_WINDOW = 1000, 1, 100, 250
SIM_SEED = 14
SIM_GOSSIP = {"transfers": 5, "window": 5, "txn_per_block": 5,
              "seed": 15}
SIM_SIGNED = {"txn_per_block": 2, "seed": 33, "height": 5}
# phase pow: PowEngine() on the card at its default sweep of 4096 nonces,
# POW_BLOCKS blocks on a chain whose genesis difficulty makes a block
# take about POW_DIFFICULTY / 4096 sweeps
POW_BLOCKS, POW_DIFFICULTY = 3, 1 << 15
# phase node: BASELINE config 1 (a 3-node bootstrap Geec chain, 1000 txn
# a block) as real node processes on the card, with its traffic: signed
# transfers over RPC from a thread pool, UDP Geec txns at udp_rate a
# second; the seconds it may take to serve RPC at height 1, to mine
# every transfer, and to let the UDP txns commit; the trace's windows
NODE_CLUSTER = {"nodes": 3, "txn_per_block": 1000, "transfers": 1000,
                "senders": 100, "udp": 300, "udp_rate": 2000.0,
                "rpc_threads": 12, "seed": 16, "start_s": 90.0,
                "mine_s": 60.0, "settle_s": 2.0, "trace_windows": 2}
NODE_BUDGET_S = 150                 # phase node's whole time, twin included
MUL_SCALAR_BIG = 1 << 24            # #21's large case: 64 MiB of float32
# #21 and #20d against their library calls in one call: rounds in ABBA
# order, each round events over AB_F32_REPS calls and AB_F32_COLD cold ones
AB_F32_ORDER = ("kernel", "library", "library", "kernel", "kernel",
                "library")
AB_F32_REPS, AB_F32_COLD = 20, 5
# fp_mul_small launches of one un-fused batch by k: each doubling takes
# k = 2 three times, 3 and 8 once; each mixed add k = 2 four times and 4
# once, besides its doubling; 33 windows of 4 + 4, 14 table adds
MUL_SMALL_K = {2: 1418, 3: 278, 4: 146, 8: 278}
# the __global__ functions of a kernel, where they are not k_<name>; the
# pow and the ladder list the instances their wrapper launches
LANE_GLOBALS = {"pow_mod_p": "k_pow_p_t{}", "pow_mod_n": "k_pow_n_t{}",
                "strauss_tab": "k_strauss_t{}",
                "point_table": "k_point_table_t{}",
                "glv_digits": "k_glv_digits_t{}",
                "fp_mul": "k_fp_mul_t{}", "fp_canon": "k_fp_canon",
                "recover_finish": "k_recover_finish_t{}",
                "recover_prelude": "k_recover_prelude_t{}",
                "u1u2": "k_u1u2_t{}", "y_fix": "k_y_fix_t{}",
                "keccak_rows": "k_keccak_rows_t{}"}


def lanes_of(kernel: str) -> tuple[int, ...]:
    """The lanes a row of a lane kernel's instances."""
    from eges_tpu_torch.ops import kernels as K

    return KERNEL_LANES.get(kernel, K.LANES)


def launched_instances(kernel: str) -> tuple[str, ...]:
    """The instances of a lane kernel (``LANE_GLOBALS``) that
    ``lanes_for`` can pick."""
    from eges_tpu_torch.ops import kernels as K

    return tuple(sorted({LANE_GLOBALS[kernel].format(lanes)
                         for _, lanes, _ in K.LANES_RULE[kernel]}))


GLOBALS = {"pow_mod_rows8": ("k_pow_rows8_p", "k_pow_rows8_n"),
           "strauss_tab_rows8": ("k_strauss_rows8",),
           "keccak_rows_grid": ("k_keccak_round",)}
# launches of one classic-verify batch: on_curve (3 fp_mul, fp_add, 2
# fp_canon), s^-1 (pow), z and px mod N (2 fn_red17), u1 and u2 (2
# fn_mul), strauss_gR (glv_digits, point_table, pow, fp_canon, 5 fp_mul,
# strauss_tab) and the x half of to_affine (pow, 2 fp_mul, 2 fp_canon)
# launches of one fused recovery batch
FUSED_RECOVER_LAUNCHES = {"recover_prelude": 1, "pow_mod": 4, "y_fix": 1,
                          "u1u2": 1, "glv_digits": 1, "point_table": 1,
                          "fp_mul": 5, "fp_canon": 1, "strauss_tab": 1,
                          "recover_finish": 1, "keccak_rows": 1}
VERIFY_LAUNCHES = {"pow_mod": 3, "fp_mul": 10, "fp_canon": 5, "fp_add": 1,
                   "fn_red17": 2, "fn_mul": 2, "glv_digits": 1,
                   "point_table": 1, "strauss_tab": 1}
# the kernels of the verify and keccak paths that recovery does not run
# (#13-#16a)
VERIFY_OWN = ("keccak_block", "fn_mul", "fn_red17", "fp_add")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
# Integer peak, derived from the Hopper SM layout (no published figure):
# 132 SMs, each issuing at most 4 warp-instructions (128 lanes) a clock.
# 64 INT32 lanes a clock is no bound here: IMAD issues on the FMA pipe
# beside the INT32 pipe, and the pow kernel has run 1.47x faster than
# 64 lanes allow (PERF.md).
SMS, LANES_PER_CLOCK = 132, 128


STARTED = time.monotonic()


def emit(obj) -> None:
    """One JSON line on stdout; on stderr, the seconds since the start
    beside the line's phase (where the script's time goes)."""
    print(json.dumps(obj), flush=True)
    if isinstance(obj, dict) and "phase" in obj:
        print(f"chip_smoke: {time.monotonic() - STARTED:.1f} s "
              f"{obj['phase']} {obj.get('run', '')}".rstrip(),
              file=sys.stderr, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(nbytes: int, ops: float, clock_hz: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the u32 operations (``ops/opcount.py``) over the
    issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (SMS * LANES_PER_CLOCK * clock_hz)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def timed(fn):
    """One run of ``fn``: (result, ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(got, want) -> int:
    """The largest difference of the u32 words (float32 values: of their
    bit patterns, so 0 is bit for bit)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        d = ((g.to(torch.int64) & 0xFFFFFFFF)
             - (w.to(torch.int64) & 0xFFFFFFFF)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def ladder_args(dig, neg, rows, ladder_doublings=0.0):
    """The ladder's work on the first ``rows`` rows of ``dig [W, 8,
    Bpad]`` and ``neg [8, Bpad]``, as means a row: what the function
    needs (``opcount.per_row``'s doublings, adds and negations: from the
    row's first nonzero digit on, no add for a zero digit, no negation
    of its point) and what one lane issues (``opcount.per_lane``'s
    negations: every flagged add).  ``ladder_doublings`` is the mean
    number of adds a row that meet equal points."""
    W = dig.shape[0]
    live = (dig[:, :4, :rows] != 0).reshape(4 * W, rows)
    flag = neg[:4, :rows] != 0
    count = live.sum(0)
    first = torch.where(count > 0, live.int().argmax(0) // 4, W - 1)
    need = {"windows": W, "ladder_doublings": ladder_doublings,
            "doublings": float((4 * (W - 1 - first)).sum()) / rows,
            "adds": float((count - 1).clamp(min=0).sum()) / rows,
            "negations": float((live.reshape(W, 4, rows)
                                & flag).sum()) / rows}
    issued = {"windows": W, "ladder_doublings": ladder_doublings,
              "negations": W * float(flag.sum()) / rows}
    return need, issued


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """The kernels' build, and beside it the native host crypto library
    (``make -C native``: the sims' signing, hashing and native-verifier
    twins run on it, as the reference's do)."""
    from eges_tpu_torch.crypto import native
    from eges_tpu_torch.ops import build, kernels as K

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    make = subprocess.Popen(["make", "-C", os.path.join(root, "native")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        info = build.build()
    finally:
        log, _ = make.communicate()
    openmp = make.returncode == 0
    if not openmp:
        # a toolchain without libgomp: the same sources without OpenMP
        # (one pragma, the batch recovery's loop, then runs serially)
        log = subprocess.run(
            ["make", "-B", "-C", os.path.join(root, "native"),
             "CXXFLAGS=" + NATIVE_CXXFLAGS, "LDFLAGS=-shared"],
            capture_output=True, text=True).stdout
    native_s = time.monotonic() - t0
    if not native.available():
        raise AssertionError(f"native library build failed: {log[-2000:]}")
    native.self_check()
    K.library()
    launched = {g: info["ptxas"].get(g) for kernel in LANE_GLOBALS
                for g in launched_instances(kernel)}
    launched.update({g: info["ptxas"].get(g) for k in SHORT_LANE_KERNELS
                     for g in (LANE_GLOBALS[k].format(t)
                               for t in lanes_of(k))})
    emit({"phase": "build", "seconds": round(info["seconds"], 3),
          "native_seconds": round(native_s, 3), "native_openmp": openmp,
          "compiled": info["built"], "library": os.path.basename(
              info["path"]), "ptxas": info["ptxas"],
          "lane_kernels_launched": launched})
    dirty = {g: r for g, r in launched.items()
             if r is None or r["stack_bytes"] or r["spill_store_bytes"]
             or r["spill_load_bytes"]}
    if dirty:
        raise AssertionError(f"the lane instances the wrappers launch "
                             f"(and every prelude, u1u2, GLV, fp_mul, "
                             f"fp_canon and finish instance) must have no "
                             f"stack frame and no spill: {dirty}")
    return info


def phase_sass(path):
    """The op half of every bound counts no more than the card issues
    (``ops/opcount.py``): each kernel without a branch or a call issues
    at least its counted operations, and so does every loop of the
    F_P product chain (an ``fp_mul`` an iteration), of the F_P pow and
    of the point table (a mixed add an entry), in the ``sm_90a`` code of
    the built library (``cuobjdump -sass``).  The pow and the table run
    T lanes a row, so each instance's loops are held to a lane's share
    of an ``fp_sqr`` or of a ``jac_add_mixed``: its count over T,
    rounded down (at T = 1 the whole count).  The instances of the short
    lane kernels (``SHORT_LANE_KERNELS``) are held the same way on their
    shortest path from entry to exit (``build.least_path``): at least a
    lane's share of the row's count; keccak_rows' path with its one loop,
    the rounds, taken as many trips as ``KECCAK_ROUNDS`` need, and that
    loop to a lane's share of a trip's rounds.  What ``opcount.per_lane``
    counts for one lane is shown beside each.  Emits the counts, and the
    instruction mix of the chain's loop."""
    import collections

    from eges_tpu_torch.ops import build, kernels as K, opcount

    code = build.sass(path)
    OPS = opcount.per_row()
    straight = {fn[2:]: [OPS[fn[2:]], len(ins)] for fn, ins in code.items()
                if fn[2:] in OPS and build.straight_line(ins)}
    held = [("k_fp_mul_chain", "fp_mul", 1),
            ("k_fp_mul_chain_rows8", "fp_mul", 1)]
    held += [(f"k_pow_p_t{t}", "fp_sqr", t) for t in K.LANES]
    held += [(f"k_point_table_t{t}", "jac_add_mixed", t) for t in K.LANES]
    loops = {fn: (helper, opcount.ops(helper) // t,
                  [len(b) for b in build.loop_bodies(code[fn])])
             for fn, helper, t in held}
    # keccak_rows' one loop is its rounds, one a trip at T = 1 and
    # opcount.KECCAK_UNROLL beyond: each trip a lane's share of its rounds,
    # and the shortest path takes it as many times as the rounds need
    round_ops = opcount.KECCAK // KECCAK_ROUNDS
    trips = {}
    for t in lanes_of("keccak_rows"):
        fn = LANE_GLOBALS["keccak_rows"].format(t)
        per_trip = 1 if t == 1 else opcount.KECCAK_UNROLL
        trips[fn] = KECCAK_ROUNDS // per_trip
        loops[fn] = ("keccak round", per_trip * round_ops // t,
                     [len(b) for b in build.loop_bodies(code[fn])])

    def path_ops(k, fn):
        least = build.least_path(code[fn])
        if k != "keccak_rows":
            return least
        sizes = loops[fn][2]
        if len(sizes) != 1:
            raise AssertionError(f"{fn}: {len(sizes)} loops, want its round "
                                 "loop alone")
        return least + (trips[fn] - 1) * sizes[0]

    paths = {fn: [round(OPS[k]) // t, round(opcount.per_lane(t)[k]),
                  path_ops(k, fn)]
             for k in SHORT_LANE_KERNELS for t in lanes_of(k)
             for fn in [LANE_GLOBALS[k].format(t)]}
    bad = [n for n, (counted, issued) in straight.items() if counted > issued]
    bad += [fn for fn, (_, share, sizes) in loops.items()
            if not sizes or min(sizes) < share]
    bad += [fn for fn, (share, _, issued) in paths.items() if issued < share]
    body = build.loop_bodies(code["k_fp_mul_chain"])[0]
    mix = collections.Counter(build.opcode(i) for i in body)
    emit({"phase": "sass", "straight_line": straight,
          "loops": {fn: {"helper": h, "counted": share, "issued": sizes}
                    for fn, (h, share, sizes) in loops.items()},
          "least_paths": {fn: {"counted": c, "lane_ops": n, "issued": i}
                          for fn, (c, n, i) in paths.items()},
          "chain_loop_mix": dict(mix.most_common())})
    if len(straight) < 10 or bad:
        raise AssertionError(f"op counts above the issued instructions: "
                             f"{bad} (straight-line kernels: {straight})")


def _affine_points(rng, n):
    """n consecutive multiples of G from a random start: cheap real
    points for the table kernel."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.crypto import secp256k1 as host

    pt = host.point_mul(1 + tt.rand_int(rng, host.N - 1), host.G)
    xs, ys = [], []
    for _ in range(n):
        xs.append(pt[0])
        ys.append(pt[1])
        pt = host.point_add(pt, host.G)
    return tt.limb_rows(xs), tt.limb_rows(ys)


def phase_kernels(rng, dev, clock_hz, ptxas):
    """Each kernel at the main path's shapes against its plain version.
    Returns per-kernel records (ms and bounds cover all of a kernel's
    launches in one batch)."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.harness.profutil import cuda_event_ms
    from eges_tpu_torch.ops import kernels as K, opcount
    from eges_tpu_torch.ops.bigint import N, P

    B, M = B_MAIN, 16 * B_MAIN
    wide = K.bpad(B)

    def limbs(n, bound=1 << 256):
        return K.from_reference(tt.limb_rows(tt.field_values(rng, n, bound)),
                                dev)

    sig_s, sig_h, _ = tt.signed_rows(rng, 64)
    sigs = rng.integers(0, 256, (B, 65), dtype=np.uint8)
    sigs[:, 64] = rng.integers(0, 6, B)
    sigs[::2] = np.resize(sig_s, (B // 2, 65))
    hashes = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    hashes[::2] = np.resize(sig_h, (B // 2, 32))
    sigs_t, hashes_t = (torch.from_numpy(a).to(dev) for a in (sigs, hashes))

    a_b, b_b, c_b = limbs(B), limbs(B), limbs(B)
    n1, n2 = limbs(B, N), limbs(B, N)
    a_m, b_m = limbs(M), limbs(M)
    v = K.from_reference(rng.integers(0, 6, B).astype(np.uint32), dev)
    ok_in = K.from_reference(rng.integers(0, 2, B).astype(np.uint32), dev)
    px, py = (K.from_reference(t, dev) for t in _affine_points(rng, B))
    dig = torch.zeros(33, 8, wide, dtype=torch.int32, device=dev)
    dig[:, :4, :B] = torch.from_numpy(
        rng.integers(0, 16, (33, 4, B)).astype(np.int32)).to(dev)
    neg = torch.zeros(8, wide, dtype=torch.int32, device=dev)
    neg[:4, :B] = torch.from_numpy(
        rng.integers(0, 2, (4, B)).astype(np.int32)).to(dev)
    tabs = [K.from_reference(rng.integers(0, 1 << 16, (256, wide)).astype(
        np.uint32), dev) for _ in range(3)]
    words = K.from_reference(rng.integers(0, 1 << 32, (34, wide),
                                          dtype=np.uint64).astype(np.uint32),
                             dev)
    # the random R tables meet the accumulator (the doubling path) with
    # odds of 2^-256 an add, so this run's data takes no ladder doubling
    OPS = opcount.per_row(**ladder_args(dig, neg, B)[0])
    # the GLV split's edge scalars and fp_canon's values at and past P,
    # from a generator of their own (the others' inputs stay as they were)
    rng_e = np.random.default_rng(SEED + 11)
    g1 = K.from_reference(tt.limb_rows(tt.glv_scalars(rng_e, B)), dev)
    g2 = g1.flip(0).contiguous()
    c_m = K.from_reference(tt.limb_rows(tt.canon_values(rng_e, M)), dev)

    # (name, [(kernel call, plain call, bytes, ops)] one entry per launch
    # of one batch on the main path)
    def pw(a, e, mod):
        return (lambda: K.pow_mod_pallas(a, e, mod),
                lambda: K.pow_mod_plain(a, e, mod),
                2 * nbytes(a), a.shape[0] * opcount.pow_row(e, mod))

    cases = [
        ("recover_prelude", [(
            lambda: K.recover_prelude_pallas(sigs_t, hashes_t),
            lambda: K.recover_prelude_plain(sigs_t, hashes_t),
            nbytes(sigs_t, hashes_t) + 5 * 64 * B + 8 * B,
            B * OPS["recover_prelude"])]),
        ("pow_mod", [pw(a_b, (P + 1) // 4, "p"), pw(n1, N - 2, "n"),
                     pw(a_m, P - 2, "p"), pw(b_b, P - 2, "p")]),
        ("y_fix", [(lambda: K.y_fix_pallas(a_b, b_b, v),
                    lambda: K.y_fix_plain(a_b, b_b, v),
                    nbytes(a_b, b_b, v) + 64 * B + 4 * B,
                    B * OPS["y_fix"])]),
        ("u1u2", [(lambda: K.u1u2_pallas(c_b, n1, n2),
                   lambda: K.u1u2_plain(c_b, n1, n2),
                   nbytes(c_b, n1, n2) + 2 * 64 * B,
                   B * OPS["u1u2"])]),
        ("glv_digits", [(lambda: K.glv_digits_pallas(g1, g2),
                         lambda: K.glv_digits_plain(g1, g2),
                         nbytes(g1, g2) + 4 * (33 * 8 + 8) * wide,
                         wide * OPS["glv_digits"])]),
        ("point_table", [(lambda: K.point_table_pallas(px, py),
                          lambda: K.point_table_plain(px, py),
                          nbytes(px, py) + 3 * 14 * 64 * B,
                          B * OPS["point_table"])]),
        ("fp_mul", [(lambda: K.fp_mul_pallas(a_m, b_m),
                     lambda: K.fp_mul_plain(a_m, b_m),
                     3 * nbytes(a_m), M * OPS["fp_mul"])] * 5),
        ("fp_canon", [(lambda: K.fp_canon_pallas(c_m),
                       lambda: K.fp_canon_plain(c_m),
                       2 * nbytes(c_m), M * OPS["fp_canon"])]),
        ("strauss_tab", [(
            lambda: K.strauss_tab(dig, neg, *tabs, B),
            lambda: K.strauss_tab_plain(dig, neg, *tabs, B),
            nbytes(dig, neg, *tabs) + 3 * 64 * B,
            B * OPS["strauss_tab"])]),
        ("recover_finish", [(
            lambda: K.recover_finish_pallas(a_b, b_b, c_b, n1, ok_in),
            lambda: K.recover_finish_plain(a_b, b_b, c_b, n1, ok_in),
            nbytes(a_b, b_b, c_b, n1, ok_in) + 2 * 64 * B + 4 * B
            + 34 * 4 * wide, wide * OPS["recover_finish"])]),
        ("keccak_rows", [(lambda: K.keccak_rows_pallas(words),
                          lambda: K.keccak_rows_plain(words),
                          nbytes(words) + 8 * 4 * wide,
                          wide * OPS["keccak_rows"])]),
    ]
    cases += _verify_kernel_cases(dev, OPS)
    glue, ragged = _glue_kernel_cases(dev, OPS)
    cases += glue
    ragged["fp_mul"] = _fp_mul_views(dev)
    ragged["fp_canon"] = _fp_canon_views(dev)
    pre = tuple(torch.from_numpy(a).to(dev) for a in tt.prelude_rows(
        np.random.default_rng(SEED + 15), RAGGED))
    ragged["recover_prelude"] = [
        (lambda v=v: K.recover_prelude_pallas(v, pre[1]),
         lambda v=v: K.recover_prelude_plain(v, pre[1]))
        for v in (tt.pitched_rows(pre[0], pitch, off) for pitch, off in (
            (65, 0), (66, 0), (70, 0), (65, 1), (65, 4), (65, 8)))]
    ragged["u1u2"] = _u1u2_views(dev)
    ragged["y_fix"] = _y_fix_views(dev)
    kw = words[:, :RAGGED].contiguous()
    ragged["keccak_rows"] = [(lambda: K.keccak_rows_pallas(kw),
                              lambda: K.keccak_rows_plain(kw))]
    records = {}
    for name, launches in cases:
        # every kernel of the main path, and verify's and keccak's own,
        # also one call at a time on cold L2: back to back, a short launch
        # shows the wrapper's host pace
        extra = (_cold(launches) if name in FUSED_RECOVER_LAUNCHES
                 or name in VERIFY_OWN else None)
        if name == "fp_mul":
            # what streaming the same bytes takes, cold: ATen's a ^ b reads
            # both operands and writes one tensor of their size (not the
            # same function: a floor of the measurement, no library time)
            extra["stream_cold_ms"] = len(launches) * cuda_event_ms(
                lambda: a_m ^ b_m, reps=10, cold=True)
        elif name == "fp_canon":
            # the same for one operand: ATen's ~a reads it and writes a
            # tensor of its size
            extra["stream_cold_ms"] = len(launches) * cuda_event_ms(
                lambda: ~c_m, reps=10, cold=True)
        elif name == "recover_prelude":
            # ATen's zero pad of the 97 input bytes a row to the 328 the
            # prelude writes: the same bytes in and out
            sh = torch.cat([sigs_t, hashes_t], 1)
            extra["stream_cold_ms"] = cuda_event_ms(
                lambda: torch.nn.functional.pad(
                    sh, (0, 5 * 64 + 8 - sh.shape[1])), reps=10,
                cold=True)
        records[name] = _check_kernel(name, launches, ragged.get(name, ()),
                                      RAGGED, clock_hz, ptxas, "kernel",
                                      extra)
    return records


def _cold(launches):
    """``{"cold_ms": ...}``: the kernel calls of one batch's launches,
    each timed alone on cold L2 (a launch repeated on the main path is
    timed once)."""
    from eges_tpu_torch.harness.profutil import cuda_event_ms

    done = {}
    for kern, *_ in launches:
        if kern not in done:
            done[kern] = cuda_event_ms(kern, reps=10, cold=True)
    return {"cold_ms": sum(done[kern] for kern, *_ in launches)}


def _fp_mul_views(dev):
    """fp_mul's ragged checks, ``(kernel call, plain call)`` at ``RAGGED``
    rows: aligned operands, and views that start 4, 8 and 12 bytes past a
    16-byte boundary as either or both operands (the kernel's word path,
    no copy)."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(SEED + 10)
    n = RAGGED
    a, b = (K.from_reference(tt.limb_rows(tt.field_values(rng, n)), dev)
            for _ in range(2))

    def view(t, off):
        buf = torch.empty(16 * n + off, dtype=torch.int32, device=dev)
        v = buf[off:].view(n, 16)
        v.copy_(t)
        return v

    pairs = [(a, b)] + [(view(a, off), b) for off in (1, 2, 3)] + [
        (a, view(b, 1)), (view(a, 2), view(b, 3))]
    return [(lambda x=x, y=y: K.fp_mul_pallas(x, y),
             lambda x=x, y=y: K.fp_mul_plain(x, y)) for x, y in pairs]


def _u1u2_views(dev):
    """u1u2's ragged checks at ``RAGGED`` rows (r^-1 = 0 on some): aligned
    operands, and z, s or r^-1 as a view 4, 8 or 12 bytes past a 16-byte
    boundary (the kernel's word path, no copy)."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.ops.bigint import N

    rng = np.random.default_rng(SEED + 16)
    n = RAGGED
    ins = [K.from_reference(tt.limb_rows(tt.field_values(rng, n, bnd)), dev)
           for bnd in (1 << 256, N, N)]
    ins[2][::97] = 0
    sets = [tuple(ins)]
    for off in (1, 2, 3):
        buf = torch.empty(16 * n + off, dtype=torch.int32, device=dev)
        v = buf[off:].view(n, 16)
        v.copy_(ins[off - 1])
        sets.append(tuple(v if i == off - 1 else t
                          for i, t in enumerate(ins)))
    return [(lambda a=a: K.u1u2_pallas(*a), lambda a=a: K.u1u2_plain(*a))
            for a in sets]


def _y_fix_views(dev):
    """y_fix's ragged checks at ``RAGGED`` rows (roots that are P, y^2 the
    root's square on half the rows): aligned operands, and root or y^2 as
    a view 4, 8 or 12 bytes past a 16-byte boundary (the kernel's word
    path, no copy)."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.ops.bigint import P

    rng = np.random.default_rng(SEED + 17)
    n = RAGGED
    root, y_sq = (K.from_reference(tt.limb_rows(tt.field_values(rng, n)),
                                   dev) for _ in range(2))
    root[::9] = K.from_reference(tt.limb_rows([P]), dev)
    y_sq[::2] = K.fp_mul_plain(root, root)[::2]
    v = K.from_reference(rng.integers(0, 6, n).astype(np.uint32), dev)
    sets = [(root, y_sq)]
    for off, which in ((1, 0), (2, 1), (3, 0)):
        buf = torch.empty(16 * n + off, dtype=torch.int32, device=dev)
        view = buf[off:].view(n, 16)
        view.copy_((root, y_sq)[which])
        sets.append((view, y_sq) if which == 0 else (root, view))
    return [(lambda a=a: K.y_fix_pallas(*a, v),
             lambda a=a: K.y_fix_plain(*a, v)) for a in sets]


def _fp_canon_views(dev):
    """fp_canon's ragged checks at ``RAGGED`` rows of values at and past P:
    aligned, and views that start 4, 8 and 12 bytes past a 16-byte
    boundary (the kernel's word path, no copy)."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.ops import kernels as K

    a = K.from_reference(tt.limb_rows(tt.canon_values(
        np.random.default_rng(SEED + 12), RAGGED)), dev)
    views = [a]
    for off in (1, 2, 3):
        buf = torch.empty(16 * RAGGED + off, dtype=torch.int32, device=dev)
        views.append(buf[off:].view(RAGGED, 16))
        views[-1].copy_(a)
    return [(lambda v=v: K.fp_canon_pallas(v), lambda v=v: K.fp_canon_plain(v))
            for v in views]


def phase_lanes(dev, clock_hz, ptxas, rows4):
    """Every instance of the pow, the point table, the ladder and the
    short lane kernels (``SHORT_LANE_KERNELS``: the GLV split, fp_mul,
    fp_canon, the finish, the prelude, u1u2, y_fix and keccak_rows; T = 1,
    2, 4, 8 lanes a row in blocks of 64, 128 and 256 threads) at the main
    path's row counts: each held bit for bit against the plain version
    and timed by CUDA events back to back (``profutil.cuda_event_ms``)
    and cold, every instance once a round (``profutil.cold_event_ms``),
    beside its bound (the row's work,
    ``ops/opcount.py``), what one lane issues, its registers, stack frame
    and spills, and the instance ``lanes_for`` picks; the ladder on
    seeded inputs that take all its branches and on a recovery's own, the
    point table on seeded points and on the R of ``rows4``, the config-4
    block, padded as the facade pads it; the short kernels on seeded
    values with their edge cases (views off 16 bytes, RAGGED rows or
    columns at 4096), picked and held by their cold times.  Fails if an
    instance differs, if a time beats its bound, or if the picked instance
    is not faster than every T = 1 instance at the B-row shapes (the pow's
    table launches of 16 B rows, fp_mul and the finish: no more than 3%
    slower; the finish must not pick T = 1; ``NEAR_FASTEST``: within 3%
    of the fastest, ``ONE_LANE_OK`` may keep T = 1); a pick that these
    times put behind its rival is timed again against it alone, in
    ``CONFIRM_ROUNDS`` fresh rounds (a ``lanes_confirm`` line), and fails
    if it is behind there too.  Each pow shape also
    times the one-thread design with its table in local memory (the rows8
    twin #19a, on its own tiles), the pow's design before the lanes."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.harness.profutil import cold_event_ms, cuda_event_ms
    from eges_tpu_torch.ops import kernels as K, opcount
    from eges_tpu_torch.ops.bigint import N, P

    rng = np.random.default_rng(SEED + 7)
    B = B_MAIN
    wide = K.bpad(B)
    lad = [K.from_reference(t, dev) for t in tt.ladder_inputs(rng, B, wide)]
    dig, neg = lad[:2]
    kind = torch.arange(wide, device=dev) % 4
    want_lad = K.strauss_tab_plain(*lad, B)
    M = 16 * B
    vals = {"p": rng.integers(0, 1 << 16, (M, 16)).astype(np.uint32),
            "n": rng.integers(0, 1 << 16, (B, 16)).astype(np.uint32)}
    vals["n"][:, 15] &= 0x7FFF                     # below N
    exps = {"p": P - 2, "n": N - 2}
    pw = {m: K.from_reference(v, dev) for m, v in vals.items()}
    want_pow = {m: K.pow_mod_plain(pw[m], exps[m], m) for m in pw}
    real = _recovery_ladder_inputs(rng, B, dev)
    want_real = K.strauss_tab_plain(*real, B)
    tabs = {"seeded": tuple(K.from_reference(t, dev)
                            for t in _affine_points(rng, B)),
            "recovery": _recovery_r(rows4, dev)}
    want_tab = {d: K.point_table_plain(*r) for d, r in tabs.items()}
    mul = (pw["p"], K.from_reference(
        rng.integers(0, 1 << 16, (M, 16)).astype(np.uint32), dev))
    want_mul = K.fp_mul_plain(*mul)
    # a ragged view 4 bytes off: fp_mul's word path, each instance
    buf = torch.empty(16 * RAGGED + 1, dtype=torch.int32, device=dev)
    mis = buf[1:].view(RAGGED, 16)
    mis.copy_(mul[1][:RAGGED])
    want_mis = K.fp_mul_plain(mul[0][:RAGGED], mis)
    fin = [K.from_reference(tt.limb_rows(tt.field_values(rng, B)), dev)
           for _ in range(4)]
    fin[2][::97] = 0                     # Z = 0: the point at infinity
    fin.append(K.from_reference(rng.integers(0, 2, B).astype(np.uint32), dev))
    # the GLV split on the edge scalars and seeded ones (u2: u1 reversed);
    # fp_canon on values at and past P, and on a view 4 bytes off
    rng_e = np.random.default_rng(SEED + 13)
    glv = K.from_reference(tt.limb_rows(tt.glv_scalars(rng_e, B)), dev)
    glv = (glv, glv.flip(0).contiguous())
    canon = K.from_reference(tt.limb_rows(tt.canon_values(rng_e, M)), dev)
    want_canon = K.fp_canon_plain(canon)
    buf = torch.empty(16 * M + 1, dtype=torch.int32, device=dev)
    mis_c = buf[1:].view(M, 16)
    mis_c.copy_(canon)
    # the prelude on every class of its checks, also at a pitch of 66 and
    # 1 byte off; u1u2 on seeded values with r^-1 = 0 rows, also 4 bytes off
    pre = tuple(torch.from_numpy(a).to(dev)
                for a in tt.prelude_rows(np.random.default_rng(SEED + 14), B))
    pre_views = [(tt.pitched_rows(pre[0][:RAGGED], pitch, off),
                  pre[1][:RAGGED]) for pitch, off in ((66, 0), (65, 1))]
    uu = tuple(K.from_reference(tt.limb_rows(tt.field_values(rng_e, B, bnd)),
                                dev) for bnd in (1 << 256, N, N))
    uu[2][::97] = 0
    buf = torch.empty(16 * RAGGED + 1, dtype=torch.int32, device=dev)
    mis_u = buf[1:].view(RAGGED, 16)
    mis_u.copy_(uu[0][:RAGGED])
    want_mis_u = K.u1u2_plain(uu[0][:RAGGED], *(t[:RAGGED] for t in uu[1:]))
    # y_fix on roots that are P and y^2 that are the root's square beside
    # seeded ones, also 4 bytes off; keccak_rows on seeded blocks and blocks
    # of all zero and all one bits, also at RAGGED columns (no block's
    # multiple)
    yf = [K.from_reference(tt.limb_rows(tt.field_values(rng_e, B)), dev)
          for _ in range(2)]
    yf[0][::9] = K.from_reference(tt.limb_rows([P]), dev)
    yf[1][::2] = K.fp_mul_plain(yf[0], yf[0])[::2]
    yf.append(K.from_reference(rng_e.integers(0, 6, B).astype(np.uint32),
                               dev))
    buf = torch.empty(16 * RAGGED + 1, dtype=torch.int32, device=dev)
    mis_y = buf[1:].view(RAGGED, 16)
    mis_y.copy_(yf[0][:RAGGED])
    want_mis_y = K.y_fix_plain(yf[0][:RAGGED], yf[1][:RAGGED], yf[2][:RAGGED])
    kw = K.from_reference(rng_e.integers(0, 1 << 32, (34, B), dtype=np.uint64)
                          .astype(np.uint32), dev)
    kw[:, 0], kw[:, 1] = 0, -1
    kw_rag = kw[:, :RAGGED].contiguous()
    want_kw_rag = K.keccak_rows_plain(kw_rag)
    slow = []
    shapes = ([(k, r, "seeded") for k, r in LANE_SHAPES]
              + [("strauss_tab", r, "recovery") for r in LANE_RECOVERY_ROWS]
              + [("point_table", r, "recovery")
                 for r in TABLE_RECOVERY_ROWS])
    for kernel, rows, data in shapes:
        local = None
        also = ()       # (kernel call, plain result) held at every instance
        if kernel == "fp_mul":
            a, b = (t[:rows] for t in mul)
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = 3 * nbytes(a)
            want = want_mul[:rows]

            def call(lanes, threads, a=a, b=b):
                return K.fp_mul_lanes(a, b, lanes, threads)

            if rows == 4096:
                also = ((lambda lanes, threads: K.fp_mul_lanes(
                    mul[0][:RAGGED], mis, lanes, threads), want_mis),)
        elif kernel == "glv_digits":
            ins = tuple(t[:rows] for t in glv)
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = nbytes(*ins) + 4 * (33 * 8 + 8) * K.bpad(rows)
            want = K.glv_digits_plain(*ins)

            def call(lanes, threads, ins=ins):
                return K.glv_digits_lanes(*ins, lanes, threads)
        elif kernel == "fp_canon":
            a = canon[:rows]
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = 2 * nbytes(a)
            want = want_canon[:rows]

            def call(lanes, threads, a=a):
                return K.fp_canon_lanes(a, lanes, threads)

            if rows == M:
                also = ((lambda lanes, threads: K.fp_canon_lanes(
                    mis_c, lanes, threads), want_canon),)
        elif kernel == "recover_prelude":
            ins = tuple(t[:rows] for t in pre)
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = nbytes(*ins) + 5 * 64 * rows + 8 * rows
            want = K.recover_prelude_plain(*ins)

            def call(lanes, threads, ins=ins):
                return K.recover_prelude_lanes(*ins, lanes, threads)

            if rows == 4096:
                also = tuple(
                    (lambda lanes, threads, v=v, h=h: K.recover_prelude_lanes(
                        v, h, lanes, threads), K.recover_prelude_plain(v, h))
                    for v, h in pre_views)
        elif kernel == "u1u2":
            ins = tuple(t[:rows] for t in uu)
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = nbytes(*ins) + 2 * 64 * rows
            want = K.u1u2_plain(*ins)

            def call(lanes, threads, ins=ins):
                return K.u1u2_lanes(*ins, lanes, threads)

            if rows == 4096:
                also = ((lambda lanes, threads: K.u1u2_lanes(
                    mis_u, *(t[:RAGGED] for t in uu[1:]), lanes, threads),
                    want_mis_u),)
        elif kernel == "y_fix":
            ins = tuple(t[:rows] for t in yf)
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = nbytes(*ins) + 64 * rows + 4 * rows
            want = K.y_fix_plain(*ins)

            def call(lanes, threads, ins=ins):
                return K.y_fix_lanes(*ins, lanes, threads)

            if rows == 4096:
                also = ((lambda lanes, threads: K.y_fix_lanes(
                    mis_y, yf[1][:RAGGED], yf[2][:RAGGED], lanes, threads),
                    want_mis_y),)
        elif kernel == "keccak_rows":
            w = kw[:, :rows].contiguous()
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = nbytes(w) + 8 * 4 * rows
            want = K.keccak_rows_plain(w)

            def call(lanes, threads, w=w):
                return K.keccak_rows_lanes(w, lanes, threads)

            if rows == 4096:
                also = ((lambda lanes, threads: K.keccak_rows_lanes(
                    kw_rag, lanes, threads), want_kw_rag),)
        elif kernel == "recover_finish":
            ins = tuple(t[:rows] for t in fin)
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = (nbytes(*ins) + 2 * 64 * rows + 4 * rows
                  + 34 * 4 * K.bpad(rows))
            want = K.recover_finish_plain(*ins)

            def call(lanes, threads, ins=ins):
                return K.recover_finish_lanes(*ins, lanes, threads)
        elif kernel == "point_table":
            px, py = (t[:rows] for t in tabs[data])
            row_ops = opcount.per_row()[kernel]
            lane_args = {}
            nb = nbytes(px, py) + 3 * 14 * 64 * rows
            want = tuple(w[:, :rows] for w in want_tab[data])

            def call(lanes, threads, px=px, py=py):
                return K.point_table_lanes(px, py, lanes, threads)
        elif data == "recovery":
            row_args, lane_args = ladder_args(real[0], real[1], rows)
            row_ops = opcount.per_row(**row_args)[kernel]
            nb = nbytes(real[0][..., :rows], real[1][:, :rows],
                        *(t[:, :rows] for t in real[2:])) + 3 * 64 * rows
            want = tuple(w[:rows] for w in want_real)

            def call(lanes, threads, rows=rows):
                return K.strauss_tab_lanes(*real, rows, lanes, threads)
        elif kernel == "strauss_tab":
            # every row with b % 4 == 1 takes the doubling path once
            row_args, lane_args = ladder_args(
                dig, neg, rows, float((kind[:rows] == 1).sum()) / rows)
            row_ops = opcount.per_row(**row_args)[kernel]
            nb = nbytes(dig[..., :rows], neg[:, :rows],
                        *(t[:, :rows] for t in lad[2:])) + 3 * 64 * rows
            want = tuple(w[:rows] for w in want_lad)

            def call(lanes, threads, rows=rows):
                return K.strauss_tab_lanes(*lad, rows, lanes, threads)
        else:
            mod = kernel[-1]
            row_ops = opcount.pow_row(exps[mod], mod)
            lane_args = {}
            a = pw[mod][:rows]
            nb = 2 * nbytes(a)
            want = want_pow[mod][:rows]

            def call(lanes, threads, a=a, mod=mod):
                return K.pow_mod_lanes(a, exps[mod], mod, lanes, threads)

            # PR 6's design on the same rows: one thread a row, its table
            # in local memory (the rows8 twin #19a, timed on its tiles)
            at = K.to_rows8(K.pad_rows8(a)[0])

            def local(at=at, mod=mod, rows=rows):
                return K.pow_rows8_tiles(at, exps[mod], mod, rows)

            err = max_abs_err(K.from_rows8(local(), rows), want)
            if err:
                raise AssertionError(f"pow_mod_rows8 at {rows} rows differs "
                                     f"from the plain version ({err})")
        bound_ms, bound_by = bound(nb, rows * row_ops, clock_hz)
        local_ms = local and round(cuda_event_ms(local, reps=5), 5)
        if local_ms is not None and local_ms < bound_ms:
            raise AssertionError(f"pow_mod_rows8 at {rows} rows: {local_ms} "
                                 f"ms beats its bound of {bound_ms} ms")
        shapes = [(lanes, threads) for lanes in lanes_of(kernel)
                  for threads in K.LANE_THREADS]
        for lanes, threads in shapes:
            err = max([max_abs_err(call(lanes, threads), want)]
                      + [max_abs_err(c(lanes, threads), w) for c, w in also])
            if err:
                raise AssertionError(
                    f"{kernel} at {rows} rows, {lanes} lanes, {threads} "
                    f"threads: differs from the plain version (max abs "
                    f"err {err})")
        warm = [cuda_event_ms(call, *shape, reps=5) for shape in shapes]
        # cold: every instance once a round, the rounds' medians (more
        # rounds where cold times pick), so that a slow stretch of the
        # run moves every instance and not the one timed in it
        colds = cold_event_ms(
            [(call, shape) for shape in shapes],
            reps=9 if kernel in SHORT_LANE_KERNELS else 3)
        inst = []
        for (lanes, threads), ms, cold in zip(shapes, warm, colds):
            if min(ms, cold) < bound_ms:
                raise AssertionError(
                    f"{kernel} at {rows} rows: {min(ms, cold)} ms beats "
                    f"its bound of {bound_ms} ms")
            g = ptxas.get(LANE_GLOBALS[kernel].format(lanes)) or {}
            inst.append({"lanes": lanes, "threads": threads,
                         "ms": round(ms, 5), "cold_ms": round(cold, 5),
                         "lane_ops": round(opcount.per_lane(
                             lanes, **lane_args)[kernel]),
                         "regs": g.get("registers"),
                         "stack": g.get("stack_bytes"),
                         "spill": g.get("spill_store_bytes")})
        chosen = K.lanes_for(kernel, rows)
        key = "cold_ms" if kernel in SHORT_LANE_KERNELS else "ms"
        ms_of = {(i["lanes"], i["threads"]): i[key] for i in inst}
        t1 = min(v for (lanes, _), v in ms_of.items() if lanes == 1)
        best = min(ms_of, key=ms_of.get)
        line = {"phase": "lanes", "kernel": kernel, "rows": rows,
                "data": data, "picked_by": key,
                "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
                "row_ops": round(row_ops), "equal": True,
                "chosen": list(chosen), "chosen_ms": ms_of[chosen],
                "t1_ms": t1, "chosen_over_t1": round(ms_of[chosen] / t1, 4),
                "fastest": [*best, ms_of[best]], "local_table_ms": local_ms,
                "chosen_over_local": local_ms and round(ms_of[chosen]
                                                        / local_ms, 4),
                "instances": inst}
        emit(line)

        def behind(rival, limit, what):
            """Fails the pick if it is behind ``rival`` (its time over
            ``limit`` times the rival's, or equal to it at limit 1, as
            the pick itself is): on this phase's times, and then again
            on fresh head-to-head rounds of the two, so that the rival's
            time, the least of many, is not a lucky draw."""
            def lost(a, b):
                return a > limit * b or (limit == 1.0 and a == b)

            a, b = ms_of[chosen], ms_of[rival]
            if not lost(a, b):
                return
            if rival != chosen:
                a, b = _head_to_head(call, (chosen, rival),
                                     key == "cold_ms", cold_event_ms,
                                     cuda_event_ms)
                emit({"phase": "lanes_confirm", "kernel": kernel,
                      "rows": rows, "data": data, "against": what,
                      "chosen": list(chosen), "rival": list(rival),
                      "limit": limit,
                      "first_ms": [ms_of[chosen], ms_of[rival]],
                      "again_ms": [round(a, 5), round(b, 5)]})
                if not lost(a, b):
                    return
            slow.append(f"{kernel} at {rows} rows ({data}): lanes_for's "
                        f"{chosen} takes {ms_of[chosen]} ms, then {a:.5f}, "
                        f"against {what} {rival}'s {ms_of[rival]}, then "
                        f"{b:.5f}")

        if kernel in NEAR_FASTEST:
            behind(best, 1.03, "the fastest")
        if kernel in ONE_LANE_OK:
            continue
        if kernel == "recover_finish" and chosen[0] == 1:
            slow.append(f"{kernel} at {rows} rows: lanes_for picks T = 1")
        # fp_mul may keep one lane a row: its pick need only not lose
        limit = (1.03 if rows > B or kernel in ("fp_mul", "recover_finish")
                 else 1.0)
        behind(min((s for s in ms_of if s[0] == 1), key=ms_of.get), limit,
               "T = 1")
    if slow:
        raise AssertionError("; ".join(slow))


def _head_to_head(call, shapes, cold, cold_event_ms, cuda_event_ms):
    """Fresh times of ``call`` at each ``(lanes, threads)`` of ``shapes``,
    the shapes taken in turn over ``CONFIRM_ROUNDS`` rounds, the medians:
    cold (``profutil.cold_event_ms``) or, for the long kernels that phase
    lanes picks by their times back to back, five calls back to back a
    round (``profutil.cuda_event_ms``)."""
    if cold:
        return cold_event_ms([(call, s) for s in shapes],
                             reps=CONFIRM_ROUNDS)
    runs = [[cuda_event_ms(call, *s, reps=5) for s in shapes]
            for _ in range(CONFIRM_ROUNDS // 5)]
    return [statistics.median(r[i] for r in runs) for i in range(len(shapes))]


def _recovery_r(rows4, dev):
    """R as a fused recovery of the config-4 block hands it to the point
    table: ``rows4``'s signatures padded with zero-byte rows to the
    8192-row bucket (as the facade pads), through ``recover_prelude``
    (x), the square-root pow and ``y_fix`` (y)."""
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.ops.bigint import P

    sigs, hashes, _ = rows4
    s = np.zeros((B_MAIN, 65), np.uint8)
    h = np.zeros((B_MAIN, 32), np.uint8)
    s[:len(sigs)], h[:len(hashes)] = sigs, hashes
    x, y_sq, _, _, _, _, v = K.recover_prelude_pallas(
        *(torch.from_numpy(a).to(dev) for a in (s, h)))
    y, _ = K.y_fix_pallas(K.pow_mod_pallas(y_sq, (P + 1) // 4, "p"), y_sq, v)
    return x, y


def _recovery_ladder_inputs(rng, n, dev):
    """The ladder's inputs of a recovery of ``n`` rows (64 signed rows
    tiled): u1 = -z/r, u2 = s/r and R from the host model, then the R
    tables and the GLV digits as the fused path builds them
    (``ops.ec.strauss_inputs``)."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.ops import ec, kernels as K
    from eges_tpu_torch.ops.bigint import N, P

    sigs, hashes, _ = tt.signed_rows(rng, 64)
    u1, u2, xs, ys = [], [], [], []
    for sig, h in zip(sigs, hashes):
        r, s = (int.from_bytes(bytes(sig[i:i + 32]), "big") for i in (0, 32))
        v, z = int(sig[64]), int.from_bytes(bytes(h), "big")
        x = r + (N if v >= 2 else 0)
        y = pow((x ** 3 + 7) % P, (P + 1) // 4, P)
        y = y if (y & 1) == (v & 1) else P - y
        r_inv = pow(r, N - 2, N)
        u1.append(-z * r_inv % N)
        u2.append(s * r_inv % N)
        xs.append(x)
        ys.append(y)
    idx = np.resize(np.arange(len(u1)), n)
    return ec.strauss_inputs(*(K.from_reference(
        tt.limb_rows([vals[i] for i in idx]), dev) for vals in (u1, u2, xs, ys)))


def _check_kernel(name, launches, ragged, ragged_rows, clock_hz, ptxas,
                  phase, extra=None):
    """One kernel's launches of a batch, each ``(kernel call, plain
    call, bytes, ops)``: held bit for bit against the plain version and
    timed; then its ragged ``(kernel call, plain call)`` pairs.  Emits
    and returns the record (ms and bound cover all the launches), with
    ``extra`` keys; an extra ``cold_ms`` gets the share of the bound it
    reaches, and must not beat the bound either."""
    from eges_tpu_torch.harness.profutil import cuda_event_ms

    rec = {"name": name, **(extra or {}), "max_abs_err": 0, "ms": 0.0,
           "plain_ms": 0.0, "bytes": 0, "ops": 0.0,
           "launches_timed": len(launches)}
    done = {}  # a launch repeated on the main path (fp_mul x5) runs once
    for kern, plain, nb, ops in launches:
        if kern not in done:
            got = kern()
            want, pms = timed(plain)
            err = max_abs_err(got, want)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if err:
                raise AssertionError(f"{name}: kernel and plain version "
                                     f"differ (max abs err {err})")
            done[kern] = (cuda_event_ms(kern, reps=5), pms)
        ms, pms = done[kern]
        rec["ms"] += ms
        rec["plain_ms"] += pms
        rec["bytes"] += nb
        rec["ops"] += ops
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"],
                                             clock_hz)
    if rec["ms"] < rec["bound_ms"]:
        raise AssertionError(f"{name}: {rec['ms']} ms beats its bound of "
                             f"{rec['bound_ms']} ms: the bound is no floor")
    if "cold_ms" in rec:
        rec["cold_bound_share"] = rec["bound_ms"] / rec["cold_ms"]
        if rec["cold_ms"] < rec["bound_ms"]:
            raise AssertionError(f"{name}: cold {rec['cold_ms']} ms beats "
                                 f"its bound of {rec['bound_ms']} ms")
    for kern, plain in ragged:
        err = max_abs_err(kern(), plain())
        if err:
            raise AssertionError(f"{name}: kernel and plain version "
                                 f"differ at {ragged_rows} rows (max abs "
                                 f"err {err})")
        rec["ragged_rows_equal"] = ragged_rows
    if name == "pow_mod":
        names = (launched_instances("pow_mod_p")
                 + launched_instances("pow_mod_n"))
    elif name in LANE_GLOBALS:
        names = launched_instances(name)
    else:
        names = GLOBALS.get(name, ("k_" + name,))
    rec["ptxas"] = {g: ptxas.get(g) for g in names}
    emit({"phase": phase, **{k: (round(v, 6) if isinstance(v, float)
                                 else v) for k, v in rec.items()},
          "equal": True})
    return rec


def _verify_kernel_cases(dev, OPS):
    """The four kernels of the verify and keccak paths, each at its
    path's shape, with the launches of one batch: fn_mul, fn_red17 and
    fp_add at 1024 rows, keccak_block at 4000.  Inputs come from their
    own generator, so recovery's inputs stay as they were."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(SEED + 1)
    B = B_VERIFY

    def limbs(n):
        return K.from_reference(tt.limb_rows(tt.field_values(rng, n)), dev)

    a, b = limbs(B), limbs(B)
    b = b.flip(0).contiguous()           # the extremes meet each other
    # 17 small columns: random limbs with a nonzero top column, and the
    # extremes: all 0xFFFF, a zero top, one nonzero column only at the top
    cols = rng.integers(0, 1 << 16, (B, 17)).astype(np.uint32)
    cols[0], cols[1, :16], cols[2, 16], cols[3, :16] = 0xFFFF, 0xFFFF, 0, 0
    cols[3, 16] = 1
    c17 = K.from_reference(cols, dev)
    kw = rng.integers(0, 1 << 32, (B_KECCAK, 34), dtype=np.uint64).astype(
        np.uint32)
    kw[0], kw[1] = 0, 0xFFFFFFFF
    kwords = K.from_reference(kw, dev)
    mul = (lambda: K.fn_mul_pallas(a, b), lambda: K.fn_mul_plain(a, b),
           nbytes(a, b) + 64 * B, B * OPS["fn_mul"])
    red = (lambda: K.fn_red17_pallas(c17), lambda: K.fn_red17_plain(c17),
           nbytes(c17) + 64 * B, B * OPS["fn_red17"])
    return [
        ("fn_mul", [mul] * VERIFY_LAUNCHES["fn_mul"]),
        ("fn_red17", [red] * VERIFY_LAUNCHES["fn_red17"]),
        ("fp_add", [(lambda: K.fp_add_pallas(a, b),
                     lambda: K.fp_add_plain(a, b),
                     nbytes(a, b) + 64 * B, B * OPS["fp_add"])]),
        ("keccak_block", [(lambda: K.keccak_block_pallas(kwords),
                           lambda: K.keccak_block_plain(kwords),
                           nbytes(kwords) + 32 * B_KECCAK,
                           B_KECCAK * OPS["keccak_block"])]),
    ]


def _glue_kernel_cases(dev, OPS):
    """The six glue kernels of the un-fused path at its shapes for a
    ``STACK`` window, with the launches of one stacked recovery
    (``testing.UNFUSED_RECOVER_LAUNCHES``): the point formulas, y's
    negation and u1's at K*N rows, the GLV split of both scalars at
    2*K*N.  Returns (cases, {name: [(kernel call, plain call)] at
    ``RAGGED`` rows}).  Inputs come from their own generator."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.ops.bigint import N
    from eges_tpu_torch.ops.curve import _G_G1, _G_G2

    rng = np.random.default_rng(SEED + 5)
    KN = STACK[0] * STACK[1]
    pinned = tt.UNFUSED_RECOVER_LAUNCHES
    if sum(MUL_SMALL_K.values()) != pinned["fp_mul_small"]:
        raise AssertionError("MUL_SMALL_K does not add up to the pinned "
                             "fp_mul_small launches")

    def limbs(n, bound=1 << 256):
        return K.from_reference(tt.limb_rows(tt.field_values(rng, n, bound)),
                                dev)

    def sets(rows):
        """F_P operands (relaxed), mod-N operands (canonical), each
        pair's second operand reversed so the extremes meet others."""
        a, b = limbs(rows), limbs(rows).flip(0).contiguous()
        n1, n2 = limbs(rows, N), limbs(rows, N).flip(0).contiguous()
        return a, b, n1, n2

    def entry(kern, plain, args, nb, ops_row, rows):
        return (lambda: kern(*args), lambda: plain(*args), nb, rows * ops_row)

    def calls(a, b, n1, n2):
        """name -> [(kernel, plain, args)] of the six at these rows."""
        return {
            "fp_sub": [(K.fp_sub_pallas, K.fp_sub_plain, (a, b))],
            "fp_neg": [(K.fp_neg_pallas, K.fp_neg_plain, (a,))],
            "fp_mul_small": [(K.fp_mul_small_pallas, K.fp_mul_small_plain,
                              (a, k)) for k in MUL_SMALL_K],
            "fn_sub": [(K.fn_sub_pallas, K.fn_sub_plain, (n1, n2))],
            "fn_neg": [(K.fn_neg_pallas, K.fn_neg_plain, (n1,))],
            "mulhi8": [(K.mulhi8_pallas, K.mulhi8_plain, (n1, g))
                       for g in (_G_G1, _G_G2)],
        }

    one, two = calls(*sets(KN)), calls(*sets(2 * KN))
    row = 64  # bytes of one [16] u32 row
    cases = [
        ("fp_sub", [entry(*one["fp_sub"][0], 3 * row * KN, OPS["fp_sub"],
                          KN)] * pinned["fp_sub"]),
        ("fp_neg", [entry(*one["fp_neg"][0], 2 * row * KN, OPS["fp_neg"],
                          KN)] * pinned["fp_neg"]),
        ("fp_mul_small", [
            e for (kern, plain, args), n in zip(one["fp_mul_small"],
                                                MUL_SMALL_K.values())
            for e in [entry(kern, plain, args, 2 * row * KN,
                            OPS["fp_mul_small"], KN)] * n]),
        ("fn_sub", [entry(*two["fn_sub"][0], 3 * row * 2 * KN,
                          OPS["fn_sub"], 2 * KN)] * pinned["fn_sub"]),
        # u1 = -(z * r^-1) at K*N rows, the two sign splits at 2*K*N
        ("fn_neg", [entry(*one["fn_neg"][0], 2 * row * KN, OPS["fn_neg"],
                          KN),
                    *[entry(*two["fn_neg"][0], 2 * row * 2 * KN,
                            OPS["fn_neg"], 2 * KN)] * (pinned["fn_neg"] - 1)]),
        ("mulhi8", [entry(*c, (row + row // 2) * 2 * KN, OPS["mulhi8"],
                          2 * KN) for c in two["mulhi8"]]),
    ]
    ragged = {name: [(lambda k=k, a=args: k(*a), lambda p=p, a=args: p(*a))
                     for k, p, args in cs]
              for name, cs in calls(*sets(RAGGED)).items()}
    return cases, ragged


def _baseline4_rows(rng):
    """5024 rows: 256 distinct signed rows tiled, recovery ids 2 and 3,
    and every invalid class, each row with its host-model answer."""
    from eges_tpu_torch import testing as tt

    sigs, hashes, addrs = tt.signed_rows(rng, DISTINCT)
    hx_s, hx_h = tt.high_x_rows(rng, 8)
    bad_s, bad_h = [], []
    for i in range(4):  # every invalid class, built from four rows
        s, h = tt.invalid_rows(rng, sigs[i], hashes[i])
        bad_s.append(s)
        bad_h.append(h)
    uniq_s = np.concatenate([sigs, hx_s, *bad_s])
    uniq_h = np.concatenate([hashes, hx_h, *bad_h])
    answers = [tt.host_recover(s, h) for s, h in zip(uniq_s, uniq_h)]
    for i in range(DISTINCT):
        if answers[i] is None or answers[i][0] != addrs[i]:
            raise AssertionError(f"host model disagrees with itself, row {i}")
    idx = np.resize(np.arange(len(uniq_s)), ROWS_BASELINE4)
    rng.shuffle(idx)
    return uniq_s[idx], uniq_h[idx], [answers[i] for i in idx]


def phase_slice(rng):
    from eges_tpu_torch.crypto.verifier import BatchVerifier
    from eges_tpu_torch.ops import kernels as K

    sigs, hashes, answers = _baseline4_rows(rng)
    verifier = BatchVerifier()
    K.reset_launches()
    addrs, ok = verifier.recover_addresses(sigs, hashes)
    launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(FUSED_RECOVER_LAUNCHES)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    n_valid = n_invalid = 0
    for i, ans in enumerate(answers):
        if ans is None:
            if ok[i]:
                raise AssertionError(f"row {i}: invalid row accepted")
            n_invalid += 1
        else:
            if not ok[i] or bytes(addrs[i]) != ans[0]:
                raise AssertionError(f"row {i}: address differs from the "
                                     "host model")
            n_valid += 1
    c4 = _wide_and_int_rows(sigs, hashes)
    emit({"phase": "slice", "rows": len(sigs), "bucket": verifier._pad(
        len(sigs)), "valid_rows_matching_host": n_valid,
        "invalid_rows_rejected": n_invalid, "launches": launches,
        "launches_total": sum(launches.values()), "c4": c4,
        "c5_c6": _empty_and_int_bytes(sigs)})
    return launches, (sigs, hashes, answers), (addrs, ok)


def _wide_and_int_rows(sigs, hashes):
    """``ecrecover_batch`` on the rows as ``[N, 66]`` uint8 (a 0xAB byte
    after each) and as ``[N, 65]`` int32 rows and hashes: the same addrs,
    pubs and ok bytes as the ``[N, 65]`` uint8 rows."""
    from eges_tpu_torch.crypto.verifier import ecrecover_batch

    s, h = (torch.from_numpy(a).to("cuda") for a in (sigs, hashes))
    want = ecrecover_batch(s, h)
    pad = torch.full((len(sigs), 1), 0xAB, dtype=torch.uint8, device="cuda")
    cases = {"uint8_66": (torch.cat([s, pad], 1), h),
             "int32_65": (s.to(torch.int32), h.to(torch.int32))}
    for name, args in cases.items():
        got = ecrecover_batch(*args)
        for g, w, what in zip(got, want, ("addrs", "pubs", "ok")):
            if not torch.equal(g, w):
                raise AssertionError(f"ecrecover_batch on {name} rows: "
                                     f"{what} differ from [N, 65] uint8")
    return {"rows": len(sigs), "equal_to_uint8_65": sorted(cases)}


def _empty_and_int_bytes(sigs):
    """Faults C5 and C6 on the card: ``ecrecover_batch`` on ``[0, 65]``
    rows (uint8 and int32) and ``verify_batch`` on ``[0, 64]`` and
    ``[0, 65]`` ones give empty outputs on the card and launch nothing;
    ``keccak256_fixed`` on int32 and int64 byte rows (one block, two
    blocks, a stacked batch) and ``pubkey_to_address`` on int32 key
    halves (the config-4 rows' r and s) give the uint8 rows' digests,
    which the host model's keccak256 holds."""
    from eges_tpu_torch.crypto.keccak import keccak256
    from eges_tpu_torch.crypto.verifier import ecrecover_batch, verify_batch
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.ops.keccak import keccak256_fixed, pubkey_to_address

    dev = torch.device("cuda")
    K.reset_launches()
    shapes = {}
    for dt in (torch.uint8, torch.int32):
        got = ecrecover_batch(torch.zeros(0, 65, dtype=dt, device=dev),
                              torch.zeros(0, 32, dtype=dt, device=dev))
        shapes[f"recover_{dt}"] = [list(g.shape) for g in got]
        if ([tuple(g.shape) for g in got] != [(0, 20), (0, 64), (0,)]
                or any(g.device.type != "cuda" for g in got)):
            raise AssertionError(f"C5: recovery of no rows gave {got}")
    for w in (64, 65):
        ok = verify_batch(*(torch.zeros(0, n, dtype=torch.uint8, device=dev)
                            for n in (w, 32, 64)))
        shapes[f"verify_{w}"] = list(ok.shape)
        if ok.shape != (0,) or ok.dtype != torch.int32 or ok.is_cpu:
            raise AssertionError(f"C5: verify of no rows gave {ok}")
    if sum(K.LAUNCHES.values()):
        raise AssertionError(f"C5: empty batches launched {K.LAUNCHES}")
    rng = np.random.default_rng(SEED + 18)
    hashed = 0
    for shape in ((5, 40), (5, 64), (5, 137), (2, 3, 40)):
        msgs = rng.integers(0, 256, shape)
        want = keccak256_fixed(torch.from_numpy(msgs.astype(np.uint8)).to(
            dev)).cpu().numpy().reshape(-1, 32)
        for dt in (torch.int32, torch.int64):
            got = keccak256_fixed(torch.from_numpy(msgs).to(dt).to(dev))
            if not np.array_equal(got.cpu().numpy().reshape(-1, 32), want):
                raise AssertionError(f"C6: {dt} rows {shape} differ")
        for i, m in enumerate(msgs.reshape(-1, shape[-1])):
            if bytes(want[i]) != keccak256(bytes(m.astype(np.uint8))):
                raise AssertionError(f"C6: rows {shape} differ from the "
                                     "host model")
            hashed += 1
    keys = torch.from_numpy(sigs[:64, :64]).to(dev)
    want = pubkey_to_address(keys[:, :32], keys[:, 32:])
    got = pubkey_to_address(keys[:, :32].int(), keys[:, 32:].int())
    if not torch.equal(got, want):
        raise AssertionError("C6: int32 key halves give other addresses")
    return {"empty_shapes": shapes, "int_byte_rows_matching_host": hashed,
            "int_key_rows": len(keys)}


def _sm_clock(s8, h8):
    """The SM clock beside back-to-back 8192-row recoveries on device
    tensors: a child ``nvidia-smi`` samples the clock, the power draw and
    the throttle reasons every 20 ms while the card runs batches for
    ``CLOCK_SECONDS`` (batches are queued before it starts and after it
    stops, so every sample falls in the busy window)."""
    from eges_tpu_torch.crypto.verifier import ecrecover_batch

    s, h = (torch.from_numpy(a).to("cuda") for a in (s8, h8))

    def run(n):
        for _ in range(n):
            ecrecover_batch(s, h)

    query = "clocks.sm,power.draw,clocks_throttle_reasons.active"
    run(4)
    proc = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits",
         "-lms", "20"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    batches = 0
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < CLOCK_SECONDS:
            run(8)
            torch.cuda.synchronize()
            run(4)
            batches += 12
        seconds = time.perf_counter() - t0
    finally:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    torch.cuda.synchronize()
    rows = [[f.strip() for f in line.split(",")]
            for line in out.splitlines() if line.count(",") == 2]
    mhz, watts = ([float(r[k]) for r in rows
                   if r[k].replace(".", "").isdigit()] for k in (0, 1))
    if not mhz:
        raise AssertionError(f"nvidia-smi gave no clock samples: {err!r}")
    throttle = {}
    for r in rows:
        throttle[r[2]] = throttle.get(r[2], 0) + 1

    def spread(v):
        return v and {"min": min(v), "median": float(np.median(v)),
                      "max": max(v)}

    return {"query": query, "samples": len(mhz), "seconds": seconds,
            "batches_8192": batches, "sm_mhz": spread(mhz),
            "power_w": spread(watts), "throttle_reasons": throttle}


def phase_e2e(rows):
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    sigs, hashes, answers = rows
    verifier = BatchVerifier()
    s8 = np.ascontiguousarray(np.resize(sigs, (B_MAIN, 65)))
    h8 = np.ascontiguousarray(np.resize(hashes, (B_MAIN, 32)))
    verifier.recover_addresses(s8, h8)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(RUNS_8192):
        t0 = time.perf_counter()
        addrs, ok = verifier.recover_addresses(s8, h8)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    clock = _sm_clock(s8, h8)
    emit({"phase": "sm_clock", **clock})
    n_ok = int(ok.sum())
    want_ok = sum(answers[i % len(answers)] is not None
                  for i in range(B_MAIN))
    if n_ok != want_ok:
        raise AssertionError(f"8192-row run: {n_ok} ok, want {want_ok}")
    s1, h1 = s8[:1024].copy(), h8[:1024].copy()
    verifier.recover_addresses(s1, h1)                     # warm-up
    lat = []
    for _ in range(RUNS_1024):
        t0 = time.perf_counter()
        verifier.recover_addresses(s1, h1)
        lat.append(time.perf_counter() - t0)
    split = {rows: _lane_launches(s8[:rows], h8[:rows])
             for rows in (B_MAIN, 1024)}
    out = {"phase": "e2e", "rows": B_MAIN,
           # every row of the timed window over its whole time
           "verifies_per_s": RUNS_8192 * B_MAIN / sum(times),
           "batch_ms_8192_p50": float(np.median(times)) * 1e3,
           "batch_ms_8192_p90": float(np.percentile(times, 90)) * 1e3,
           "runs_8192": RUNS_8192,
           "p50_ms_1024": float(np.percentile(lat, 50)) * 1e3,
           "p99_ms_1024": float(np.percentile(lat, 99)) * 1e3,
           "runs_1024": RUNS_1024,
           "peak_device_bytes_8192": int(peak),
           # device ms of each pow launch of one recovery, in order (sqrt,
           # r^-1, the table's Z^-1, the final Z^-1), and of its ladder
           "pow_launch_ms_8192": split[B_MAIN]["pow"],
           "pow_launch_ms_1024": split[1024]["pow"],
           "ladder_ms_8192": split[B_MAIN]["ladder"],
           "ladder_ms_1024": split[1024]["ladder"]}
    emit(out)
    return out


def _pipelined(bv, wins):
    """The rows of ``wins`` through the split-phase trio with two windows
    in flight, as the scheduler's lane worker runs them: window k+1 is
    staged and committed before window k is collected."""
    outs, prev = [], None
    for s, h in wins:
        cur = bv.commit_recover(bv.stage_recover(s, h))
        if prev is not None:
            outs.append(bv.collect_recover(prev))
        prev = cur
    outs.append(bv.collect_recover(prev))
    return outs


def _trio_serial(bv, wins):
    """The rows of ``wins`` through the trio with one window in flight:
    the pipelined way's work (the same uploads, launches and two
    downloads), with no overlap."""
    return [bv.collect_recover(bv.commit_recover(bv.stage_recover(s, h)))
            for s, h in wins]


def _serial(bv, wins):
    return [bv.recover_addresses(s, h) for s, h in wins]


def _scheduled(sc, wins, close=False):
    """``wins`` through the scheduler ``sc``: every window submitted at
    once by ``submit_window``, one kick, every result waited for."""
    pend = [sc.submit_window(h, s) for s, h in wins]
    sc.kick()
    for w in pend:
        w.result(120)
    if close:
        sc.close()


def _armed_trace(bv, armed, sent, seed):
    """``devstats.DEFAULT.trace`` armed for ``armed`` windows, then
    ``sent`` windows of 256 random rows through a scheduler over ``bv``
    (all dispatched and recorded on its lane worker): the armer's
    status, the trace's bytes and the hand-written kernels it holds.
    The capture runs from the first armed window's dispatch to the last
    one's record, so it holds all their kernels, and some of the next
    window's, launched before the last armed one is collected."""
    import shutil

    from eges_tpu_torch.crypto.scheduler import VerifierScheduler
    from eges_tpu_torch.utils import devstats

    root = os.path.dirname(os.path.abspath(__file__))
    trace_dir = os.path.join(root, "build", "devstats_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    devstats.DEFAULT.trace.arm(armed, outdir=trace_dir)
    _scheduled(VerifierScheduler(bv, max_batch=256, window_ms=10_000.0),
               _random_windows(np.random.default_rng(SEED + seed), 256,
                               sent), close=True)
    st = devstats.DEFAULT.trace.status()
    path = os.path.join(st["path"] or "", "trace.json")
    out = {"state": st["state"],
           "bytes": os.path.getsize(path) if os.path.exists(path) else 0,
           "kernels": _trace_kernels(path) if os.path.exists(path) else 0}
    shutil.rmtree(trace_dir, ignore_errors=True)
    return out


def _trace_kernels(path):
    """The hand-written kernels (``k_*``) a Chrome trace holds."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel"
               and str(e.get("name", "")).startswith("k_"))


def _random_windows(rng, rows, count):
    """``count`` windows of ``rows`` distinct random rows (v in 0..1):
    no two alike, so no cache or dedup can serve one."""
    out = []
    for _ in range(count):
        s = rng.integers(0, 256, (rows, 65), dtype=np.uint8)
        s[:, 64] &= 1
        out.append((s, rng.integers(0, 256, (rows, 32), dtype=np.uint8)))
    return out


def _busy(fn):
    """``fn()`` once under the profiler (after a warm-up call): the card's
    busy share of the wall time (kernels' device time over wall, copies
    left out, as ``hlo_census`` counts it) and its idle share."""
    from eges_tpu_torch.harness.hlo_census import census
    from eges_tpu_torch.harness.profutil import profile_window

    events, wall = profile_window(fn)
    kernel_ms = census(events)["kernel_us"] / 1e3
    return {"wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / (wall * 1e3),
            "idle_share": 1.0 - kernel_ms / (wall * 1e3)}


def _commit_split(bv, s, h):
    """The host's time to enqueue one ``commit_recover`` against the time
    until its done event completes (p50 of ``SCHED_SPLIT_RUNS``, each
    window staged and its upload finished first), and the host waits
    that one profiled commit makes (CPU ops that block on the card)."""
    from torch.profiler import ProfilerActivity, profile

    enq, done = [], []
    for _ in range(SCHED_SPLIT_RUNS):
        st = bv.stage_recover(s, h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bv.commit_recover(st)
        t1 = time.perf_counter()
        st.done.synchronize()
        t2 = time.perf_counter()
        bv.collect_recover(st)
        enq.append(t1 - t0)
        done.append(t2 - t0)
    st = bv.stage_recover(s, h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bv.commit_recover(st)
    bv.collect_recover(st)
    waits = sorted({e.name for e in prof.events()
                    if e.name in HOST_WAIT_OPS})
    return {"enqueue_ms_p50": float(np.median(enq)) * 1e3,
            "done_ms_p50": float(np.median(done)) * 1e3,
            "host_waits_in_commit": waits}


def _sched_answers(sched, sigs, hashes):
    """The block from ``SCHED_THREADS`` submitter threads: even threads
    by ``recover_signers`` on their share of the rows, odd ones by
    ``submit_window`` in windows of ``SCHED_WINDOW`` rows.  Returns one
    answer a row (an address or None), in row order."""
    import threading

    n = len(sigs)
    out = [None] * n
    errs = []
    shares = np.array_split(np.arange(n), SCHED_THREADS)

    def worker(k, idx):
        try:
            if k % 2 == 0:
                got = sched.recover_signers(
                    [(bytes(hashes[i]), bytes(sigs[i])) for i in idx])
                for i, g in zip(idx, got):
                    out[i] = g
                return
            for lo in range(0, len(idx), SCHED_WINDOW):
                part = idx[lo:lo + SCHED_WINDOW]
                win = sched.submit_window(hashes[part], sigs[part])
                sched.kick()
                for i, g in zip(part, win.result(120)):
                    if isinstance(g, BaseException):
                        raise g
                    out[i] = g
        except BaseException as exc:
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(k, idx))
               for k, idx in enumerate(shares)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errs:
        raise AssertionError(f"a submitter failed: {errs[0]!r}")
    return out


def _device_error(bv, sigs, hashes):
    """A device error under a scheduler over ``bv`` (its fault hook
    raising at the head of ``stage_recover``): the window's rows must
    fail with it, none answered by the host model, the breaker closed.
    Returns the scheduler's error counts."""
    from eges_tpu_torch.crypto.scheduler import VerifierScheduler

    def lost(rows):
        raise RuntimeError(f"device lost ({rows} rows)")

    sc = VerifierScheduler(bv, max_batch=64, window_ms=10_000.0)
    bv.failure_hook = lost
    try:
        try:
            got = sc.recover_window(hashes, sigs)
        except RuntimeError as exc:
            if "device lost" not in str(exc):
                raise
        else:
            raise AssertionError(f"a device error was answered: {got!r}")
        st = sc.stats()
    finally:
        bv.failure_hook = None
        sc.close()
    out = {k: st[k] for k in ("device_errors", "breaker_trips",
                              "host_diverted", "breaker_diverted")}
    if out != {"device_errors": 1, "breaker_trips": 0, "host_diverted": 0,
               "breaker_diverted": 0}:
        raise AssertionError(f"a device error under the scheduler: {out}")
    return out


def _family_deltas(before, after):
    """The A2 families' count deltas between two registry snapshots."""
    def count(snap, name):
        v = snap.get(name, 0)
        return v["count"] if isinstance(v, dict) else v

    names = set(before) | set(after)
    return {name: count(after, name) - count(before, name)
            for name in sorted(names) if name.startswith(A2_FAMILIES)}


def _sched_block(bv, rows, slice_out):
    """The config-4 block through ``scheduler_for(bv)`` from
    ``SCHED_THREADS`` threads, every answer against the host model and
    the synchronous facade, then again from the cache with no device
    window; no hidden host path (no breaker trip, no divert but
    singletons, every other window pipelined); the A2 families against
    the windows; device memory and ``DeviceTraceArmer`` traces
    (``SCHED_TRACE``).  Returns the block's record and the launches of
    the scheduler's first pass."""
    from eges_tpu_torch.crypto.scheduler import scheduler_for
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.utils import devstats, tracing
    from eges_tpu_torch.utils.metrics import DEFAULT as metrics

    sigs, hashes, answers = rows
    sync_addrs, sync_ok = slice_out
    sched = scheduler_for(bv)
    snap0 = metrics.snapshot()
    t_run = time.monotonic()
    K.reset_launches()
    got = _sched_answers(sched, sigs, hashes)
    launches = dict(K.LAUNCHES)
    st = sched.stats()
    flights = sched.flights()
    snap1 = metrics.snapshot()
    for i, (g, ans) in enumerate(zip(got, answers)):
        want = None if ans is None else ans[0]
        sync = bytes(sync_addrs[i]) if sync_ok[i] else None
        if g != want or g != sync:
            raise AssertionError(f"row {i}: the scheduler's answer {g!r} "
                                 f"differs from the host model's {want!r} "
                                 f"or the facade's {sync!r}")
    # the same entries again: served from the cache, no device window
    K.reset_launches()
    again = _sched_answers(sched, sigs, hashes)
    st2 = sched.stats()
    if again != got or sum(K.LAUNCHES.values()) or \
            st2["batches"] != st["batches"]:
        raise AssertionError(f"second pass: {st2['batches'] - st['batches']}"
                             f" windows, launches {dict(K.LAUNCHES)}")
    sched.close()
    singletons = sum(1 for f in flights if f["rows"] == 1)
    device_windows = st["batches"]
    fallback = {k: st[k] for k in ("host_diverted", "breaker_diverted",
                                   "breaker_trips", "device_errors",
                                   "breaker_probes")}
    if any(fallback.values()) or st["breaker"] != "closed":
        raise AssertionError(f"the scheduler left the device: {fallback}")
    if st["pipeline_windows"] != device_windows or \
            sum(launches.values()) != 18 * device_windows:
        raise AssertionError(f"pipeline_windows {st['pipeline_windows']}, "
                             f"device windows {device_windows}, launches "
                             f"{sum(launches.values())}")
    fam = _family_deltas(snap0, snap1)
    bucket_rows = sum(f["bucket"] for f in flights)
    rows_dev = sum(f["rows"] for f in flights)
    want = {"verifier.batches": device_windows,
            "verifier.device": device_windows,
            "verifier.device_seconds": device_windows,
            "verifier.pad_waste": device_windows,
            "verifier.rows": rows_dev,
            "verifier.padded_rows": bucket_rows - rows_dev,
            "verifier.singleton_batches": singletons}
    bad = {k: (fam.get(k, 0), v) for k, v in want.items()
           if fam.get(k, 0) != v}
    hits = (fam.get("verifier.compile_cache_hits", 0)
            + fam.get("verifier.compile_cache_misses", 0))
    by_bucket = sum(v for k, v in fam.items()
                    if k.startswith("verifier.device_seconds;bucket="))
    if bad or hits != device_windows or by_bucket != device_windows:
        raise AssertionError(f"A2 families against {device_windows} "
                             f"windows: {bad}, cache {hits}, by bucket "
                             f"{by_bucket}")
    spans = [sp for sp in tracing.DEFAULT.finished()
             if sp["name"] == "verifier.batch" and sp["start_s"] >= t_run]
    if len(spans) != device_windows:
        raise AssertionError(f"{len(spans)} verifier.batch spans for "
                             f"{device_windows} device windows")
    fail = _device_error(bv, sigs[:8], hashes[:8])
    mem = devstats.sample_memory()
    armed, sent, seed = SCHED_TRACE
    trace = _armed_trace(bv, armed, sent, seed)
    if not mem or trace["state"] != "captured" or not trace["bytes"]:
        raise AssertionError(f"devstats: memory {mem}, trace {trace}")
    if not 18 * armed <= trace["kernels"] <= 18 * sent:
        raise AssertionError(f"a trace armed for {armed} windows holds "
                             f"{trace['kernels']} kernels")
    block = {"rows": len(sigs), "threads": SCHED_THREADS,
             "window_rows": SCHED_WINDOW, "rows_matching_host": len(got),
             "stats": {k: st[k] for k in (
                 "batches", "rows", "bucket_rows", "host_diverted",
                 "pipeline_windows", "pipeline_overlapped",
                 "pipeline_overlap_ratio", "cache_hits", "cache_misses",
                 "coalesced_rows", "window_submits", "flush_full",
                 "flush_kick", "flush_deadline", "breaker_diverted",
                 "device_errors")},
             "singleton_windows": singletons, "device_error": fail,
             "second_pass": {"batches": st2["batches"] - st["batches"],
                             "cache_hits": st2["cache_hits"]
                             - st["cache_hits"]},
             "a2_family_deltas": fam, "batch_spans": len(spans),
             "devstats": {"memory": mem,
                          "trace": {"armed": armed, "sent": sent, **trace},
                          "goodput": devstats.DEFAULT.stats()[
                              "goodput_ratio"]}}
    return block, launches


def _sched_overlap(bv, records):
    """Back-to-back windows of distinct rows through the trio with two in
    flight, through the trio with one, and through serial
    ``recover_addresses`` (ABBA rounds), each way's busy and idle share,
    the scheduler over the same windows, and commit's enqueue time
    against its done time."""
    from eges_tpu_torch.crypto.scheduler import VerifierScheduler
    from eges_tpu_torch.utils import devstats

    rng = np.random.default_rng(SEED + 30)
    runs = {rows: _random_windows(rng, rows, count)
            for rows, count in SCHED_OVERLAP}
    ways = {"pipelined": _pipelined, "trio_serial": _trio_serial,
            "serial": _serial}
    for rows, wins in runs.items():   # warm-up, and the ways agree
        s = _serial(bv, wins)
        for way in ("pipelined", "trio_serial"):
            for (pa, po), (sa, so) in zip(ways[way](bv, wins), s):
                if not (np.array_equal(pa, sa) and np.array_equal(po, so)):
                    raise AssertionError(f"{rows} rows: the trio ({way}) "
                                         "differs from recover_addresses")
    rates = {(w, r): [] for w in ways for r in runs}
    for way in SCHED_ROUNDS:
        for rows, wins in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ways[way](bv, wins)
            rates[(way, rows)].append(rows * len(wins)
                                      / (time.perf_counter() - t0))
    overlap = {}
    for rows, wins in runs.items():
        line = {}
        for way in ways:
            v = rates[(way, rows)]
            line[way] = {"verifies_per_s": float(np.median(v)),
                         "rounds": v, **_busy(lambda: ways[way](bv, wins))}
        # the same work with and without overlap, and the trio's work
        # against recover_addresses' (which also downloads pubs, through
        # pageable copies)
        rate = {w: line[w]["verifies_per_s"] for w in ways}
        line["pipelined_over_trio_serial"] = (rate["pipelined"]
                                              / rate["trio_serial"])
        line["trio_serial_over_serial"] = rate["trio_serial"] / rate["serial"]
        # the scheduler over the same windows: all submitted at once, its
        # lane worker pipelining them (a fresh scheduler each run, so no
        # row is served from its cache)
        sc = VerifierScheduler(bv, max_batch=rows, window_ms=10_000.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _scheduled(sc, wins)
        dt = time.perf_counter() - t0
        sst = sc.stats()
        sc.close()
        busy = _busy(lambda: _scheduled(VerifierScheduler(
            bv, max_batch=rows, window_ms=10_000.0), wins, close=True))
        line["scheduler"] = {
            "verifies_per_s": rows * len(wins) / dt,
            "windows": sst["pipeline_windows"],
            "pipeline_overlap_ratio": sst["pipeline_overlap_ratio"],
            **busy}
        overlap[rows] = line
    split = _commit_split(bv, *runs[1024][0])
    if split["enqueue_ms_p50"] > SCHED_ENQUEUE_SHARE * split["done_ms_p50"]:
        raise AssertionError(
            f"commit_recover enqueues in {split['enqueue_ms_p50']:.3f} ms of "
            f"the {split['done_ms_p50']:.3f} ms until done: host waits "
            f"{split['host_waits_in_commit']} hide the overlap")
    # the roofline of devstats from this run's kernel bounds at 8192 rows
    bound_8192 = sum(records[k]["bound_ms"] for k in FUSED_RECOVER_LAUNCHES)
    roof = devstats.set_roofline(
        devstats.roofline_from_bounds({B_MAIN: bound_8192}),
        "chip_smoke.py phase kernel bounds, 8192 rows")
    return {"overlap": {str(k): v for k, v in overlap.items()},
            "rounds": list(SCHED_ROUNDS), "commit_split_1024": split,
            "roofline_rows_per_s": roof["ceilings"],
            "fraction_of_roofline_8192": overlap[B_MAIN]["pipelined"][
                "verifies_per_s"] / roof["ceilings"][B_MAIN]}


def phase_sched(rows, slice_out, records, card):
    """The config-4 block through ``scheduler_for(BatchVerifier())`` from
    ``SCHED_THREADS`` threads, every answer against the host model and
    the synchronous facade, then again from the cache; no hidden host
    path; the A2 families against the windows; device stats.  Then the
    overlap (``_sched_overlap``).  Returns the launches of the
    scheduler's run."""
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    bv = BatchVerifier()
    block, launches = _sched_block(bv, rows, slice_out)
    out = {"phase": "sched", "card": card, **block,
           **_sched_overlap(bv, records),
           "launches": {k: v for k, v in launches.items() if v}}
    emit(out)
    return launches


def _lane_launches(sigs, hashes) -> dict:
    """One fused recovery of these rows on device tensors under the
    profiler: the device ms of its pow launches and of its ladder, in
    the order they ran.  The profiler has dropped the first kernel of a
    window (a traced recovery lacked its first pow launch, which the
    wrappers' launch counts had): a window short of a launch is traced
    again, up to PROFILE_TRIES windows in all."""
    from eges_tpu_torch.crypto.verifier import ecrecover_batch
    from eges_tpu_torch.harness.profutil import profile_window

    s = torch.from_numpy(np.ascontiguousarray(sigs)).to("cuda")
    h = torch.from_numpy(np.ascontiguousarray(hashes)).to("cuda")
    for _ in range(PROFILE_TRIES):
        events, _ = profile_window(ecrecover_batch, s, h)
        split = {"pow": [us / 1e3 for n, us in events
                         if n.startswith("k_pow_")],
                 "ladder": [us / 1e3 for n, us in events
                            if n.startswith("k_strauss_")]}
        if len(split["pow"]) == 4 and len(split["ladder"]) == 1:
            return split
    raise AssertionError(f"a recovery ran {split}: want 4 pow launches and "
                         "one ladder")


def _committee_rows():
    """A BASELINE config-3 vote round: 256 rows, every class of
    ``testing.VERIFY_CLASSES`` once among valid committee votes,
    shuffled, with the host model's answer for each row."""
    from eges_tpu_torch import testing as tt

    rng = np.random.default_rng(SEED + 2)
    n_other = len(tt.VERIFY_CLASSES) - 1
    sigs, hashes, pubs, kinds = tt.verify_rows(rng, COMMITTEE - n_other)
    answers = [tt.host_verify(*row) for row in zip(sigs, hashes, pubs)]
    for kind, ans in zip(kinds, answers):
        if ans != (kind in tt.VERIFY_VALID):
            raise AssertionError(f"host model: class {kind} gave {ans}")
    idx = rng.permutation(len(sigs))
    return (sigs[idx], hashes[idx], pubs[idx], [kinds[i] for i in idx],
            [answers[i] for i in idx])


def _tiled(rows, n, seed):
    """``n`` rows drawn from the distinct rows (each about n/256 times),
    shuffled."""
    idx = np.random.default_rng(seed).permutation(
        np.resize(np.arange(len(rows[0])), n))
    return tuple(r[idx] if isinstance(r, np.ndarray) else [r[i] for i in idx]
                 for r in rows)


def phase_verify():
    """Config-3 and config-4 rounds through ``BatchVerifier().verify``;
    returns (launches of the config-4 batch, the two row sets)."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.crypto.verifier import BatchVerifier
    from eges_tpu_torch.ops import kernels as K

    r3 = _committee_rows()
    r4 = _tiled(r3, B_VERIFY, SEED + 3)
    verifier = BatchVerifier()
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(VERIFY_LAUNCHES)
    out = {"phase": "verify_slice"}
    launches = None
    for cfg, (sigs, hashes, pubs, kinds, answers) in (("config3", r3),
                                                       ("config4", r4)):
        K.reset_launches()
        ok = verifier.verify(sigs, hashes, pubs)
        launches = dict(K.LAUNCHES)
        if launches != want:
            raise AssertionError(f"{cfg}: launch counts {launches}, want "
                                 f"{want}")
        by_class = {}
        for i, (kind, ans) in enumerate(zip(kinds, answers)):
            if bool(ok[i]) != ans:
                raise AssertionError(f"{cfg} row {i} ({kind}): card says "
                                     f"{bool(ok[i])}, host model {ans}")
            by_class[kind] = by_class.get(kind, 0) + 1
        ok64 = verifier.verify(np.ascontiguousarray(sigs[:, :64]), hashes,
                               pubs)
        if not np.array_equal(ok64, ok):
            raise AssertionError(f"{cfg}: 64-byte signatures differ")
        out[cfg] = {"rows": len(sigs), "bucket": verifier._pad(len(sigs)),
                    "accepted": int(ok.sum()), "rows_by_class": by_class,
                    "rows_matching_host": len(sigs),
                    "sig64_matching": True}
    assert set(out["config3"]["rows_by_class"]) == set(tt.VERIFY_CLASSES)
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["launches_total"] = sum(launches.values())
    emit(out)
    return launches, r3, r4


def phase_keccak(dev):
    """The keccak path: one-block transaction hashes, address
    derivation and two-block messages, against the host keccak256."""
    from eges_tpu_torch.crypto.keccak import keccak256
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.ops.keccak import keccak256_fixed, pubkey_to_address

    rng = np.random.default_rng(SEED + 4)
    txs = rng.integers(0, 256, (B_KECCAK, 110), dtype=np.uint8)
    keys = rng.integers(0, 256, (B_MAIN, 64), dtype=np.uint8)
    two = rng.integers(0, 256, (B_VERIFY, 200), dtype=np.uint8)
    K.reset_launches()
    d_tx = keccak256_fixed(torch.from_numpy(txs).to(dev))
    k = torch.from_numpy(keys).to(dev)
    d_addr = pubkey_to_address(k[:, :32], k[:, 32:])
    d_two = keccak256_fixed(torch.from_numpy(two).to(dev))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.KERNELS, 0)
    want["keccak_block"] = 2
    if launches != want:
        raise AssertionError(f"keccak launch counts {launches}, want {want}")
    out = {"phase": "keccak_slice"}
    for what, msgs, got, cut in (("tx110", txs, d_tx, 0),
                                 ("address", keys, d_addr, 12),
                                 ("two_block200", two, d_two, 0)):
        got = got.cpu().numpy()
        for i in range(len(msgs)):
            if bytes(got[i]) != keccak256(bytes(msgs[i]))[cut:]:
                raise AssertionError(f"keccak {what} row {i} differs from "
                                     "the host model")
        out[what] = {"rows": len(msgs), "matching_host": len(msgs)}
    out["launches"] = {k: v for k, v in launches.items() if v}
    emit(out)
    return launches


def phase_verify_e2e(r3, r4, dev):
    from eges_tpu_torch.crypto.verifier import (BatchVerifier,
                                                ecrecover_batch, verify_batch)

    verifier = BatchVerifier()
    out = {"phase": "verify_e2e", "runs": RUNS_VERIFY}
    for rows, (sigs, hashes, pubs, _, answers) in ((B_VERIFY, r4),
                                                   (COMMITTEE, r3)):
        want = np.array(answers)
        verifier.verify(sigs, hashes, pubs)                # warm-up
        lat = []
        for _ in range(RUNS_VERIFY):
            t0 = time.perf_counter()
            ok = verifier.verify(sigs, hashes, pubs)
            lat.append(time.perf_counter() - t0)
        if not np.array_equal(ok, want):
            raise AssertionError(f"verify e2e at {rows} rows: wrong result")
        out[f"p50_ms_{rows}"] = float(np.percentile(lat, 50)) * 1e3
        out[f"p99_ms_{rows}"] = float(np.percentile(lat, 99)) * 1e3
        if rows == B_VERIFY:
            # every row of the timed window over its whole time
            out["verifies_per_s_1024"] = RUNS_VERIFY * rows / sum(lat)
    # where a 1024-row batch waits: the host's time to enqueue it (the
    # call returns before the card finishes) against the time until the
    # card is done, for verify and, beside it, recovery on the same rows
    sigs, hashes, pubs = (torch.from_numpy(a).to(dev) for a in r4[:3])
    for key, fn, args in (("verify", verify_batch, (sigs, hashes, pubs)),
                          ("recover", ecrecover_batch, (sigs, hashes))):
        enq, done = _split_times(lambda: fn(*args), RUNS_SPLIT)
        out[f"{key}_enqueue_ms_p50_1024"] = enq
        out[f"{key}_done_ms_p50_1024"] = done
    out["runs_split"] = RUNS_SPLIT
    emit(out)
    return out


def _split_times(fn, runs: int):
    """``runs`` calls of ``fn`` after a warm-up, each from an idle card:
    (p50 ms of the host's enqueue, p50 ms until the card is done)."""
    fn()
    enq, done = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append(t1 - t0)
        done.append(time.perf_counter() - t0)
    return float(np.median(enq)) * 1e3, float(np.median(done)) * 1e3


def phase_stacked(rows, r4, dev):
    """The un-fused path on stacked windows: ``STACK`` rows of phase 3's
    config-4 block through ``ecrecover_batch`` and ``STACK_VERIFY`` rows
    of config-3 votes through ``verify_batch``, each held against the
    fused path on the same rows flattened and against the host model,
    with the launches of one batch.  Returns the launches of each."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.crypto.verifier import ecrecover_batch, verify_batch
    from eges_tpu_torch.ops import kernels as K

    out = {"phase": "stacked", "runs": RUNS_STACKED}
    paths = {}

    def run(what, fn, args, pinned):
        K.reset_launches()
        got = fn(*args)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        want = dict.fromkeys(K.KERNELS, 0)
        want.update(pinned)
        if launches != want:
            raise AssertionError(f"stacked {what}: launch counts {launches}, "
                                 f"want {want}")
        paths[what] = launches
        return got

    # recovery: the first K*N rows of the config-4 block
    sigs, hashes, answers = rows
    n = STACK[0] * STACK[1]
    sigs, hashes, answers = sigs[:n], hashes[:n], answers[:n]
    n_invalid = sum(a is None for a in answers)
    high_ids = {int(sigs[i, 64]) for i, a in enumerate(answers)
                if a is not None and sigs[i, 64] >= 2}
    if n_invalid < 5 or high_ids != {2, 3}:
        raise AssertionError("the stacked window lacks a row class")
    s_dev = torch.from_numpy(sigs).to(dev)
    h_dev = torch.from_numpy(hashes).to(dev)
    args = (s_dev.reshape(*STACK, 65), h_dev.reshape(*STACK, 32))
    got = run("recover", ecrecover_batch, args, tt.UNFUSED_RECOVER_LAUNCHES)
    fused = ecrecover_batch(s_dev, h_dev)
    for g, f, what in zip(got, fused, ("addrs", "pubs", "ok")):
        if not torch.equal(g.reshape(n, *g.shape[2:]), f):
            raise AssertionError(f"stacked recovery: {what} differ from the "
                                 "fused path")
    addrs, pubs, ok = (t.reshape(n, -1).cpu().numpy() for t in got)
    for i, ans in enumerate(answers):
        if ans is None:
            if ok[i, 0] or addrs[i].any() or pubs[i].any():
                raise AssertionError(f"stacked row {i}: invalid row accepted")
        elif not ok[i, 0] or (bytes(addrs[i]), bytes(pubs[i])) != ans:
            raise AssertionError(f"stacked row {i}: differs from the host "
                                 "model")
    enq, done = _split_times(lambda: ecrecover_batch(*args), RUNS_STACKED)
    out["recover"] = {"shape": list(STACK), "rows_matching_fused": n,
                      "rows_matching_host": n,
                      "valid": int(ok[:, 0].sum()), "invalid": n_invalid,
                      "launches_total": sum(paths["recover"].values()),
                      "enqueue_ms_p50": enq, "done_ms_p50": done}

    # verify: the 1024 tiled config-3 rows as a [4, 256] window
    sigs, hashes, pubs, kinds, answers = r4
    n = STACK_VERIFY[0] * STACK_VERIFY[1]
    if set(kinds[:n]) != set(tt.VERIFY_CLASSES):
        raise AssertionError("the stacked verify window lacks a row class")
    flat = [torch.from_numpy(a[:n]).to(dev) for a in (sigs, hashes, pubs)]
    args = [t.reshape(*STACK_VERIFY, -1) for t in flat]
    got = run("verify", verify_batch, args, tt.UNFUSED_VERIFY_LAUNCHES)
    if not torch.equal(got.reshape(n), verify_batch(*flat)):
        raise AssertionError("stacked verify differs from the fused path")
    ok = got.reshape(n).cpu().numpy()
    if [bool(v) for v in ok] != list(answers[:n]):
        raise AssertionError("stacked verify differs from the host model")
    enq, done = _split_times(lambda: verify_batch(*args), RUNS_STACKED)
    out["verify"] = {"shape": list(STACK_VERIFY), "rows_matching_fused": n,
                     "rows_matching_host": n, "accepted": int(ok.sum()),
                     "launches_total": sum(paths["verify"].values()),
                     "enqueue_ms_p50": enq, "done_ms_p50": done}
    out["launches"] = {p: {k: v for k, v in l.items() if v}
                       for p, l in paths.items()}
    emit(out)
    return paths


def _config(tiling: bool, fn):
    """``fn`` run under the tiling configuration or the default one."""
    from eges_tpu_torch import testing as tt

    def run():
        with tt.tiling_config(tiling):
            return fn()
    return run


def phase_tiling_kernels(dev, clock_hz, ptxas):
    """The three kernels of ``tiling.cu`` at the tiling path's shapes,
    each against its plain version on the same tiles (``_check_kernel``)
    and, on the same values, its default-layout twin and the
    reference-contract wrapper (re-lay included).  Inputs come from
    their own generator.  Returns the records."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.harness.profutil import cuda_event_ms
    from eges_tpu_torch.ops import kernels as K, opcount
    from eges_tpu_torch.ops.bigint import N, P

    rng = np.random.default_rng(SEED + 6)
    B, M = B_MAIN, 16 * B_MAIN

    def limbs(n, bound=1 << 256):
        return K.from_reference(tt.limb_rows(tt.field_values(rng, n, bound)),
                                dev)

    a_b, b_b, n1, a_m = limbs(B), limbs(B), limbs(B, N), limbs(M)
    dig = torch.from_numpy(rng.integers(0, 16, (33, 8, B)).astype(
        np.int32)).to(dev)
    dig[:, 4:] = 0
    neg = torch.zeros(8, B, dtype=torch.int32, device=dev)
    neg[:4] = torch.from_numpy(rng.integers(0, 2, (4, B)).astype(
        np.int32)).to(dev)
    tabs = [K.from_reference(rng.integers(0, 1 << 16, (256, B)).astype(
        np.uint32), dev) for _ in range(3)]
    words = K.from_reference(rng.integers(0, 1 << 32, (34, B),
                                          dtype=np.uint64).astype(np.uint32),
                             dev)
    OPS = opcount.per_row(**ladder_args(dig, neg, B)[0])

    def pw(a, e, mod):
        """(kernel, plain, bytes, ops), (twin, path) of one pow launch."""
        at = K.to_rows8(a)
        rows = a.shape[0]
        return ((lambda: K.pow_rows8_tiles(at, e, mod, rows),
                 lambda: K.pow_mod_rows8_plain(at, e, mod, rows),
                 2 * nbytes(at), rows * opcount.pow_row(e, mod)),
                (_config(False, lambda: K.pow_mod_pallas(a, e, mod)),
                 lambda: K.pow_mod_rows8(a, e, mod)))

    pows = [pw(a_b, (P + 1) // 4, "p"), pw(n1, N - 2, "n"),
            pw(a_m, P - 2, "p"), pw(b_b, P - 2, "p")]
    laid = (K.lay_digits_rows8(dig), K.lay_rows8(neg),
            *(K.lay_rows8(t) for t in tabs))
    ladder = ((lambda: K.strauss_rows8_tiles(*laid, B),
               lambda: K.strauss_tab_rows8_plain(*laid, B),
               nbytes(*laid) + 3 * 64 * B, B * OPS["strauss_tab_rows8"]),
              (_config(False, lambda: K.strauss_tab(dig, neg, *tabs, B)),
               lambda: K.strauss_tab_rows8(dig, neg, *tabs, B)))
    keccak = ((lambda: K.keccak_rows_grid(words),
               lambda: K.keccak_rows_grid_plain(words),
               nbytes(words) + 50 * 4 * B, B * OPS["keccak_rows_grid"]),
              (_config(False, lambda: K.keccak_rows_pallas(words)),
               _config(True, lambda: K.keccak_rows_pallas(words))))

    # ragged counts: 1030 pow rows (p and n), a 1000-row ladder of two
    # windows in one tile, 4097 keccak columns
    ragged = {}
    for mod, bound_ in (("p", 1 << 256), ("n", N)):
        at = K.to_rows8(K.pad_rows8(limbs(RAGGED_POW8, bound_))[0])
        e = P - 2 if mod == "p" else N - 2
        ragged.setdefault("pow_mod_rows8", []).append(
            (lambda at=at, e=e, m=mod: K.pow_rows8_tiles(at, e, m,
                                                          RAGGED_POW8),
             lambda at=at, e=e, m=mod: K.pow_mod_rows8_plain(at, e, m,
                                                             RAGGED_POW8)))
    rows_l, windows = RAGGED_LADDER
    rl = (K.lay_digits_rows8(dig[:windows, :, :1024].contiguous()),
          K.lay_rows8(neg[:, :1024].contiguous()),
          *(K.lay_rows8(t[:, :1024].contiguous()) for t in tabs))
    ragged["strauss_tab_rows8"] = [
        (lambda: K.strauss_rows8_tiles(*rl, rows_l),
         lambda: K.strauss_tab_rows8_plain(*rl, rows_l))]
    wr = K.from_reference(rng.integers(0, 1 << 32, (34, RAGGED),
                                       dtype=np.uint64).astype(np.uint32),
                          dev)
    ragged["keccak_rows_grid"] = [(lambda: K.keccak_rows_grid(wr),
                                   lambda: K.keccak_rows_grid_plain(wr))]
    counts = {"pow_mod_rows8": RAGGED_POW8, "strauss_tab_rows8": rows_l,
              "keccak_rows_grid": RAGGED}

    records = {}
    for name, entries in (("pow_mod_rows8", pows),
                          ("strauss_tab_rows8", [ladder]),
                          ("keccak_rows_grid", [keccak])):
        rec = _check_kernel(name, [e for e, _ in entries], ragged[name],
                            counts[name], clock_hz, ptxas, "tiling_kernel")
        # the default-layout twin and the reference-contract wrapper on
        # the same values: equal, and timed the same way
        rec["twin_ms"] = rec["path_ms"] = 0.0
        for _, (twin, path) in entries:
            if max_abs_err(path(), twin()):
                raise AssertionError(f"{name}: tiling and default layout "
                                     "differ")
            rec["twin_ms"] += cuda_event_ms(twin, reps=5)
            rec["path_ms"] += cuda_event_ms(path, reps=5)
        emit({"phase": "tiling_kernel", "name": name,
              "twin_ms": rec["twin_ms"], "path_ms": rec["path_ms"],
              "ms": rec["ms"], "twin_equal": True})
        records[name] = rec
    return records


def phase_tiling(rows, slice_out, r3, r4, dev):
    """Recovery, verify, keccak and a stacked window through the entry
    points under the tiling configuration, against phase 3, the host
    model and the default path, with the pinned launches of each.
    Returns the launches of each path."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.crypto.keccak import keccak256
    from eges_tpu_torch.crypto.verifier import BatchVerifier, ecrecover_batch
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.ops.keccak import keccak256_fixed

    out = {"phase": "tiling", "env": tt.TILING_ENV}
    paths = {}

    def run(what, fn, pinned):
        with tt.tiling_config():
            K.reset_launches()
            got = fn()
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        want = dict.fromkeys(K.KERNELS, 0)
        want.update(pinned)
        if launches != want:
            raise AssertionError(f"tiling {what}: launch counts {launches}, "
                                 f"want {want}")
        paths["tiling_" + what] = launches
        return got

    verifier = BatchVerifier()
    sigs, hashes, answers = rows
    addrs, ok = run("recover", lambda: verifier.recover_addresses(
        sigs, hashes), tt.TILING_RECOVER_LAUNCHES)
    if not (np.array_equal(addrs, slice_out[0])
            and np.array_equal(ok, slice_out[1])):
        raise AssertionError("tiling recovery differs from phase 3")
    for i, ans in enumerate(answers):
        if (ans is None) == bool(ok[i]) or (
                ans is not None and bytes(addrs[i]) != ans[0]):
            raise AssertionError(f"tiling recovery row {i} differs from the "
                                 "host model")
    out["recover"] = {"rows": len(sigs), "rows_matching_phase3": len(sigs),
                      "rows_matching_host": len(sigs)}

    for cfg, (vs, vh, vp, _, vans) in (("config3", r3), ("config4", r4)):
        vok = run("verify", lambda: verifier.verify(vs, vh, vp),
                  tt.TILING_VERIFY_LAUNCHES)
        if [bool(v) for v in vok] != list(vans):
            raise AssertionError(f"tiling verify {cfg} differs from the host "
                                 "model")
        out[cfg] = {"rows": len(vs), "rows_matching_host": len(vs),
                    "accepted": int(vok.sum())}

    txs = np.random.default_rng(SEED + 4).integers(0, 256, (B_KECCAK, 110),
                                                   dtype=np.uint8)
    dig = run("keccak", lambda: keccak256_fixed(torch.from_numpy(txs).to(
        dev)), {"keccak_rows_grid": 1}).cpu().numpy()
    for i in range(len(txs)):
        if bytes(dig[i]) != keccak256(bytes(txs[i])):
            raise AssertionError(f"tiling keccak row {i} differs from the "
                                 "host model")
    out["keccak"] = {"rows": len(txs), "matching_host": len(txs)}

    n = STACK[0] * STACK[1]
    s_dev = torch.from_numpy(sigs[:n]).to(dev)
    h_dev = torch.from_numpy(hashes[:n]).to(dev)
    fused = ecrecover_batch(s_dev, h_dev)
    got = run("stacked_recover", lambda: ecrecover_batch(
        s_dev.reshape(*STACK, 65), h_dev.reshape(*STACK, 32)),
        tt.TILING_UNFUSED_RECOVER_LAUNCHES)
    for g, f, what in zip(got, fused, ("addrs", "pubs", "ok")):
        if not torch.equal(g.reshape(n, *g.shape[2:]), f):
            raise AssertionError(f"tiling stacked recovery: {what} differ "
                                 "from the default fused path")
    out["stacked_recover"] = {"shape": list(STACK),
                              "rows_matching_default": n}
    out["launches"] = {p: {k: v for k, v in l.items() if v}
                       for p, l in paths.items()}
    emit(out)
    return paths


def phase_tiling_ab(rows, r3, r4):
    """The default and tiling configurations in turns (``AB_ROUNDS``):
    recovery verifies/s at 8192 rows, p50 of recovery at 1024 rows and of
    verify at 1024 and 256 rows; each configuration's values, median and
    spread.  Only pairs from this one call compare."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.crypto.verifier import BatchVerifier

    sigs, hashes, _ = rows
    s8 = np.ascontiguousarray(np.resize(sigs, (B_MAIN, 65)))
    h8 = np.ascontiguousarray(np.resize(hashes, (B_MAIN, 32)))
    s1, h1 = s8[:1024].copy(), h8[:1024].copy()
    verifier = BatchVerifier()

    def p50_ms(fn):
        fn()                                               # warm-up
        lat = []
        for _ in range(AB_CALLS):
            t0 = time.perf_counter()
            fn()
            lat.append(time.perf_counter() - t0)
        return float(np.median(lat)) * 1e3

    vals = {cfg: {} for cfg in ("default", "tiling")}
    for cfg in AB_ROUNDS:
        with tt.tiling_config(cfg == "tiling"):
            verifier.recover_addresses(s8, h8)             # warm-up
            t0 = time.perf_counter()
            for _ in range(AB_8192):
                verifier.recover_addresses(s8, h8)
            got = {"verifies_per_s_8192":
                   AB_8192 * B_MAIN / (time.perf_counter() - t0),
                   "recover_p50_ms_1024": p50_ms(
                       lambda: verifier.recover_addresses(s1, h1)),
                   "verify_p50_ms_1024": p50_ms(
                       lambda: verifier.verify(*r4[:3])),
                   "verify_p50_ms_256": p50_ms(
                       lambda: verifier.verify(*r3[:3]))}
        for k, v in got.items():
            vals[cfg].setdefault(k, []).append(v)
    out = {"phase": "tiling_ab", "order": list(AB_ROUNDS),
           "runs_8192": AB_8192, "calls_per_p50": AB_CALLS}
    for cfg, metrics in vals.items():
        out[cfg] = {k: {"values": v, "median": float(np.median(v)),
                        "min": min(v), "max": max(v)}
                    for k, v in metrics.items()}
    emit(out)
    return out


def phase_profile_kernels(dev, clock_hz, ptxas):
    """The harness's four kernels at its shapes, each against its plain
    version on the same tensors (``_check_kernel``), with the kernel's
    time alone on cold L2 (``cold_ms``: the back-to-back events count the
    host's launch pace too, and keep inputs in L2), which must not beat
    the bound either; the two layouts' chains and #20c against #7 on the
    same values.  Returns the records of B = 4096 (lane 256 for #20a),
    each with ``shapes``: ms, cold ms, bound and plain ms of every shape
    run."""
    from eges_tpu_torch.harness.profutil import cuda_event_ms
    from eges_tpu_torch.ops import kernels as K, opcount

    rng = np.random.default_rng(SEED + 7)
    OPS = opcount.per_row()
    chain = K.PROFILE_CHAIN

    def limbs(shape):
        return torch.from_numpy(rng.integers(0, 1 << 16, shape).astype(
            np.int32)).to(dev)

    records = {}

    def check(name, label, entry, ragged=(), ragged_rows=None, extra=None):
        extra = {"shape": label,
                 "cold_ms": cuda_event_ms(entry[0], cold=True),
                 **(extra or {})}
        rec = _check_kernel(name, [entry], ragged, ragged_rows, clock_hz,
                            ptxas, "profile_kernel", extra)
        first = records.setdefault(name, rec)
        first.setdefault("shapes", {})[label] = {
            k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                *extra)}
        return rec

    for B in B_PROFILE:
        a, b = limbs((16, B)), limbs((16, B))
        at, bt = K.lay_rows8(a), K.lay_rows8(b)
        byt, ops = 3 * nbytes(a), B * OPS["fp_mul_chain"]
        for lane in (256, 1024):
            ragged = ()
            if B == B_PROFILE[0] and lane == 256:
                wide, rlane = RAGGED_CHAIN
                ra, rb = limbs((16, wide)), limbs((16, wide))
                ragged = [(lambda: K.fp_mul_chain_pallas(ra, rb, chain, rlane),
                           lambda: K.fp_mul_chain_plain(ra, rb, chain))]
            check("fp_mul_chain", f"B{B}_lane{lane}", (
                lambda lane=lane: K.fp_mul_chain_pallas(a, b, chain, lane),
                lambda: K.fp_mul_chain_plain(a, b, chain), byt, ops),
                ragged, RAGGED_CHAIN[0], {"lane": lane})
        check("fp_mul_chain_rows8", f"B{B}", (
            lambda: K.fp_mul_chain_rows8(at, bt),
            lambda: K.fp_mul_chain_rows8_plain(at, bt), byt,
            B * OPS["fp_mul_chain_rows8"]))
        # both layouts, the same values: the same products
        if max_abs_err(K.lay_rows8(K.fp_mul_chain_pallas(a, b, chain, 256)),
                       K.fp_mul_chain_rows8(at, bt)):
            raise AssertionError(f"B={B}: the two layouts' chains differ")
        rows_a, rows_b = a.T.contiguous(), b.T.contiguous()
        if max_abs_err(K.from_rows8(K.fp_mul_rows8(at, bt), B),
                       K.fp_mul_pallas(rows_a, rows_b)):
            raise AssertionError(f"B={B}: fp_mul_rows8 differs from fp_mul")
        check("fp_mul_rows8", f"B{B}", (
            lambda: K.fp_mul_rows8(at, bt),
            lambda: K.fp_mul_rows8_plain(at, bt), byt,
            B * OPS["fp_mul_rows8"]),
            extra={"fp_mul_ms": cuda_event_ms(
                lambda: K.fp_mul_pallas(rows_a, rows_b), reps=5),
                "fp_mul_cold_ms": cuda_event_ms(
                    lambda: K.fp_mul_pallas(rows_a, rows_b), cold=True)})
    x = torch.from_numpy(rng.standard_normal((8, 128), dtype=np.float32)).to(
        dev)
    rec = check("add_one_f32", "8x128", (
        lambda: K.add_one_f32(x), lambda: K.add_one_f32_plain(x),
        2 * nbytes(x), x.numel() * OPS["add_one_f32"]))
    rec["library_ms"] = cuda_event_ms(lambda: x + 1.0, reps=5)
    emit({"phase": "profile_kernel", "name": "add_one_f32",
          "library_ms": rec["library_ms"],
          "library_cold_ms": cuda_event_ms(lambda: x + 1.0, cold=True),
          "library": "x + 1.0"})
    _ab_f32("add_one_f32", "8x128", lambda: K.add_one_f32(x),
            lambda: x + 1.0, "x + 1.0")
    # #21 at the floor's tile (the shape phase analysis drives it at) and
    # at MUL_SCALAR_BIG elements, where bytes and not the launch set the
    # time; its library call is ATen's x * s on the same float32 scalar.
    # The big case also at views that start off 16 bytes and at counts
    # that leave a scalar tail (bit for bit).
    s = K._f32(time.time())
    for label, shape in (("8x128", (8, 128)), ("2^24", (MUL_SCALAR_BIG,))):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            dev)
        x.view(-1)[:5] = torch.tensor((0.0, -0.0, 3e38, -1e-30, 2.0**24),
                                      device=dev)
        flat = x.view(-1)
        ragged = ()
        if label == "2^24":
            views = [flat[1:], flat[2:-1], flat[3:-2], flat[1:2],
                     flat[:3], flat[1:6], flat[5:5 + 4 * 1000 + 3]]
            ragged = [(lambda v=v: K.mul_scalar_f32(v, s),
                       lambda v=v: K.mul_scalar_f32_plain(v, s))
                      for v in views]
        lib = {"library_ms": cuda_event_ms(lambda: x * s, reps=5),
               "library_cold_ms": cuda_event_ms(lambda: x * s, cold=True)}
        rec = check("mul_scalar_f32", label, (
            lambda: K.mul_scalar_f32(x, s),
            lambda: K.mul_scalar_f32_plain(x, s), 2 * nbytes(x),
            x.numel() * OPS["mul_scalar_f32"]), ragged,
            "views from 1, 2, 3 and 5 elements in, of 1, 3, 5, 4003 and "
            "2^24 - 1, 3, 5 elements",
            extra=lib)
        if min(lib.values()) < rec["bound_ms"]:
            raise AssertionError(f"mul_scalar_f32 {label}: x * s at {lib} "
                                 f"beats the bound of {rec['bound_ms']} ms")
        _ab_f32("mul_scalar_f32", label, lambda: K.mul_scalar_f32(x, s),
                lambda: x * s, "x * s", rec["bound_ms"])
    return records


def _ab_f32(name, label, kern, lib, lib_name, bound_ms=None):
    """A float32 kernel and its library call in turns (AB_F32_ORDER), in
    this one call: each round's mean ms by events over AB_F32_REPS calls
    back to back and over AB_F32_COLD calls each on cold L2; emits every
    round, each side's median and spread, and the kernel's median over
    the library's."""
    from eges_tpu_torch.harness.profutil import cuda_event_ms

    fns = {"kernel": kern, "library": lib}
    runs = {who: {"ms": [], "cold_ms": []} for who in fns}
    for who in AB_F32_ORDER:
        runs[who]["ms"].append(cuda_event_ms(fns[who], reps=AB_F32_REPS))
        runs[who]["cold_ms"].append(cuda_event_ms(fns[who], reps=AB_F32_COLD,
                                                  cold=True))
    med = {who: {k: float(np.median(v)) for k, v in r.items()}
           for who, r in runs.items()}
    out = {"phase": "profile_ab", "name": name, "shape": label,
           "library": lib_name, "order": list(AB_F32_ORDER), "rounds": runs,
           "median": med,
           "spread": {who: {k: max(v) - min(v) for k, v in r.items()}
                      for who, r in runs.items()},
           "kernel_over_library": {
               k: med["kernel"][k] / med["library"][k] for k in med["kernel"]}}
    if bound_ms is not None:
        out["bound_ms"] = bound_ms
        out["bound_share"] = {k: bound_ms / v
                              for k, v in med["kernel"].items()}
    emit(out)
    return out


@contextlib.contextmanager
def _prefixed(tag: str):
    """Print what the block prints, each line after ``[tag] ``."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    finally:
        for line in buf.getvalue().splitlines():
            print(f"[{tag}] {line}", flush=True)


def phase_profile(dev):
    """The eight harness modules through their ``main``s on the card, with
    the checks of each; returns the launches of the whole phase (the
    floor's ``pallasnop`` child counts its own, added in)."""
    from eges_tpu_torch.harness import (hlo_census, measure_recover,
                                        profile_floor, profile_kernels2,
                                        profile_mul8b, profile_mulchain,
                                        profile_stages, profutil)
    from eges_tpu_torch.ops import build, kernels as K
    from eges_tpu_torch.ops.keccak import keccak256_fixed

    rng = np.random.default_rng(SEED + 8)
    out = {"phase": "profile"}
    K.reset_launches()
    with _prefixed("profile_mulchain"):
        out["mulchain"] = {B: profile_mulchain.main(B, rng, dev)
                           for B in B_PROFILE}
    with _prefixed("profile_mul8b"):
        out["mul8b"] = profile_mul8b.main(4096, dev)
    if not out["mul8b"]["correct"]:
        raise AssertionError("profile_mul8b: correct=False")
    with _prefixed("profile_floor"):
        floor = profile_floor.main(dev, seed=SEED)
    if floor["failed"] or set(floor["results"]) != set(profile_floor.CONFIGS):
        raise AssertionError(f"profile_floor: no result for {floor['failed']}")
    out["floor"], out["verdict"] = floor["results"], floor["verdict"]
    with _prefixed("measure_recover"):
        out["measure_recover"] = measure_recover.main(MEASURE_BATCHES, rng,
                                                      dev)
    with _prefixed("profile_kernels2"):
        out["kernels2"] = profile_kernels2.main(
            4096, str(build.BUILD_DIR / "kernel_profile2.json"), rng, dev)
    with _prefixed("profile_stages"):
        out["stages"] = profile_stages.main(1024, rng, dev)
    # each census window is one fused recovery: its hand-written kernels
    # by name, mapped to their wrappers, are the pinned 18 launches
    wrapper_of = {g: name for name in K.KERNELS
                  for g in GLOBALS.get(name, ("k_" + name,))}
    wrapper_of.update({fmt.format(t): kernel[:len("pow_mod")]
                       if kernel.startswith("pow_mod") else kernel
                       for kernel, fmt in LANE_GLOBALS.items()
                       for t in K.LANES})

    def by_wrapper(census):
        counts = {}
        for g, n in census["hand_written"].items():
            counts[wrapper_of[g]] = counts.get(wrapper_of[g], 0) + n
        return counts

    censuses = {}
    with _prefixed("hlo_census"):
        for B in CENSUS_BATCHES:
            # a window the profiler left short is traced again
            # (_lane_launches)
            for _ in range(PROFILE_TRIES):
                census = hlo_census.main(B, rng, dev)
                kernels = by_wrapper(census)
                if kernels == census["launches"] == FUSED_RECOVER_LAUNCHES:
                    break
            else:
                raise AssertionError(f"launch census at {B}: kernels "
                                     f"{kernels}, wrappers "
                                     f"{census['launches']}, want "
                                     f"{FUSED_RECOVER_LAUNCHES}")
            censuses[B] = census
        # verify's own kernels (#14-#16a) inside one verify batch, and the
        # window's idle share
        for _ in range(PROFILE_TRIES):
            vcensus = hlo_census.main(B_VERIFY, rng, dev, path="verify")
            kernels = by_wrapper(vcensus)
            if kernels == vcensus["launches"] == VERIFY_LAUNCHES:
                break
        else:
            raise AssertionError(f"verify census: kernels {kernels}, "
                                 f"wrappers {vcensus['launches']}, want "
                                 f"{VERIFY_LAUNCHES}")
    # #13 inside keccak256_fixed of a config-4 block's transactions
    txs = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, 256, (B_KECCAK, 110), dtype=np.uint8)).to(dev)
    for _ in range(PROFILE_TRIES):
        kevents, kwall = profutil.profile_window(keccak256_fixed, txs,
                                                 device=dev)
        kcensus = hlo_census.census(kevents)
        if kcensus["hand_written"] == {"k_keccak_block": 1}:
            break
    else:
        raise AssertionError(f"keccak window: {kcensus['hand_written']}")
    launches = dict(K.LAUNCHES)
    launches["add_one_f32"] += floor["results"]["pallasnop"]["launches"].get(
        "add_one_f32", 0)

    def launch_ms(census):
        """The device ms of each launch of each kernel, in the order they
        ran."""
        each = {}
        for g, us in census["launch_order"]:
            each.setdefault(wrapper_of[g], []).append(us / 1e3)
        return each

    out["census"] = {B: {**{k: census[k] for k in (
        "hand_written", "aten", "copy", "wall_ms", "kernel_ms",
        "busy_share", "idle_share", "copy_us")},
        "launch_ms": launch_ms(census)} for B, census in censuses.items()}
    out["verify_census"] = {
        **{k: vcensus[k] for k in ("batch", "hand_written", "wall_ms",
                                   "kernel_ms", "busy_share",
                                   "idle_share")},
        "launch_ms": launch_ms(vcensus)}
    out["keccak_census"] = {
        "rows": B_KECCAK, "wall_ms": kwall * 1e3,
        "kernel_ms": kcensus["kernel_us"] / 1e3,
        "idle_share": 1.0 - kcensus["kernel_us"] / 1e3 / (kwall * 1e3),
        "launch_ms": launch_ms(kcensus)}
    out["launches"] = {k: v for k, v in launches.items() if v}
    emit(out)
    return launches


def phase_analysis(dev):
    """The port's static-analysis gate over the tree the script runs from
    (``eges_tpu_torch`` and this file): no unsuppressed finding, no
    error, no stale baseline; and the seeded launch-purity fixture still
    fires.  Then the path of kernel #21: the reference fixture's
    ``run(x)``, ``x`` times the host clock, on one (8, 128) float32 tile
    through ``mul_scalar_f32``, against its plain version.  Returns the
    launches of that run."""
    from eges_tpu_torch.harness.analysis import run
    from eges_tpu_torch.ops import kernels as K

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    rep = run(root)
    seconds = time.monotonic() - t0
    out = {"phase": "analysis", "seconds": round(seconds, 3),
           "files": rep.files, "findings": len(rep.findings),
           "unsuppressed": len(rep.unsuppressed),
           "waived": sum(f.waived for f in rep.findings),
           "baselined": sum(f.baselined for f in rep.findings),
           "findings_by_rule": {r: n for r, n in
                                rep.findings_by_rule().items() if n},
           "checker_seconds": {k: round(v, 4) for k, v in
                               rep.checker_seconds.items()}}
    if rep.unsuppressed or rep.errors or rep.stale_baseline:
        emit(out)
        raise AssertionError(
            "analysis gate: " + "; ".join(
                [f.render() for f in rep.unsuppressed] + rep.errors
                + [f"stale baseline {e}" for e in rep.stale_baseline]))
    seeded = run(os.path.join(root, "tests", "torch_analysis_fixtures",
                              "jit"), paths=("eges_tpu_torch",),
                 rules=("launch-purity",), baseline_path=None)
    out["fixture_unsuppressed"] = len(seeded.unsuppressed)
    if len(seeded.unsuppressed) != 3:
        raise AssertionError("launch-purity fixture: " + "; ".join(
            f.render() for f in seeded.findings))
    x = torch.from_numpy(np.random.default_rng(SEED + 9).standard_normal(
        (8, 128), dtype=np.float32)).to(dev)
    K.reset_launches()
    t = time.time()
    o = K.mul_scalar_f32(x, t)
    launches = dict(K.LAUNCHES)
    if max_abs_err(o.view(torch.int32),
                   K.mul_scalar_f32_plain(x, t).view(torch.int32)):
        raise AssertionError("mul_scalar_f32 differs from x * t")
    out["launches"] = {k: v for k, v in launches.items() if v}
    emit(out)
    return launches


def _sim_run(run: str, verifier):
    """One run of phase sim over ``verifier``: ``"config2"`` (the
    transfers admitted before the first block, ``testing.flood_sim``),
    ``"gossip"`` (the transfers gossiped by the flooder and relayed by
    every node) or ``"signed"`` (signed votes, no transfers).  Returns
    its outcome (``testing.sim_outcome``, the verifier-only events
    dropped), the scheduler's stats, the rows of each flushed window and
    the wall seconds."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.sim.cluster import SimCluster

    committee = {"n_candidates": SIM_CANDIDATES,
                 "n_acceptors": SIM_ACCEPTORS}
    if run == "signed":
        txs = ()
        t0 = time.monotonic()
        c = SimCluster(SIM_NODES, signed=True, verifier=verifier,
                       seed=SIM_SIGNED["seed"],
                       txn_per_block=SIM_SIGNED["txn_per_block"],
                       **committee)
        c.start()
        c.run(300, stop_condition=lambda: (
            c.min_height() >= SIM_SIGNED["height"]))
        for sn in c.nodes:
            sn.node.stop()
    else:
        g = SIM_GOSSIP
        n, seed, window, per_block = (
            (SIM_BLOCKS * SIM_TXN_PER_BLOCK, SIM_SEED, SIM_WINDOW,
             SIM_TXN_PER_BLOCK) if run == "config2" else
            (g["transfers"], g["seed"], g["window"], g["txn_per_block"]))
        txs, alloc = tt.sim_transfers(n, SIM_SENDERS, seed)
        t0 = time.monotonic()
        c = tt.flood_sim(verifier, txs, alloc, nodes=SIM_NODES,
                         window=window, seed=seed, txn_per_block=per_block,
                         gossip=run == "gossip",
                         start_s=0.01 if run == "gossip" else 0.0,
                         columnar=True, signed=False, **committee)
    wall = time.monotonic() - t0
    stats = c.verifier.stats()
    c.verifier.close()
    flushes = [e["rows"] for evs in c.journals().values() for e in evs
               if e.get("type") == "verifier_flush"]
    return (tt.sim_outcome(c, txs, tt.verifier_only), stats, flushes,
            wall)


def _first_difference(a: str, b: str) -> str:
    for i, (x, y) in enumerate(zip(a.splitlines(), b.splitlines())):
        if x != y:
            return f"line {i}: {x[:300]} != {y[:300]}"
    return f"lengths {len(a)} and {len(b)}"


def _sim_device_run(run: str):
    """One phase sim run on the card, ``SimCluster(verifier=
    BatchVerifier())``, the wrappers' launches counted from 0 around it
    and its kernels' device time taken by the profiler (CUDA activity
    only).  Returns ``_sim_run``'s four values, the launches, the
    kernels' seconds and the devstats snapshot (goodput: rows over padded
    rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from eges_tpu_torch.crypto.verifier import BatchVerifier
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.utils import devstats

    bv = BatchVerifier()
    devstats.DEFAULT.rebase()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outcome, stats, flushes, wall = _sim_run(run, bv)
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and e.name.startswith("k_")) / 1e6
    good = devstats.DEFAULT.snap()["devices"]
    return outcome, stats, flushes, wall, launches, busy, good


def phase_sim(card):
    """BASELINE config 2 on the port: 64 nodes with txpools, columnar
    ingress and 1000 txn a block, SIM_BLOCKS blocks' worth of signed
    transfers admitted by every pool in flooder windows; the same
    committee with SIM_GOSSIP's transfers gossiped by the flooder and
    relayed by every node; then 64 nodes with signed votes to
    SIM_SIGNED's height.  Each run over ``SimCluster(verifier=
    BatchVerifier())`` on the card, then over the port's
    ``NativeBatchVerifier`` on the same seed, one after the other: the
    two must agree node for node in heights, the block hash at every
    height, the height at which each transfer is included, txpool
    stats, network counts and the canonical journal dump without
    ``testing.VERIFIER_ONLY`` events; no row served by the host, 18
    launches per device window.  Returns the launches of the card's
    runs."""
    from eges_tpu_torch import testing as tt
    from eges_tpu_torch.crypto.verify_host import NativeBatchVerifier
    from eges_tpu_torch.ops import kernels as K

    total = dict.fromkeys(K.KERNELS, 0)
    for run in ("signed", "gossip", "config2"):
        (outcome, stats, flushes, wall, launches, busy,
         good) = _sim_device_run(run)
        want, twin_stats, _, twin_wall = _sim_run(run,
                                                  NativeBatchVerifier())
        windows = stats["pipeline_windows"]
        rows = stats["rows"]
        out = {
            "phase": "sim", "run": run, "card": card,
            "nodes": SIM_NODES, "heights": sorted(set(
                outcome["heights"])),
            "wall_s": round(wall, 3), "twin_wall_s": round(twin_wall, 3),
            "device_windows": windows, "batches": stats["batches"],
            "rows": rows, "cache_hits": stats["cache_hits"],
            "host_diverted": stats["host_diverted"],
            "gossip_msgs": outcome["net"]["gossip"],
            "gossip_bytes": outcome["net"]["gossip_bytes"],
            "direct_msgs": outcome["net"]["direct"],
            "device_errors": stats["device_errors"],
            "rows_per_window_p50": (statistics.median(flushes)
                                    if flushes else None),
            "rows_per_window_max": max(flushes, default=None),
            "device_rows_per_s": round(rows / wall, 1),
            "rows_per_busy_s": round(rows / busy, 1) if busy else None,
            "busy_s": round(busy, 6),
            "idle_share": round(1.0 - busy / wall, 6),
            "devstats": good,
            "twin": {k: twin_stats[k] for k in
                     ("batches", "rows", "cache_hits", "host_diverted")},
            "dropped_events": tt.VERIFIER_ONLY,
            "launches": {k: v for k, v in launches.items() if v}}
        if run != "signed":
            out["transfers"] = len(outcome["included"][0])
            out["transfer_heights"] = sorted(
                set(outcome["included"][0]), key=str)
            out["wall_s_per_transfer"] = round(wall / out["transfers"], 4)
        emit(out)
        for key in ("heights", "hashes", "included", "pool", "net"):
            if outcome[key] != want[key]:
                raise AssertionError(f"sim {run}: {key} differs from "
                                     "the native-verifier twin")
        if outcome["dump"] != want["dump"]:
            raise AssertionError(
                f"sim {run}: journal differs from the native twin at "
                + _first_difference(outcome["dump"], want["dump"]))
        if None in sum(outcome["included"], []):
            raise AssertionError(f"sim {run}: a transfer was not included")
        if min(outcome["heights"]) < (SIM_SIGNED["height"]
                                      if run == "signed" else 1):
            raise AssertionError(f"sim {run}: heights "
                                 f"{out['heights']}")
        if stats["host_diverted"] or stats["device_errors"] or not windows:
            raise AssertionError(f"sim {run}: host_diverted "
                                 f"{stats['host_diverted']}, device "
                                 f"errors {stats['device_errors']}, "
                                 f"windows {windows}")
        want_launches = {k: n * windows
                         for k, n in FUSED_RECOVER_LAUNCHES.items()}
        if {k: v for k, v in launches.items() if v} != want_launches:
            raise AssertionError(f"sim {run}: launches {launches}, want "
                                 f"18 a window: {want_launches}")
        for k, v in launches.items():
            total[k] += v
    return total


def phase_pow(card):
    """``PowEngine()`` on the card (sweeps of 4096 nonces through
    ``keccak256_fixed``, one launch of #13 each) mines POW_BLOCKS blocks
    on a chain whose genesis has difficulty POW_DIFFICULTY; the host
    loop, ``PowEngine(use_device=False)``, mines the same chain from the
    same genesis: the headers must be equal, and every launch of the run
    a keccak_block.  Seconds of each way's ``mine_next`` calls (the
    preview, the seal hash and the chain's check of the seal included).
    Returns the launches of the device run."""
    import dataclasses

    from eges_tpu_torch.core.chain import BlockChain, make_genesis
    from eges_tpu_torch.core.engine import PowEngine
    from eges_tpu_torch.core.types import new_block
    from eges_tpu_torch.ops import kernels as K

    g = make_genesis()
    genesis = new_block(dataclasses.replace(g.header,
                                            difficulty=POW_DIFFICULTY))
    heads = {}
    for way, eng in (("device", PowEngine()),
                     ("host", PowEngine(use_device=False))):
        chain = BlockChain(genesis=genesis, engine=eng)
        K.reset_launches()
        t0 = time.monotonic()
        heads[way] = [eng.mine_next(chain).header for _ in range(POW_BLOCKS)]
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = dict(K.LAUNCHES)
        if way == "device":
            dev_launches, dev_s = launches, seconds
            if not eng.use_device:
                raise AssertionError("pow: the engine left the card")
        else:
            host_s = seconds
    sweeps = dev_launches["keccak_block"]
    emit({"phase": "pow", "card": card, "blocks": POW_BLOCKS,
          "difficulty": POW_DIFFICULTY, "sweep_batch": 4096,
          "sweeps": sweeps, "device_s": round(dev_s, 4),
          "host_loop_s": round(host_s, 4),
          "mine_ms_per_sweep": round(dev_s * 1e3 / max(sweeps, 1), 4),
          "nonces": [int.from_bytes(h.nonce, "big") for h in heads["device"]],
          "launches": {k: v for k, v in dev_launches.items() if v}})
    if heads["device"] != heads["host"]:
        raise AssertionError("pow: the card's headers differ from the host "
                             "loop's")
    if {k for k, v in dev_launches.items() if v} != {"keccak_block"} \
            or sweeps < POW_BLOCKS:
        raise AssertionError(f"pow: launches {dev_launches}")
    return dev_launches


def _rpc_batch(port: int, calls, timeout: float = 30.0) -> list:
    """One batched JSON-RPC request to a localhost node: the results in
    the calls' order; an error answer raises."""
    import urllib.request

    body = json.dumps([{"jsonrpc": "2.0", "id": i, "method": m,
                        "params": p} for i, (m, p) in enumerate(calls)])
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}", data=body.encode(),
        headers={"Content-Type": "application/json"})
    out = json.loads(urllib.request.urlopen(req, timeout=timeout).read())
    by_id = {r["id"]: r for r in out}
    for i, (m, _) in enumerate(calls):
        if "error" in by_id[i]:
            raise AssertionError(f"rpc {m} on port {port}: "
                                 f"{by_id[i]['error']}")
    return [by_id[i]["result"] for i in range(len(calls))]


def _alive(pid: int) -> bool:
    """Whether a process runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _stop_nodes(d: str, pids) -> None:
    """SIGTERM every process of the cluster in ``d``, then SIGKILL what
    still runs after 10 s, and reap them."""
    import signal

    from eges_tpu_torch.harness import cluster as hc

    hc.kill_cluster(d)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.1)
    for pid in pids:
        if _alive(pid):
            os.kill(pid, signal.SIGKILL)
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass


def _node_transfers():
    """NODE_CLUSTER's signed transfers: ``senders`` keys from the seed,
    each sending ``transfers / senders`` zero-value, zero-price transfers
    (consecutive nonces) to a recipient of its own: a node's genesis
    funds no account, as the reference's; the txns, the senders'
    addresses and the recipients'."""
    from eges_tpu_torch.core.types import Transaction
    from eges_tpu_torch.crypto import secp256k1 as secp
    from eges_tpu_torch.crypto.keccak import keccak256

    c = NODE_CLUSTER
    privs = [keccak256(b"eges-node-sender" + c["seed"].to_bytes(8, "big")
                       + i.to_bytes(4, "big")) for i in range(c["senders"])]
    senders = [secp.pubkey_to_address(secp.privkey_to_pubkey(k))
               for k in privs]
    recips = [keccak256(b"eges-node-recipient" + a)[:20] for a in senders]
    txs = [Transaction(nonce=i // c["senders"], gas_price=0,
                       gas_limit=21000, to=recips[i % c["senders"]],
                       value=0).signed(privs[i % c["senders"]])
           for i in range(c["transfers"])]
    return txs, senders, recips


def _count(v) -> float:
    """A metric's count: a counter's or gauge's value, a meter's or
    histogram's count; 0 where absent."""
    if isinstance(v, dict):
        return v.get("count", 0)
    return v or 0


def _node_cluster(d: str, torch_nodes: set, trace_windows: int = 0):
    """One run of phase node's cluster in directory ``d``: NODE_CLUSTER's
    nodes started by the port's harness (``torch_nodes`` on
    ``--verifier torch``, the others native), its UDP Geec txns into
    node 0's ``--geecTxnPort`` through ``txn_client``, then its transfers
    sent by ``eth_sendRawTransaction`` round robin over the nodes' RPC
    ports from a thread pool; waits until every transfer has a receipt on
    the node it was sent to (a receipt lookup decodes its block, some
    ms of a node's loop, so each is read once), then until every node
    is past the last transfer's block and node 0 holds no UDP txn back
    from its proposals.  A node that dies, or an RPC that
    fails, fails the run.  Returns what phase node checks and prints."""
    from concurrent.futures import ThreadPoolExecutor

    from eges_tpu_torch.harness import cluster as hc
    from eges_tpu_torch.harness import txn_client

    c = NODE_CLUSTER
    n = c["nodes"]
    # free port bases: another checkout's cluster may run on this host
    bases = hc.Ports.free(n)
    ports = [bases.rpc + i for i in range(n)]
    txs, senders, recips = _node_transfers()
    t0 = time.monotonic()
    pids = hc.start_cluster(d, n, txn_per_block=c["txn_per_block"],
                            torch_nodes=torch_nodes, ports=bases)
    out = {"pids": pids}
    try:
        def check_alive():
            for i, pid in enumerate(pids):
                if not _alive(pid):
                    with open(os.path.join(d, f"node{i}.log"), "rb") as fh:
                        tail = fh.read()[-3000:].decode(errors="replace")
                    raise AssertionError(f"node {i} died:\n{tail}")

        def wait(cond, limit, what):
            deadline = time.monotonic() + limit
            while True:
                check_alive()
                got = cond()
                if got:
                    return got
                if time.monotonic() > deadline:
                    raise AssertionError(f"node cluster: {what} not within "
                                         f"{limit} s")
                time.sleep(0.2)

        def answers():
            try:
                return [int(_rpc_batch(p, [("eth_blockNumber", [])],
                                       timeout=5)[0], 16) for p in ports]
            except OSError:     # not listening yet
                return None

        hs = wait(lambda: (lambda h: h if h and min(h) >= 1 else None)(
            answers()), c["start_s"], "RPC on every node and height 1")
        out["start_s"] = round(time.monotonic() - t0, 3)
        before = [_rpc_batch(p, [("thw_metrics", [])])[0] for p in ports]
        if trace_windows:
            tdir = os.path.join(d, "trace")
            armed = _rpc_batch(ports[0], [("thw_device_trace", [
                {"windows": trace_windows, "dir": tdir}])])[0]
            out["trace_armed"] = armed["state"]
        sent = [0.0] * len(txs)

        def send(i):
            raw = "0x" + txs[i].encode().hex()
            sent[i] = time.monotonic()
            h = _rpc_batch(ports[i % n], [("eth_sendRawTransaction",
                                           [raw])])[0]
            if h != "0x" + txs[i].hash.hex():
                raise AssertionError(f"transfer {i}: hash {h}")

        # the UDP txns first: node 0 puts them in a block only when it
        # wins an election, which a card node under the RPC flood may
        # not do for many blocks (C9, open in ROADMAP.md)
        txn_client.run_rate("127.0.0.1", bases.txn, c["udp_rate"],
                            100, c["udp"])
        t_send = time.monotonic()
        with ThreadPoolExecutor(c["rpc_threads"]) as pool:
            list(pool.map(send, range(len(txs))))
        out["send_s"] = round(time.monotonic() - t_send, 3)
        seen = [None] * len(txs)
        status, in_block = [None] * len(txs), [0] * len(txs)

        def mined():
            for i, port in enumerate(ports):
                todo = [j for j in range(i, len(txs), n) if seen[j] is None]
                if not todo:
                    continue
                recs = _rpc_batch(port, [
                    ("eth_getTransactionReceipt",
                     ["0x" + txs[j].hash.hex()]) for j in todo])
                now = time.monotonic()
                for j, r in zip(todo, recs):
                    if r is not None:
                        seen[j], status[j] = now, r["status"]
                        in_block[j] = int(r["blockNumber"], 16)
            return all(s is not None for s in seen)

        wait(mined, c["mine_s"], "every transfer's receipt")
        out["mine_s"] = round(time.monotonic() - t_send, 3)
        lat = sorted(s - t for s, t in zip(seen, sent))
        out["send_to_receipt_p50_s"] = round(statistics.median(lat), 4)
        out["send_to_receipt_max_s"] = round(lat[-1], 4)
        out["statuses"] = sorted(set(status))
        # every node past the last transfer's block (and the UDP txns,
        # which land in the next blocks, committed): equal block hashes
        # there mean equal blocks and receipt roots below it on every
        # node, so the receipts read on the node each transfer was sent
        # to hold on every node
        last = max(in_block)
        time.sleep(c["settle_s"])
        wait(lambda: _rpc_batch(ports[0], [("thw_status", [])])[0][
            "pendingGeecTxns"] == 0, c["mine_s"],
            "node 0's UDP txns drained into its proposals")
        heights = wait(lambda: (lambda h: h if min(h) >= last else None)(
            [int(_rpc_batch(p, [("eth_blockNumber", [])])[0], 16)
             for p in ports]), c["mine_s"], f"every node at height {last}")
        after = [_rpc_batch(p, [("thw_metrics", [])])[0] for p in ports]
        out["heights"], out["last_transfer_block"] = heights, last
        common = min(heights)
        heads = [_rpc_batch(p, [("eth_getBlockByNumber",
                                 [hex(common), False])])[0]["hash"]
                 for p in ports]
        out["common_height"], out["heads_equal"] = common, len(set(heads)) == 1
        accounts = senders + recips + [
            bytes.fromhex(b["account"]) for b in json.load(open(
                os.path.join(d, "genesis.json")))["config"]["thw"][
                "bootstrap"]]
        out["state"] = [_rpc_batch(p, [
            (m, ["0x" + a.hex(), "latest"]) for a in accounts
            for m in ("eth_getBalance", "eth_getTransactionCount")])
            for p in ports]
        out["nonces"] = [[int(v, 16) for v in st[1:2 * len(senders):2]]
                         for st in out["state"]]
        blocks = _rpc_batch(ports[0], [("eth_getBlockByNumber",
                                        [hex(b), False])
                                       for b in range(1, common + 1)])
        out["geec_on_chain"] = sum(b["geecTxnCount"] for b in blocks)
        out["mined"] = sorted({h for b in blocks
                               for h in b["transactions"]})
        out["before"], out["after"] = before, after
        if trace_windows:
            out["trace_status"] = _rpc_batch(ports[0], [("thw_health", [])])[
                0]["devstats"]["trace"]
        out["flights"] = [_rpc_batch(p, [("thw_flight", [4096])])[0]
                          for p in ports]
        out["elections_won"] = [_rpc_batch(p, [("thw_health", [])])[0][
            "electionsWon"] for p in ports]
        check_alive()
        out["wall_s"] = round(time.monotonic() - t0, 3)
    finally:
        _stop_nodes(d, pids)
    return out


def phase_node(card):
    """BASELINE config 1 on the port's node service: NODE_CLUSTER's
    3-node chain of real ``python -m eges_tpu_torch.node`` processes on
    localhost, started by the port's ``harness/cluster.py`` (1000 txn a
    block, RPC on), every node ``--verifier torch`` on this card, after
    the harness has put the kernel library into the artifact store
    (``warm_kernel_store``) and the phase has taken it out of the build
    directory, so the nodes' warm loads it from the store.  The traffic
    of ``_node_cluster``; then the same traffic on a ``--verifier
    native`` twin cluster.  It fails unless every transfer is mined with
    status 0x1 (read on the node it was sent to; every node's block hash
    at a height past the last transfer's block is the same, so every
    node holds the same blocks and receipts), every sender's nonce
    equals its transfers
    (a wrong sender would move another account's), balances, nonces and
    the head hash at a common height agree across nodes, at least 80% of
    the UDP txns are on chain; each node's ``thw_metrics`` shows device
    rows, a device share above 0.95, no host-diverted row, its card's
    name (C8) and, over the traffic, 18 launches a device batch; the
    trace armed on node 0 for NODE_CLUSTER's windows holds 18 kernels a
    window; and the twin mines the same transfers to the same balances
    and nonces.  Returns the card nodes' launches over the traffic."""
    import shutil

    from eges_tpu_torch.harness import cluster as hc
    from eges_tpu_torch.ops import build, kernels as K

    c = NODE_CLUSTER
    t0 = time.monotonic()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "node_cluster")
    shutil.rmtree(root, ignore_errors=True)
    t_warm = time.monotonic()
    warm = hc.warm_kernel_store()
    warm_s = time.monotonic() - t_warm
    # the card nodes start as in a new checkout of these sources: the
    # build directory holds no library (this process keeps its open
    # copy), the artifact store does, so their warm is a store load
    os.unlink(build.library_path())
    card_run = _node_cluster(os.path.join(root, "torch"),
                             set(range(c["nodes"])), c["trace_windows"])
    twin = _node_cluster(os.path.join(root, "native"), set())
    name = torch.cuda.get_device_name(0)
    launches = dict.fromkeys(K.KERNELS, 0)
    nodes = []
    for i, (b, a) in enumerate(zip(card_run["before"], card_run["after"])):
        sched = a.get("verifier.scheduler", {})
        delta = {k: v - b.get("kernels.launches", {}).get(k, 0)
                 for k, v in a.get("kernels.launches", {}).items()}
        batches = _count(a.get("verifier.batches")) - _count(
            b.get("verifier.batches"))
        rows = _count(a.get("verifier.rows")) - _count(b.get("verifier.rows"))
        flights = [f["rows"] for f in card_run["flights"][i]]
        nodes.append({
            "node": i, "device_name": a.get("verifier.device_name"),
            "device_share": a.get("verifier.device_share"),
            "host_rows": a.get("verifier.host_rows", 0),
            "rows": _count(a.get("verifier.rows")),
            "host_diverted": sched.get("host_diverted"),
            "device_errors": sched.get("device_errors"),
            "windows": sched.get("pipeline_windows"),
            "cache_hits": sched.get("cache_hits"),
            "traffic_batches": batches, "traffic_rows": rows,
            "rows_per_window_p50": (statistics.median(flights)
                                    if flights else None),
            "rows_per_window_max": max(flights, default=None),
            "cold_start_s": a.get("verifier.cold_start_seconds"),
            "library": a.get("verifier.aot_library"),
            "aot_loads": _count(a.get("verifier.aot_loads")),
            "aot_compiles": _count(a.get("verifier.aot_compiles")),
            "aot_load_s": (a.get("verifier.aot_load_seconds") or {}).get(
                "max"),
            "traffic_launches": {k: v for k, v in delta.items() if v}})
        for k, v in delta.items():
            launches[k] += v
    trace = card_run.get("trace_status", {})
    tpath = os.path.join(trace.get("path") or "", "trace.json")
    trace_kernels = _trace_kernels(tpath) if os.path.exists(tpath) else 0
    out = {"phase": "node", "card": card, "nodes": c["nodes"],
           "txn_per_block": c["txn_per_block"], "transfers": c["transfers"],
           "senders": c["senders"], "udp": c["udp"],
           "warm_store_s": round(warm_s, 3), "warm_store": warm,
           "card_wall_s": card_run["wall_s"],
           **{k: card_run[k] for k in (
               "start_s", "send_s", "mine_s", "heights",
               "last_transfer_block", "common_height", "heads_equal",
               "geec_on_chain", "elections_won",
               "send_to_receipt_p50_s", "send_to_receipt_max_s")},
           "per_node": nodes,
           "trace": {"state": trace.get("state"), "kernels": trace_kernels,
                     "windows": c["trace_windows"]},
           "twin": {k: twin[k] for k in (
               "wall_s", "start_s", "send_s", "mine_s", "heights",
               "last_transfer_block", "geec_on_chain", "elections_won",
               "send_to_receipt_p50_s", "send_to_receipt_max_s")},
           "launches": {k: v for k, v in launches.items() if v}}
    out["wall_s"] = round(time.monotonic() - t0, 3)
    emit(out)
    per = c["transfers"] // c["senders"]
    for run in (card_run, twin):
        if run["statuses"] != ["0x1"]:
            raise AssertionError(f"node: transfer receipts with status "
                                 f"{run['statuses']}")
        if any(ns != [per] * c["senders"] for ns in run["nonces"]):
            raise AssertionError("node: a sender's nonce is not its "
                                 "transfers' count")
        if len({json.dumps(st) for st in run["state"]}) != 1 \
                or not run["heads_equal"]:
            raise AssertionError("node: balances, nonces or the head at "
                                 f"height {run['common_height']} differ "
                                 "across nodes")
        if run["geec_on_chain"] < int(0.8 * c["udp"]):
            raise AssertionError(f"node: {run['geec_on_chain']} of "
                                 f"{c['udp']} UDP txns on chain")
    if card_run["mined"] != twin["mined"] or \
            card_run["state"][0] != twin["state"][0]:
        raise AssertionError("node: the native twin mined other transfers "
                             "or reached other balances")
    for nd in nodes:
        # rows of the traffic: the lifetime count holds the warm's too
        if not nd["traffic_rows"] or (nd["device_share"] or 0) <= 0.95 \
                or nd["host_diverted"] != 0 or nd["device_errors"] != 0 \
                or nd["device_name"] != name:
            raise AssertionError(f"node {nd['node']}: {nd}")
        b = nd["traffic_batches"]
        if not b or nd["traffic_launches"] != {
                k: v * b for k, v in FUSED_RECOVER_LAUNCHES.items()}:
            raise AssertionError(f"node {nd['node']}: launches "
                                 f"{nd['traffic_launches']} over {b} "
                                 "batches, want 18 a batch")
        # a node that finds the library another node has just written
        # opens it as a build-directory hit
        if nd["aot_compiles"] != 0 or (nd["library"], nd["aot_loads"]) \
                not in (("load", 1), ("build_dir", 0)):
            raise AssertionError(f"node {nd['node']}: the library was "
                                 "neither loaded from the artifact store "
                                 "nor found in the build directory")
    if warm["aot_compiles"] != 0 or not any(
            nd["aot_loads"] for nd in nodes):
        raise AssertionError("node: nvcc ran for the store, or no node "
                             "loaded the library from it")
    w = c["trace_windows"]
    if trace.get("state") != "captured" or \
            not 18 * w <= trace_kernels <= 18 * (w + 1):
        raise AssertionError(f"node: a trace armed for {w} windows holds "
                             f"{trace_kernels} kernels ({trace})")
    if out["wall_s"] > NODE_BUDGET_S:
        raise AssertionError(f"node: {out['wall_s']} s, over the "
                             f"{NODE_BUDGET_S} s budget")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from eges_tpu_torch.ops import build, kernels as K

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "clocks_max_sm_mhz": clock_hz / 1e6})
    info = phase_build()
    phase_sass(info["path"])
    rng = np.random.default_rng(SEED)
    records = phase_kernels(rng, dev, clock_hz, info["ptxas"])
    paths = {}
    paths["recover"], rows, slice_out = phase_slice(rng)
    phase_lanes(dev, clock_hz, info["ptxas"], rows)
    phase_e2e(rows)
    paths["sched"] = phase_sched(rows, slice_out, records, card)
    paths["verify"], r3, r4 = phase_verify()
    paths["keccak"] = phase_keccak(dev)
    phase_verify_e2e(r3, r4, dev)
    stacked = phase_stacked(rows, r4, dev)
    paths["stacked_recover"] = stacked["recover"]
    paths["stacked_verify"] = stacked["verify"]
    records.update(phase_tiling_kernels(dev, clock_hz, info["ptxas"]))
    paths.update(phase_tiling(rows, slice_out, r3, r4, dev))
    phase_tiling_ab(rows, r3, r4)
    paths["profile"] = phase_profile(dev)
    records.update(phase_profile_kernels(dev, clock_hz, info["ptxas"]))
    paths["analysis"] = phase_analysis(dev)
    paths["sim"] = phase_sim(card)
    paths["pow"] = phase_pow(card)
    paths["node"] = phase_node(card)
    root = os.path.dirname(os.path.abspath(__file__))
    kernels = []
    for name in K.KERNELS:
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        if not by_path:
            raise AssertionError(f"{name}: no path launched it")
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(build.CSRC / K.SOURCE_OF[name], root),
            "replaces": K.REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"), "ptxas": rec["ptxas"],
            **{k: rec[k] for k in ("twin_ms", "path_ms", "shapes", "cold_ms",
                                   "cold_bound_share", "stream_cold_ms")
               if k in rec}})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
