"""The ingress perimeter facade — the blessed way to touch raw ingress.

The port's copy of ``eges_tpu/ingress/__init__.py``, unchanged but for
its imports.

Every function and handler that first receives attacker-controlled
bytes carries a ``# ingress-entry`` def-line mark (``:bounded`` when
the transport has already length-capped the frame).  Two analyses read
those marks as one source of truth: the taint pass seeds its lattice
from them, and the architecture pass (``harness/analysis/layers.py``,
rule ``perimeter-breach``) requires that

* every mark lives inside the declared perimeter modules
  (``harness/analysis/layermap.py``), and
* every marked name is registered in :data:`INGRESS_ENTRIES` below —
  the machine-checked inventory of the whole ingress surface, and
* no module outside the perimeter imports, calls, or takes a bound
  reference to a marked entry directly — outside callers go through
  the wrappers here.

This package is deliberately import-weightless: no eager imports, the
wrappers take the owning object as an argument (the columnar decoder
in :mod:`eges_tpu_torch.ingress.columnar` loads lazily through its own
wrappers below).  ROADMAP item 5's wire-speed ingest rebuild now lives
here: ``columnar.decode_window`` turns a whole gossip window of txn
frames into numpy-backed columns (sighash32 / sig65 / txhash /
gas_price / nonce) with O(1) Python-level transitions per window,
``TxPool.add_remotes_window`` admits it with set-op dedup and
per-window bookkeeping, and ``VerifierScheduler.submit_window`` takes
the rows in one lock hold — the legacy per-tx path stays for
singletons and as the differential-test oracle.
"""

from __future__ import annotations

# The complete ingress surface: every `# ingress-entry[:bounded]` mark
# in the tree, by leaf name.  The perimeter checker fails the gate
# when a mark exists that is not enumerated here (or vice versa a
# stale name lingers after the entry moved behind a new seam).
INGRESS_ENTRIES = frozenset({
    # consensus/node.py — datagram + txn entries (raw bytes)
    "on_gossip", "on_direct", "on_geec_txn",
    # consensus/node.py — RPC-worker admission (length-capped frames)
    "submit_txns", "broadcast_txns",
    # rpc/server.py — transport handlers (raw) and dispatch (bounded)
    "_handle_conn", "_handle_ws", "_handle_ipc",
    "dispatch", "_handle_body",
    # sim/simnet.py — simulated delivery into the node sinks
    "_fire_gossip", "_fire_direct",
    # core/txpool.py — the admission seam (validated, capped batches)
    "add_remotes", "add_locals", "add_remotes_window",
    # ingress/columnar.py — the wire-speed columnar decoders (frames
    # are transport-length-capped; oversized rows die pre-decode)
    "decode_window", "columns_from_txns",
})


# -- blessed wrappers ----------------------------------------------------
#
# Outside-perimeter callers hold a node / server / pool object and need
# a sink or a one-shot admission; they get it here instead of reaching
# for the marked methods directly.  Each wrapper is a single bound
# lookup — zero overhead, but the call site now names its intent and
# the perimeter checker can prove nothing else touches the surface.

def gossip_sink(node):
    """The node's gossip-datagram sink, for wiring into a transport
    (``simnet.join``, the UDP plane)."""
    return node.on_gossip


def direct_sink(node):
    """The node's direct-datagram sink (point-to-point frames)."""
    return node.on_direct


def txn_sink(node):
    """The node's raw-txn-payload sink (the geec txn gossip plane)."""
    return node.on_geec_txn


def submit_txns(node, txns) -> None:
    """RPC-worker txn submission into the consensus node (bounded:
    the RPC layer has already length-capped the batch)."""
    node.submit_txns(txns)


def broadcast_txns(node, txns) -> None:
    """RPC-worker txn broadcast through the consensus node."""
    node.broadcast_txns(txns)


def dispatch_rpc(server, method: str, params: list):
    """One RPC method dispatch on an in-process server object (the
    harness/bench path that skips the socket transport)."""
    return server.dispatch(method, params)


def admit_remotes(pool, txns) -> None:
    """Admit peer-origin transactions into a txpool (the validated,
    per-sender-capped seam)."""
    pool.add_remotes(txns)


def admit_locals(pool, txns) -> None:
    """Admit locally-submitted transactions into a txpool."""
    pool.add_locals(txns)


# -- wire-speed columnar ingest (ROADMAP item 5) -------------------------

def decode_txn_window(frames):
    """Decode a whole window of raw txn frames into columnar arrays
    (``ingress.columnar.TxColumns``): one canonical scan + one keccak
    per frame, sighash preimages sliced straight out of the frame
    bytes, ``Transaction`` construction deferred to admission time."""
    from eges_tpu_torch.ingress.columnar import decode_window

    return decode_window(frames)


def columns_of(txns):
    """Columns for already-decoded ``Transaction`` objects — the gossip
    relay path, where the codec decoded the bundle but admission should
    still run window-granular."""
    from eges_tpu_torch.ingress.columnar import columns_from_txns

    return columns_from_txns(txns)


def admit_remotes_window(pool, cols) -> None:
    """Admit one decoded columnar window into a txpool: one lock hold,
    set-op dedup, one batched verify call per ``max_batch`` rows —
    byte-identical admission outcomes to :func:`admit_remotes` over the
    same rows."""
    pool.add_remotes_window(cols)
