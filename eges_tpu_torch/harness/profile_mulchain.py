"""Layout microbenchmark: 64 chained F_P multiplies in one kernel, on
the card.  The counterpart of ``harness/profile_mulchain.py``.

One launch, one output and a strict chain of dependent products, so
the time is the arithmetic's and the layout's, with no re-lay copy
around it:

* 1-D rows: ``[16, B]`` limb-major values, limb k of column c at
  ``[k, c]`` (``fp_mul_chain_pallas``, kernel #20a), at lane blocks of
  256 and 1024 threads;
* (8, 128) rows: ``[B/1024, 128, 128]`` rows8 tiles, limb k of row
  ``blk*1024 + s*128 + l`` at ``[blk, 8k + s, l]``
  (``fp_mul_chain_rows8``, kernel #20b).

On the TPU the question was whether full (8, 128) vregs beat 1-D rows;
on the H100 both layouts give each warp 128 contiguous bytes of a limb,
so the question is whether anything but the arithmetic differs.  At
B = 4096 a 1024-thread block layout fills only 4 of the card's 132 SMs;
``main(B=131072)`` fills them all.

Times are the host's wall time of a synchronized call (``profutil.timeit``,
the reference's protocol) and the card's alone (CUDA events).

Usage: ``python -m eges_tpu_torch.harness.profile_mulchain [B] [--seed S]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse

import numpy as np

from eges_tpu_torch.harness.profutil import (cuda_event_ms, header_line,
                                             timeit)

CHAIN = 64
LANES = (256, 1024)
NLIMBS = 16
REPS = 4            # timed calls of each variant


def _limbs(rng: np.random.Generator, shape, dev):
    """Random 16-bit limbs (relaxed encodings, values up to 2^256 - 1) as
    an int32 tensor on ``dev``."""
    import torch

    return torch.from_numpy(rng.integers(0, 2**16, shape, dtype=np.int64)
                            .astype(np.int32)).to(dev)


def main(B: int = 4096, rng: np.random.Generator | None = None,
         device=None) -> dict:
    """Time the chain in both layouts at ``B`` rows (a multiple of 1024);
    prints the reference's lines and returns ``{variant: {"ms",
    "ns_per_row_mul", "event_ms"}}`` (``event_ms`` on the card only)."""
    import torch

    from eges_tpu_torch import resolve_device
    from eges_tpu_torch.ops import kernels as K

    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    if B <= 0 or B % K.ROWS8_BLOCK:
        raise ValueError(f"B = {B}: must be a positive multiple of 1024")
    print(header_line(source="profile_mulchain", batch=B), flush=True)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else dev, " B =", B, " chain =", CHAIN, flush=True)
    out = {}

    def record(label, key, fn, *args):
        t = timeit(fn, *args, reps=REPS, device=dev)
        rec = {"ms": t * 1e3, "ns_per_row_mul": t / (CHAIN * B) * 1e9}
        if dev.type == "cuda":
            rec["event_ms"] = cuda_event_ms(fn, *args, reps=REPS, device=dev)
        out[key] = rec
        print(f"{label + ':':21s}{rec['ms']:8.3f} ms"
              f"  ({rec['ns_per_row_mul']:6.2f} ns/row-mul)"
              + (f"  card {rec['event_ms']:8.3f} ms" if "event_ms" in rec
                 else ""), flush=True)

    a1, b1 = (_limbs(rng, (NLIMBS, B), dev) for _ in range(2))
    for lane in LANES:
        record(f"1-D rows lane={lane}", f"lane{lane}",
               lambda a, b, lane=lane: K.fp_mul_chain_pallas(a, b, CHAIN,
                                                             lane), a1, b1)
    nb = B // K.ROWS8_BLOCK
    a8, b8 = (_limbs(rng, (nb, NLIMBS * 8, 128), dev) for _ in range(2))
    record("(8,128) rows", "rows8",
           lambda a, b: K.fp_mul_chain_rows8(a, b), a8, b8)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ns = ap.parse_args()
    main(ns.B, np.random.default_rng(ns.seed), ns.device)
