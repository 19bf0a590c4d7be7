"""Per-kernel times on fresh content, on the card.  The counterpart of
``harness/profile_kernels2.py``.

Times ``fp_mul``, the three pows (inverse and square root mod P, inverse
mod N), ``point_table``, ``strauss_tab`` and ``keccak_block`` at B rows
(default 4096) through the port's wrappers, each call on never-repeated
random operands (``profutil.timeit_unique``, each call synchronized).
The reference's reason for fresh content (the TPU tunnel served repeat
content from a cache) does not apply on CUDA; the protocol stays so
that the numbers answer the same question.  The operands come from one
generator, seeded once and advanced.

Writes its JSON to the path given, never over the reference's
``KERNEL_PROFILE2.json`` in the repo root.

Usage: ``python -m eges_tpu_torch.harness.profile_kernels2 [B]
[--out PATH] [--seed S] [--device cuda|cpu]`` (default out
``build/kernel_profile2.json`` in the checkout).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from eges_tpu_torch.harness.profutil import REPO, header_line, timeit_unique

GLV_WINDOWS = 33
NLIMBS = 16


def main(B: int = 4096, out_path: str | None = None,
         rng: np.random.Generator | None = None, device=None) -> dict:
    """Prints a line per kernel, writes the JSON to ``out_path`` (default
    ``build/kernel_profile2.json``) and returns it."""
    import torch

    from eges_tpu_torch import resolve_device
    from eges_tpu_torch.ops import kernels as K
    from eges_tpu_torch.ops.bigint import N, P

    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    out_path = out_path or os.path.join(REPO, "build", "kernel_profile2.json")
    if os.path.realpath(out_path) == os.path.realpath(
            os.path.join(REPO, "KERNEL_PROFILE2.json")):
        raise ValueError("KERNEL_PROFILE2.json is the reference's artifact")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print(header_line(source="profile_kernels2", batch=B), flush=True)
    print("device:", name, " B =", B, flush=True)
    res = {"device": name, "batch": B}

    def u32(shape, high=2**16):
        """Random words below ``high`` as int32 with the same bits."""
        return torch.from_numpy(rng.integers(0, high, shape, dtype=np.int64)
                                .astype(np.uint32).view(np.int32)).to(dev)

    def limbs(n):
        # random 16-bit limbs: valid relaxed field encodings, never repeated
        return u32((n, NLIMBS))

    def timed(key, label, fn, gen, reps=6):
        t = timeit_unique(fn, gen, reps=reps, device=dev)
        res[key] = round(t * 1e3, 4)
        print(f"{label:13s} {t*1e3:8.3f} ms", flush=True)

    timed("fp_mul_ms", "fp_mul", K.fp_mul_pallas,
          lambda: (limbs(B), limbs(B)))
    for pname, e, m in (("inv_p", P - 2, "p"), ("sqrt_p", (P + 1) // 4, "p"),
                        ("inv_n", N - 2, "n")):
        timed(f"pow_{pname}_ms", f"pow_{pname}",
              lambda a, e=e, m=m: K.pow_mod_pallas(a, e, m),
              lambda: (limbs(B),))
    timed("point_table_ms", "point_table", K.point_table_pallas,
          lambda: (limbs(B), limbs(B)))

    def strauss_gen():
        dig = u32((GLV_WINDOWS, 8, B), 16)
        neg = u32((8, B), 2)
        tabs = [u32((16 * NLIMBS, B)) for _ in range(3)]
        return (dig, neg, *tabs)

    timed("strauss_tab_ms", "strauss_tab",
          lambda *a: K.strauss_tab(*a, B), strauss_gen, reps=4)
    timed("keccak_ms", "keccak", K.keccak_block_pallas,
          lambda: (u32((B, 34), 2**32),))

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=4096)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ns = ap.parse_args()
    main(ns.B, ns.out, np.random.default_rng(ns.seed), ns.device)
