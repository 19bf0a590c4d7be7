"""CLI for the port's static-analysis gate.

Exit status is the gate: 0 only when every finding is waived or
baselined (and the baseline itself is well-formed), 1 on an unsuppressed
finding, 2 on a manifest or baseline error — as the JAX repo's
``python -m harness.analysis``.  Its ``--diff``, ``--github``,
``--sarif`` and ``--summary`` flags are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from eges_tpu_torch.harness.analysis import core


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m eges_tpu_torch.harness.analysis",
        description="AST static analysis of the port: launch-purity over "
                    "the code that enqueues kernels, the device-hygiene "
                    "pass (host-sync, transfer-hygiene, dtype-promotion) "
                    "over the verifier hot path, and the "
                    "architecture-conformance pass (layer-violation, "
                    "import-cycle, private-reach) against the declared "
                    "layer map.")
    ap.add_argument("paths", nargs="*", default=list(core.DEFAULT_PATHS),
                    help="directories/files to scan (default: "
                         "eges_tpu_torch chip_smoke.py)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: the checkout this package "
                         "is in)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON instead of text")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the checked-in baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite baseline.json from current unsuppressed "
                         "findings (justifications must then be filled in)")
    args = ap.parse_args(argv)

    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    rules = tuple(args.rules.split(",")) if args.rules else None
    baseline = None if args.no_baseline else core.DEFAULT_BASELINE

    try:
        report = core.run(root, tuple(args.paths), rules, baseline)
    except core.BaselineError as e:
        print(f"baseline error: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        core.save_baseline(core.DEFAULT_BASELINE, report.unsuppressed)
        print(f"wrote {len(report.unsuppressed)} entries to "
              f"{core.DEFAULT_BASELINE}; fill in the justifications.")
        return 0

    if args.as_json:
        print(json.dumps({"summary": report.summary_json(),
                          "findings": [f.as_json() for f in report.findings],
                          "stale_baseline": report.stale_baseline,
                          "errors": report.errors}, indent=2))
    else:
        for f in report.findings:
            print(f.render())
        for e in report.errors:
            print(f"error: {e}")
        for e in report.stale_baseline:
            print(f"stale baseline entry (no longer fires): "
                  f"[{e['rule']}] {e['path']} {e['symbol']}")
        for w in report.expiring_waivers:
            print(f"waiver expiring soon: {w['path']}:{w['line']} "
                  f"allow-{w['rule']} until={w['until']}")
        s = report.summary_json()
        print(f"{s['files']} files, {s['findings']} findings "
              f"({s['unsuppressed']} unsuppressed, {s['waived']} waived, "
              f"{s['baselined']} baselined) in {s['elapsed_s']}s")

    if report.errors:
        return 2
    return 1 if report.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
