"""obs_diff — gate BENCH JSONs against committed baselines.

    PYTHONPATH=src python -m repro_torch.launch.obs_diff <current> \
        [--baseline experiments/benchmarks] [--only a,b] \
        [--tol-scale 1.0] [--report out.md] [--json]

The counterpart of `repro.launch.obs_diff`, with its flags, output and exit
codes. `<current>` is a fresh `BENCH_<name>.json` file or a directory of
them. Each is matched by filename against the baseline directory and
diffed with the noise-aware schema in `repro_torch.obs.regress` (per-metric
direction + tolerance; one-sided, so faster/better never fails).

Exit codes: 0 = no regressions, 1 = at least one out-of-tolerance
regression, 2 = nothing could be compared at all (no overlapping BENCH
files — a misconfigured invocation must not pass silently).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.obs.regress import (
    compare_bench,
    diff_to_json,
    format_diff,
    load_bench,
)


def _collect(path: str) -> dict:
    """name -> path for a BENCH file or a directory of them."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "BENCH_*.json")))
    else:
        files = [path]
    out = {}
    for f in files:
        name = os.path.basename(f)
        if name.startswith("BENCH_") and name.endswith(".json"):
            out[name[len("BENCH_"):-len(".json")]] = f
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs_diff",
        description="Diff BENCH_<name>.json files against baselines "
                    "with a noise-aware tolerance schema")
    ap.add_argument("current",
                    help="BENCH json file or directory of fresh results")
    ap.add_argument("--baseline", default="experiments/benchmarks",
                    help="baseline directory (default: the committed "
                         "experiments/benchmarks)")
    ap.add_argument("--only", default=None,
                    help="comma-separated bench names to compare")
    ap.add_argument("--tol-scale", type=float, default=1.0,
                    help="multiply every tolerance (CI runners are a "
                         "different machine class than the baselines)")
    ap.add_argument("--report", default=None,
                    help="write the markdown report to this path "
                         "(the CI artifact)")
    ap.add_argument("--json", action="store_true",
                    help="print machine-readable JSON instead of markdown")
    args = ap.parse_args(argv)

    current = _collect(args.current)
    baseline = _collect(args.baseline)
    if args.only:
        keep = {s.strip() for s in args.only.split(",") if s.strip()}
        current = {k: v for k, v in current.items() if k in keep}

    results = []
    skipped = []
    for name, cur_path in sorted(current.items()):
        base_path = baseline.get(name)
        if base_path is None:
            skipped.append(f"{name}: no committed baseline — skipped")
            continue
        results.append(compare_bench(load_bench(base_path),
                                     load_bench(cur_path),
                                     tol_scale=args.tol_scale))

    report = format_diff(results, tol_scale=args.tol_scale)
    if skipped:
        report += "\n" + "\n".join(f"- note: {s}" for s in skipped) + "\n"
    if args.report:
        d = os.path.dirname(os.path.abspath(args.report))
        os.makedirs(d, exist_ok=True)
        with open(args.report, "w") as f:
            f.write(report)
    if args.json:
        payload = diff_to_json(results)
        payload["skipped"] = skipped
        print(json.dumps(payload, indent=1))
    else:
        print(report)

    if not results:
        print("obs_diff: nothing compared (no overlapping BENCH files)",
              file=sys.stderr)
        return 2
    n_reg = sum(len(r.regressions) for r in results)
    if n_reg:
        print(f"obs_diff: {n_reg} regression(s) out of tolerance",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
