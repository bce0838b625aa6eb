"""Readings that the check's limits are set from, on the card at a cell's size.

    python3 gpbench/controls.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3] [--out <file.jsonl>] [--own-fit]

For every seed the cell's driver runs as a benchmark run does (a short
window of `--seconds`) and the check's numbers of the program are read;
for the control seeds the stand-ins are read too, each judged against the
float64 reference that follows it (`harness/train.py: controls`,
`harness/serve.py: controls`): the reference at TF32 in the program's
place and, for a training cell, the faults a training cell can have. One
JSON line per seed goes to standard output and to `--out`. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, *, seconds: float, control: bool, device: str,
             overrides=None, own_fit: bool = False) -> dict:
    """The program's numbers (`program`) for one seed and, with `control`,
    each stand-in's; with `own_fit` (serving drivers), the answers against
    the reference's own float64 caches too."""
    from gpbench.harness import manifest
    from gpbench.harness.window import Context

    cap: dict = {}
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                  t_start=time.perf_counter(), run_dir=os.path.join(ROOT, "build", "gpbench"),
                  overrides=overrides or {}, capture=cap)
    driver = manifest.load_driver(cell.traffic["driver"], cell.bench)
    out = driver.run(ctx)
    row = {"seed": seed, "checks": {c.name: c.value for c in out.checks},
           "e2e": out.e2e}
    extra = {"own_fit": True} if own_fit else {}
    row.update(driver.controls(cap, full=control, **extra))
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--own-fit", action="store_true",
                   help="serving cells: also read the answers against a float64 fit of "
                        "the reference's own caches (control seeds)")
    args = p.parse_args(argv)
    from gpbench.harness import device, manifest

    device.prepare_process()
    cell = manifest.find_cell(args.workload)
    device.require_cards(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(ctl - set(seeds)):
        row = readings(cell, seed, seconds=args.seconds, control=seed in ctl,
                       device="cuda", own_fit=args.own_fit and seed in ctl)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
