"""Time the port's fused kernels (B1-B4) at their main-path shapes, with the
per-entry cost table and the compiled binaries' summary, on one GPU.

    python3 scripts/kernel_costs.py [--src DIR] [--out FILE]

`--src` is the `src/` directory whose `repro_torch` is measured (default:
this checkout's); its kernels are built from its own `kernels/csrc/` into
its own `build/kernels/`. So two trees are compared on one card in one call
by running this script once per tree, in turns (A, B, B, A). The
measurements are `chip_smoke.py`'s own functions:

- the build's ptxas registers, stack and spill and the SASS counts (LDL,
  STL, MUFU, BAR, the entry loop) of the fp32 instances at t-chunks 1 and
  16 (`binary_summary`);
- the per-entry cost table of B1 at (2^16, 2^16) for d in {2, 9} and the
  specs rbf, matern32, matern32 * wendland2 (`entry_cost_table`);
- B1 and B2 at (2^16, 2^16, 9, 1) and (2^17, 2^17, 9, 1), B3 at a ring
  step (2^17 x 2^17, t = 1 and 9) and B4 at the spatial path's shape
  (n = 2^18, tile 256, t = 1 and 9), each against its plain version
  (2e-4 of max|out|) and beside its bound.

Prints one JSON object as its last line and writes it to `--out` when given;
`--only-binary` stops after the binaries' summary.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--only-binary", action="store_true",
                    help="build and summarize the binaries; time nothing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_costs: no CUDA device available")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(f"[costs] {card}; src {args.src}")
    binary = cs.phase_build()
    if args.only_binary:
        print(json.dumps({"card": card, "src": args.src, "binary": binary}),
              flush=True)
        return {"binary": binary}
    costs = cs.entry_cost_table()

    components = (("matern32",),)
    scalars = torch.tensor([1.0, 1.0], dtype=torch.float32, device="cuda")
    dense = []
    for n in (1 << 16, 1 << 17):
        g = torch.Generator(device="cuda").manual_seed(7)
        X = torch.randn((n, 9), generator=g, device="cuda") / math.sqrt(9)
        v = torch.randn((n, 1), generator=g, device="cuda")
        r = torch.randn((n, 1), generator=g, device="cuda")
        for name, rows in cs.time_square(components, scalars, X, v, r).items():
            dense += [{"name": name, **row} for row in rows]
        del X, v, r
    ring, _ = cs.time_ring_step()
    Xf, _, _ = cs.make_spatial_field(cs.SPATIAL_N, seed=cs.DATA_SEED)
    b4, _ = cs.time_b4_spatial(Xf)
    result = {"card": card, "src": args.src, "binary": binary, "costs": costs,
              "dense": dense, "ring_step": ring, "b4": b4}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
