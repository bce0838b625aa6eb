"""One phase of `chip_smoke.py` on two trees in turns (A, B, B, A, three
times) on one card, each run in a process of its own from its tree's root:

    python3 scripts/smoke_phase_ab.py <treeA> <treeB> [--phase 12|4] [--out ab.json]

Phase 12 (the default) is `phase_serve_lm` (the LM serving launcher per
family, which needs no kernel build); per run it prints and saves each
family's warm decode tokens/s, median decode step ms and prefill ms.
Phase 4 is the closed run of phase 4's `serve_gp` launcher (train, fit,
save, 200 requests x 8 points from 8 clients at n = 2^16); per run it
prints and saves p50 / p99 ms, QPS, and the training and precompute
seconds (each tree builds its kernels in its first run). Then the card's
name and power limit. A tree is a checkout, e.g. `git archive` of the
parent commit unpacked under `build/`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROUNDS = 3

_RUN = r"""
import json, os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(tree, "src"))
sys.path.insert(0, tree)
os.chdir(tree)
import chip_smoke
rows = chip_smoke.phase_serve_lm()["rows"]
keys = ("arch", "tokens_per_s", "step_ms_median", "prefill_ms", "tokens_per_s_first")
print("ROWS " + json.dumps([{k: r[k] for k in keys} for r in rows]), flush=True)
"""

_RUN_SERVE = r"""
import json, os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(tree, "src"))
sys.path.insert(0, tree)
os.chdir(tree)
import shutil
import chip_smoke
from repro_torch.launch import serve_gp
art = os.path.join(tree, "build", "ab_serve_artifact")
shutil.rmtree(art, ignore_errors=True)   # train every run, as phase 4 does
r = serve_gp.main(["--backend", "pallas", "--dataset", "houseelectric",
                   "--n", str(chip_smoke.N_TRAIN), "--seed", str(chip_smoke.DATA_SEED),
                   "--artifact", art, "--chunk", "1024", "--requests", "200",
                   "--points-per-request", "8", "--clients", "8", "--device", "cuda"])
keys = ("p50_ms", "p99_ms", "qps", "train_s", "precompute_s")
print("ROWS " + json.dumps([{k: r[k] for k in keys}]), flush=True)
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--phase", choices=("12", "4"), default="12")
    ap.add_argument("--out", default="chiprun_out/smoke_phase_ab.json")
    args = ap.parse_args(argv)
    code = _RUN if args.phase == "12" else _RUN_SERVE
    runs = []
    for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a) * ROUNDS:
        t0 = time.time()
        p = subprocess.run([sys.executable, "-c", code, tree], capture_output=True,
                           text=True, timeout=600)
        rows = [json.loads(line[5:]) for line in p.stdout.splitlines()
                if line.startswith("ROWS ")]
        print(tree, p.returncode, round(time.time() - t0, 1), rows,
              p.stderr[-1500:] if p.returncode else "", flush=True)
        runs.append({"tree": tree, "rc": p.returncode, "rows": rows})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "phase": args.phase, "runs": runs}, f, indent=1)
    if any(r["rc"] for r in runs):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
