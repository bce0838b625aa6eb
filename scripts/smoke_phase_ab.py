"""One phase of `chip_smoke.py` on two trees in turns (A, B, B, A, three
times) on one card, each run in a process of its own from its tree's root:

    python3 scripts/smoke_phase_ab.py <treeA> <treeB> [--out ab.json]

The phase is 12, `phase_serve_lm` (the LM serving launcher per family,
which needs no kernel build); per run it prints and saves each family's
warm decode tokens/s, median decode step ms and prefill ms, then the
card's name and power limit. A tree is a checkout, e.g. `git archive` of
the parent commit unpacked under `build/`.
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--out", default="chiprun_out/smoke_phase_ab.json")
    args = ap.parse_args(argv)
    runs = []
    for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a) * ROUNDS:
        t0 = time.time()
        p = subprocess.run([sys.executable, "-c", _RUN, tree], capture_output=True,
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
        json.dump({"card": card, "runs": runs}, f, indent=1)
    if any(r["rc"] for r in runs):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
