"""What the dry run counts, op by op: one LM cell of `repro_torch.launch.
dryrun` on the (16, 16) fake mesh at depth 1 and 2, on the CPU.

    python3 scripts/dryrun_ops.py --arch smollm-360m --cells train_4k \
        [--out ops.json]

For each depth it writes the cell's totals (FLOPs, bytes, collectives),
the ops run on replicated operands (`fallbacks`), and per aten op its
calls, FLOPs and bytes; per matmul (mm / bmm / addmm) the local operand
shapes with their calls and FLOPs. Run it under two torch versions and
diff the files to see which ops DTensor shards differently. Prints one
line per (cell, depth).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

_MATMULS = ("aten.mm.default", "aten.bmm.default", "aten.addmm.default")


def main(argv=None):
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import cell_for
    from repro_torch.models import get_arch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--cells", default="train_4k")
    ap.add_argument("--out", default="build/dryrun_ops.json")
    args = ap.parse_args(argv)

    per_op: dict = {}
    per_mm: dict = {}
    count = dr.OpCounter._count

    def counted(self, func, fargs, kwargs, out):
        f0, b0 = self.flops, self.bytes
        count(self, func, fargs, kwargs, out)
        e = per_op.setdefault(str(func), [0, 0, 0])
        e[0] += 1
        e[1] += self.flops - f0
        e[2] += self.bytes - b0
        if str(func) in _MATMULS:
            key = str(func) + " " + " x ".join(
                str(tuple(a.shape)) for a in fargs if isinstance(a, torch.Tensor))
            m = per_mm.setdefault(key, [0, 0])
            m[0] += 1
            m[1] += self.flops - f0

    dr.OpCounter._count = counted
    mesh = make_production_mesh()
    cfg = get_arch(args.arch)
    res = {"torch": torch.__version__, "arch": args.arch}
    for shape in args.cells.split(","):
        cell = cell_for(cfg, shape)
        for depth in (1, 2):
            per_op.clear()
            per_mm.clear()
            r = dr.count_lm_cell(cfg, cell, mesh, depth)
            res[f"{shape}/{depth}"] = {
                "flops": r["flops"], "bytes": r["bytes"], "coll": r["coll"],
                "fallbacks": r["fallbacks"], "ops": dict(per_op),
                "matmuls": dict(per_mm)}
            print(f"{args.arch} {shape} depth {depth}: {r['flops']:.4e} FLOPs, "
                  f"{r['bytes']:.4e} bytes, {r['coll']['total']:.4e} collective "
                  f"bytes, fallbacks {r['fallbacks']} (torch {torch.__version__})",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
