"""The dry-run checks of `tests/test_torch_dryrun.py`, run in a process of
their own: they join a `fake` process group of 8 ranks (a (2, 4) and a
(2, 2, 2) mesh over it), which must be the process's only group. Usage:

    python tests/_torch_dryrun_worker.py <out.json> <out_dir>
    python tests/_torch_dryrun_worker.py <out.json> production

The second form counts the GP cells on the (16, 16) production mesh (a
fake group of 256 ranks). Writes a JSON object with one entry per check; the assertions run in the
test file. Imports torch and repro_torch only (no JAX).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import torch

torch.set_num_threads(1)

from repro_torch.configs.gp_exact_1m import CONFIG as GP  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import Mesh, init_fake_world  # noqa: E402
from repro_torch.launch.specs import Cell  # noqa: E402
from repro_torch.models import get_arch  # noqa: E402

FAMILIES = {"dense": "smollm-360m", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-130m", "hybrid": "hymba-1.5b",
            "encdec": "seamless-m4t-large-v2", "vlm": "qwen2-vl-7b"}
CELLS = {"train": (4, 64), "prefill": (4, 64), "decode": (4, 64)}
THREE_AXES = (("dense", "decode"), ("moe", "prefill"))   # also on (2, 2, 2)


def mlp_check(mesh) -> dict:
    """A column- then row-parallel MLP, x batch-sharded over data: each
    device runs 1/8 of the global FLOPs; a replicated matmul runs all of
    its FLOPs; the row-parallel output needs one all-reduce."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dm = mesh.device_mesh
    b, d, f = 64, 128, 256
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(b, d), dm, [Shard(0), Replicate()],
                              src_data_rank=None)
        w1 = distribute_tensor(torch.empty(d, f), dm, [Replicate(), Shard(1)],
                               src_data_rank=None)
        w2 = distribute_tensor(torch.empty(f, d), dm, [Replicate(), Shard(0)],
                               src_data_rank=None)

        def mlp():
            y = (x @ w1) @ w2
            return y.redistribute(dm, [Shard(0), Replicate()])

        sharded = dr.count_step(mlp)
        xr = torch.empty(b, d)
        w1r = torch.empty(d, f)
        replicated = dr.count_step(lambda: xr @ w1r)
    return {"flops": sharded["flops"], "global": 2.0 * 2 * b * d * f,
            "coll": sharded["coll"]["counts"], "comm": sharded["comm_counts"],
            "replicated_flops": replicated["flops"],
            "replicated_global": 2.0 * b * d * f}


def family_cells(mesh, mesh3) -> dict:
    out = {}
    for fam, arch in FAMILIES.items():
        cfg = get_arch(arch).reduced()
        for kind, (b, s) in CELLS.items():
            cell = Cell(arch, kind, kind, b, s)
            for name, m in (("2x4", mesh), ("2x2x2", mesh3)):
                if name == "2x2x2" and (fam, kind) not in THREE_AXES:
                    continue
                t0 = time.time()
                r = dr.run_lm_cell(arch, kind, m, cfg=cfg, cell=cell)
                ro = r["roofline"]
                out[f"{fam}/{kind}/{name}"] = {
                    "status": r["status"],
                    "finite": all(math.isfinite(ro[k]) for k in
                                  ("t_compute", "t_memory", "t_collective_wire")),
                    "positive": ro["flops"] > 0 and ro["bytes_accessed"] > 0,
                    "collectives": r["collectives"]["total"],
                    "seconds": round(time.time() - t0, 2)}
    return out


def extrapolation_check(mesh) -> dict:
    """`_extrapolate` from depths 1 and 2 against a full count at 4, per
    cell kind: the counters and the memory terms."""
    cfg = get_arch("smollm-360m").reduced()._replace(n_layers=4)
    out = {}
    for kind in CELLS:
        cell = Cell("smollm-360m", kind, kind, 4, 64)
        a = dr.count_lm_cell(cfg, cell, mesh, 1)
        b = dr.count_lm_cell(cfg, cell, mesh, 2)
        full = dr.count_lm_cell(cfg, cell, mesh, 4)
        ext = dr._extrapolate(a, b, 4)
        keys = ("flops", "bytes", "transcendentals")
        out[kind] = {
            "ext": {k: ext[k] for k in keys} | {"coll": ext["coll"]["total"]},
            "full": {k: full[k] for k in keys} | {"coll": full["coll"]["total"]},
            "ext_memory": ext["memory"], "full_memory": full["memory"],
            "grew": b["flops"] > a["flops"],
            "memory_grew": {k: b["memory"][k] > a["memory"][k]
                            for k in ("argument_bytes", "temp_bytes")}}
    return out


def gp_cells(mesh, out_dir) -> dict:
    small = GP._replace(n=4096, precond_rank=16)
    out = {}
    for kind in ("gp_train", "gp_predict"):
        r = dr.run_gp_cell(kind, mesh, gp_cfg=small)
        r["mesh"] = "2x4"
        dr._dump(out_dir, f"gp__{kind}", r)
        out[kind] = {"status": r["status"], "depth": r["depth"],
                     "flops": r["cost"]["flops"],
                     "finite": all(math.isfinite(r["roofline"][k]) for k in
                                   ("t_compute", "t_memory", "t_collective_wire")),
                     "counts": r["collectives"]["counts"]}
    try:
        dr.run_gp_cell("gp_train", mesh, gp_cfg=small, backend="pallas")
        out["pallas"] = "accepted"
    except ValueError as e:
        out["pallas"] = str(e)
    lm = dr.run_lm_cell("smollm-360m", "train", mesh,
                        cfg=get_arch("smollm-360m").reduced(),
                        cell=Cell("smollm-360m", "train", "train", 4, 64))
    lm["mesh"] = "2x4"
    dr._dump(out_dir, "lm__train", lm)
    return out


def production_gp_cells() -> dict:
    """Both GP cells at full size (n = 2^20) on the (16, 16) production
    mesh, as `--arch gp-exact-1m` counts them, with 65536-row blocks (the
    block size sets the number of tile ops, not the collectives): each
    cell's collective dict."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    return {kind: dr.run_gp_cell(kind, mesh,
                                 gp_cfg=GP._replace(row_block=1 << 16))["collectives"]
            for kind in ("gp_train", "gp_predict")}


def main():
    out_json = sys.argv[1]
    if sys.argv[2] == "production":
        with open(out_json, "w") as f:
            json.dump(production_gp_cells(), f)
        return
    out_dir = sys.argv[2]
    os.makedirs(out_dir, exist_ok=True)
    init_fake_world(8)
    mesh = Mesh((2, 4), ("data", "model"), device=torch.device("cpu"))
    mesh3 = Mesh((2, 2, 2), ("pod", "data", "model"), device=torch.device("cpu"))
    res = {"mlp": mlp_check(mesh), "families": family_cells(mesh, mesh3),
           "extrapolation": extrapolation_check(mesh),
           "gp": gp_cells(mesh, out_dir)}
    with open(out_json, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
