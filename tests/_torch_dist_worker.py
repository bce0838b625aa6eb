"""Rank programs for the distributed tests (gloo on the CPU).

`spawn(name, world, payload, tmp)` starts `world` processes with
`torch.multiprocessing.spawn`; each joins a gloo group through a `file://`
store under `tmp`, runs the function `name` of this module (or
`module:function` of another rank-program module) on the payload,
and saves what it returns to `tmp/out<rank>.pt`, which `spawn` loads and
returns in rank order. The assertions run in the parent (the test files).
This module imports torch and repro_torch only, so the ranks never load JAX.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(name: str, world: int, payload: dict, tmp) -> list:
    tmp = str(tmp)
    in_path = os.path.join(tmp, "in.pt")
    torch.save(payload, in_path)
    mp.spawn(_entry, args=(world, os.path.join(tmp, "store"), name, in_path,
                           tmp), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, world, store, name, in_path, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    try:
        if ":" in name:
            import importlib

            mod, _, fn = name.partition(":")
            fn = getattr(importlib.import_module(mod), fn)
        else:
            fn = globals()[name]
        out = fn(rank, torch.load(in_path, weights_only=False))
        torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy()


def world_cases(rank, p):
    """Every engine case on one mesh (see tests/test_torch_distributed.py)."""
    from repro_torch.core import distributed as D
    from repro_torch.core.kernels_math import params_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sparse import build_plan, dist_blocksparse_kmvm
    from repro_torch.train.solver_state import DistWarmStartEngine, WarmStartConfig

    mesh = make_mesh(p["shape"], ("data", "model"), device="cpu")
    out = {"groups": {axes: mesh.group_ranks(axes)
                      for axes in (("data",), ("model",), ("data", "model"))},
           "kmvm": {}, "pivchol": {}, "mll": {}, "solve": {}}
    params = p["params"]
    for n in (256, 250):
        X = torch.as_tensor(p["X"][:n])
        V = torch.as_tensor(p["V"][:n])
        y = torch.as_tensor(p["y"][:n])
        for mode in ("1d", "2d"):
            geom = D.make_geometry(mesh, n, X.shape[1], mode=mode, row_block=32)
            Xp = D.pad_to_geometry(geom, X)
            V_loc = D.shard_vector(mesh, geom, V)
            for backend in ("partitioned", "pallas"):
                cfg = D.DistMLLConfig(kernel="matern32", backend=backend)
                op = D.ShardedOperator(cfg.operator_config(geom), Xp, params)
                for overlap in (False, True):
                    o = D.dist_kmvm(
                        geom, "matern32", Xp, V_loc, params, overlap=overlap,
                        block_fn=D.slab_block_fn_for(backend, op.config, Xp.dtype),
                        acc_fn=D.slab_acc_fn_for(backend, op.config, Xp.dtype))
                    out["kmvm"][(n, mode, backend, overlap)] = _np(
                        D._all_gather(mesh, geom.all_axes, o))
                out["kmvm"][(n, mode, backend, "op")] = _np(
                    D._all_gather(mesh, geom.all_axes, op.matvec(V_loc)))
            L = D.make_dist_preconditioner(geom, "matern32", Xp, params, 40).L_local
            out["pivchol"][(n, mode)] = _np(D._all_gather(mesh, geom.all_axes, L))

            # the MLL value and Eq. 2 gradients, injected probes + precond
            cfg = D.DistMLLConfig(kernel="matern32", precond_rank=10,
                                  num_probes=8, max_cg_iters=100, cg_tol=1e-10)
            ref = p["mll"][n]
            pre = D.DistPreconditioner(
                L_local=D.shard_vector(mesh, geom, torch.as_tensor(ref["L"])),
                sigma2=torch.as_tensor(ref["sigma2"]),
                chol_inner=torch.as_tensor(ref["chol"]), n=n)
            probes = D.shard_vector(mesh, geom, torch.as_tensor(ref["probes"]))
            y_loc = D.shard_vector(mesh, geom, y)
            loss, aux, grads = D.make_mll_value_and_grad(mesh, geom, cfg)(
                Xp, y_loc, params, None, precond=pre, probes=probes)
            Xg = Xp.clone().requires_grad_(True)
            leaves = [a.clone().requires_grad_(True) for a in params_leaves(params)]
            value, _ = D.make_dist_mll(geom, cfg)(
                Xg, y_loc, type(params)(*leaves), None, precond=pre, probes=probes)
            (-value / n).backward()
            out["mll"][(n, mode)] = {
                "loss": float(loss), "logdet": float(aux[0]),
                "grads": [_np(a) for a in params_leaves(grads)],
                "grads_autograd": [_np(a.grad) for a in leaves],
                "g_X": _np(Xg.grad[:n]), "iters": _np(aux[2])}

            solve = D.make_mean_cache_solve(mesh, geom, cfg, tol=1e-10,
                                            max_iters=400)
            a, rel = solve(Xp, y_loc, params)
            out["solve"][(n, mode)] = (_np(a), _np(rel))

    # the collective micro-bench bodies on the 2-D layout
    geom = D.make_geometry(mesh, 256, p["X"].shape[1], mode="2d")
    v = D.shard_vector(mesh, geom, torch.as_tensor(p["V"]))
    fns = D.collective_bench_fns(mesh, geom)
    out["bench"] = {name: _np(fn(v)) for name, fn in fns.items()}
    out["bench_chunk"] = _np(v)

    # the warm-start engine: cold -> warm -> refresh on the padded 2-D layout
    n = 250
    geom = D.make_geometry(mesh, n, p["X"].shape[1], mode="2d", row_block=32)
    Xp = D.pad_to_geometry(geom, torch.as_tensor(p["X"][:n]))
    y_loc = D.shard_vector(mesh, geom, torch.as_tensor(p["y"][:n]))
    cfg = D.DistMLLConfig(kernel="matern32", precond_rank=10, num_probes=8,
                          max_cg_iters=100, cg_tol=1e-8)
    eng = DistWarmStartEngine(mesh, geom, cfg,
                              WarmStartConfig(refresh_every=2))
    steps = []
    for params_k, probes in zip(p["engine_params"], p["engine_probes"]):
        pr = None if probes is None else D.shard_vector(
            mesh, geom, torch.as_tensor(probes))
        loss, aux, g = eng.step(Xp, y_loc, params_k, probes=pr)
        steps.append({"loss": float(loss),
                      "grads": [_np(a) for a in params_leaves(g)]})
    out["engine"] = {"steps": steps, "telemetry": eng.telemetry}

    # a CPU-only group refuses an operator whose tensors lie elsewhere
    try:
        D.ShardedOperator(D.DistMLLConfig().operator_config(geom),
                          Xp.to("meta"), params)
        out["refuses_meta"] = False
    except ValueError as e:
        out["refuses_meta"] = "gloo" in str(e)

    # blocksparse on the sorted, padded spatial layout (tile 8)
    bs = p["blocksparse"]
    out["blocksparse"] = {}
    for mode in ("1d", "2d"):
        geom = D.make_geometry(mesh, bs["n"], 2, mode=mode, row_block=32,
                               tile_multiple=8)
        Xs = D.pad_to_geometry(geom, torch.as_tensor(bs["X"]))
        plan = build_plan(bs["kernel"], Xs, bs["params"], tile=8,
                          assume_sorted=True)
        V_loc = D.shard_vector(mesh, geom, torch.as_tensor(bs["V"]))
        for overlap in (False, True):
            o = dist_blocksparse_kmvm(geom, bs["kernel"], Xs, V_loc,
                                        bs["params"], plan, overlap=overlap)
            out["blocksparse"][(mode, overlap)] = _np(
                D._all_gather(mesh, geom.all_axes, o))
        cfg = D.DistMLLConfig(kernel=bs["kernel"], backend="blocksparse", plan=plan)
        op = D.ShardedOperator(cfg.operator_config(geom), Xs, bs["params"])
        out["blocksparse"][(mode, "op")] = _np(
            D._all_gather(mesh, geom.all_axes, op.matvec(V_loc)))
    return out


def ref_cases(rank, p):
    """The port's side of tests/test_torch_distributed_ref.py."""
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for n in (256, 250):
        X = torch.as_tensor(p["X"][:n])
        for mode in ("1d", "2d"):
            for overlap in (False, True):
                geom = D.make_geometry(mesh, n, X.shape[1], mode=mode,
                                       row_block=32, overlap=overlap)
                Xp = D.pad_to_geometry(geom, X)
                o = D.dist_kmvm(geom, "matern32", Xp,
                                D.shard_vector(mesh, geom, torch.as_tensor(p["V"][:n])),
                                p["params"])
                out[f"mvm_{n}_{mode}_{int(overlap)}"] = _np(
                    D._all_gather(mesh, geom.all_axes, o))[:n]
            cfg = D.DistMLLConfig(kernel="matern32", precond_rank=40)
            a, rel = D.make_mean_cache_solve(mesh, geom, cfg, tol=1e-10,
                                             max_iters=400)(
                Xp, D.shard_vector(mesh, geom, torch.as_tensor(p["y"][:n])),
                p["params"])
            out[f"solve_{n}_{mode}"] = _np(a)
    return out


def launcher(rank, p):
    """`repro_torch.launch.train.main` on this rank (the group is joined)."""
    from repro_torch.launch import train

    report = train.main(p["argv"])
    return {"losses": report["losses"], "n": report["n"],
            "n_padded": report["geom"].n_padded,
            "modes": [t["mode"] for t in report["telemetry"]]}


def obs_microbench(rank, p):
    """`obs.measure.collective_microbench` on a 2 x 1 mesh (the ring hop),
    a 1 x 2 mesh (the reduce-scatter) and the mesh it builds itself."""
    from repro_torch.core.distributed import make_geometry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.measure import collective_microbench

    out = {}
    for key, shape, axes, mode in (("ring", (2,), ("data",), "1d"),
                                   ("scatter", (1, 2), ("data", "model"), "2d")):
        mesh = make_mesh(shape, axes, device="cpu")
        geom = make_geometry(mesh, p["n"], 3, mode=mode)
        rows = collective_microbench(mesh, geom, num_rhs=p["t"], reps=3)
        out[key] = (rows, {"n": geom.n, "d_row": geom.d_row,
                           "d_col": geom.d_col, "n_local": geom.n_local})
    out["auto"] = [r["collective"] for r in collective_microbench(reps=2)]
    return out


def elastic_reshard(rank, p):
    """A (4, 1) run's host-canonical checkpoint restored onto a (2, 2) mesh
    (see tests/test_torch_trainer.py)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.elastic import reshard, validate_divisibility

    def pspec(path, leaf):
        return ("data", "model") if np.ndim(leaf) == 2 else ()

    mesh4 = make_mesh((4, 1), ("data", "model"), device="cpu")
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    state = reshard({"w": w, "step": torch.tensor(5)}, mesh4, pspec)
    full = {"w": state["w"].full_tensor(), "step": state["step"].full_tensor()}
    if rank == 0:
        save_checkpoint(p["dir"], 5, full)
    dist.barrier()

    mesh2 = make_mesh((2, 2), ("data", "model"), device="cpu")
    loaded, step, _ = load_checkpoint(p["dir"], full)
    problems = validate_divisibility(loaded, mesh2, pspec)
    placed = reshard(loaded, mesh2, pspec)
    return {"step": step, "problems": problems,
            "w4_local": _np(state["w"].to_local()),
            "w2_local": _np(placed["w"].to_local()),
            "w2_full": _np(placed["w"].full_tensor()),
            "placements": [str(pl) for pl in placed["w"].placements],
            "mesh_shape": tuple(placed["w"].device_mesh.shape),
            "bad": validate_divisibility({"v": np.zeros((3, 8))}, mesh2, pspec)}


def vector_layout(rank, p):
    """The engine's CG-vector layout on each mesh shape of the payload: the
    rank's `shard_vector` chunk, the same vector placed as a DTensor by
    `DistGeometry.vector_pspec()`, and the chunks gathered back over the
    spec's axes (see tests/test_torch_api_surface.py)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import placements

    out = {}
    for shape in p["shapes"]:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for mode in ("1d", "2d"):
            for n in p["ns"]:
                geom = D.make_geometry(mesh, n, 2, mode=mode)
                spec = geom.vector_pspec()
                y = torch.arange(geom.n_padded, dtype=torch.float64)
                chunk = D.shard_vector(mesh, geom, y)
                placed = distribute_tensor(y, mesh.device_mesh,
                                           placements(mesh, spec, 1))
                gathered = D._all_gather(mesh, spec[0], chunk)
                out[(tuple(shape), mode, n)] = {
                    "spec": spec, "all_axes": geom.all_axes,
                    "chunk": _np(chunk), "placed": _np(placed.to_local()),
                    "gathered": _np(gathered)}
    return out
