"""What the benchmark takes from the program: its GP model, its
hyperparameter trees and its launch counters, built from a configuration.

The configuration gives the hyperparameters in constrained form (noise as
the noise variance, the floor included); the benchmark turns them into raw
leaves itself, rounds them to fp32 and hands the same values to the program
and to the reference.
"""

from __future__ import annotations

import math


def inv_softplus(y: float) -> float:
    return y + math.log(-math.expm1(-y))


def raw_leaves(cfg: dict) -> dict:
    """leaf name -> raw fp32-representable float, from cfg["hyperparameters"]."""
    import numpy as np

    hyp, floor = cfg["hyperparameters"], cfg["gp"]["noise_floor"]
    raw = {}
    for leaf in cfg["leaves"]:
        v = hyp[leaf]
        if leaf == "mean":
            r = v
        elif leaf == "noise":
            r = inv_softplus(v - floor)
        else:
            r = inv_softplus(v)
        raw[leaf] = float(np.float32(r))
    return raw


def gp_model(cfg: dict, device):
    from repro_torch.core.gp import ExactGP, ExactGPConfig

    g = cfg["gp"]
    return ExactGP(ExactGPConfig(
        kernel=g["kernel"], precond_rank=g["precond_rank"],
        num_probes=g["num_probes"], train_cg_tol=g["train_cg_tol"],
        train_max_cg_iters=g["train_max_cg_iters"],
        pred_cg_tol=g["pred_cg_tol"], pred_max_cg_iters=g["pred_max_cg_iters"],
        lanczos_rank=g["lanczos_rank"], noise_floor=g["noise_floor"],
        backend=g["backend"]), device=device)


def program_params(cfg: dict, raw: dict, device):
    """The program's params tree with the raw leaves, in its leaf order."""
    import torch
    from repro_torch.core.kernels_math import init_params_for, params_leaves, params_unflatten

    template = init_params_for(cfg["gp"]["kernel"], device=device)
    if len(params_leaves(template)) != len(cfg["leaves"]):
        raise ValueError("the configuration's leaves do not match the program's tree")
    return params_unflatten(template, [
        torch.tensor(raw[k], dtype=torch.float32, device=device)
        for k in cfg["leaves"]])


def raw_of(cfg: dict, params) -> dict:
    """leaf name -> float of a program params tree."""
    from repro_torch.core.kernels_math import params_leaves

    return {k: float(v) for k, v in zip(cfg["leaves"], params_leaves(params))}


def ref_kernel(cfg: dict, raw: dict):
    """The plain reference's kernel of the configuration at raw leaves
    `raw`: the kernel function file it names (`gp.reference_kernel`) under
    its benchmark folder's `reference/kernels/`."""
    import os

    from gpbench.reference import Kernel

    where = os.path.join(cfg["bench"], "reference", "kernels") if "bench" in cfg else None
    return Kernel(cfg["gp"]["reference_kernel"], raw, cfg["gp"]["noise_floor"], where)


def launches() -> dict:
    """The program's kernel launch counters, all kernels."""
    from repro_torch.kernels import kmvm
    from repro_torch.sparse import kmvm_sparse

    return {**kmvm.launch_counts, **kmvm_sparse.launch_counts}


def since(before: dict) -> dict:
    now = launches()
    return {k: now[k] - before.get(k, 0) for k in now}
