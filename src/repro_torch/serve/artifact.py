"""PosteriorArtifact — the one-time precomputation, made durable.

Everything prediction needs — hyperparameters, training inputs and targets,
the tight-tolerance mean cache, the Lanczos variance cache, the operator
configuration — as one versioned, CRC-checked artifact on the
`repro_torch.train.checkpoint` layout:

    <dir>/step_00000000/arrays.npz + MANIFEST.json + .COMPLETE

The format is the reference's version 3, byte for byte in its keys and
manifest: an artifact written by either package loads in the other, and
`artifact_digest` gives both the same content digest. A blocksparse
artifact records its sparsity plan in `meta["sparse_plan"]` (tile, margin,
fill, support, pairs, digest); the plan is a pure function of (kernel, X,
params), so load rebuilds it and checks the digest (plans and digests are
the same in both packages).
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.kernels_math import (
    GPParams,
    KernelParams,
    as_spec,
    params_map,
    params_skeleton,
    spec_from_json,
    spec_to_json,
)
from repro_torch.core.operators import OperatorConfig
from repro_torch.core.predcache import (
    PredictionCache,
    build_prediction_cache,
    build_variance_cache,
)
from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import (
    flatten_with_keys,
    load_checkpoint,
    save_checkpoint,
    to_numpy,
    tree_map_with_keys,
)

ARTIFACT_VERSION = 3
_STEP = 0  # artifacts are single-snapshot checkpoints


class PosteriorArtifact(NamedTuple):
    """Everything a PredictionEngine needs to serve an exact GP."""

    config: OperatorConfig
    params: GPParams | KernelParams
    X: torch.Tensor            # (n, d) training inputs
    y: torch.Tensor            # (n,) training targets
    mean_cache: torch.Tensor   # (n,) K_hat^{-1} (y - mu)
    var_Q: torch.Tensor        # (n, r) Lanczos basis
    var_T_chol: torch.Tensor   # (r, r) chol of the tridiagonal T
    solve_rel_residual: torch.Tensor  # mean-solve ||r|| / ||b||
    meta: dict                 # version + fit settings + diagnostics

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def lanczos_rank(self) -> int:
        return self.var_Q.shape[1]

    def cache(self) -> PredictionCache:
        return PredictionCache(self.mean_cache, self.var_Q, self.var_T_chol,
                               self.solve_rel_residual)


def fit_posterior(
    op,
    y,
    *,
    v0: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    precond_rank: int = 100,
    lanczos_rank: int = 128,
    pred_tol: float = 0.01,
    max_cg_iters: int = 400,
) -> PosteriorArtifact:
    """From an operator (hyperparameters fixed) to a servable artifact: the
    tight PCG mean solve plus the rank-r Lanczos pass, on the operator's
    device. `v0`/`generator` give the Lanczos start vector."""
    y = torch.as_tensor(y, device=op.device)
    cache = build_prediction_cache(
        op, y, v0=v0, generator=generator, precond_rank=precond_rank,
        lanczos_rank=lanczos_rank, pred_tol=pred_tol, max_cg_iters=max_cg_iters)
    meta = {
        "n": int(op.shape[0]),
        "d": int(op.X.shape[1]),
        "precond_rank": int(precond_rank),
        "lanczos_rank": int(cache.var_Q.shape[1]),
        "pred_tol": float(pred_tol),
        "max_cg_iters": int(max_cg_iters),
        "solve_rel_residual": float(torch.max(cache.solve_rel_residual)),
        "has_y": True,
    }
    return PosteriorArtifact(
        config=op.config, params=op.params, X=op.X, y=y,
        mean_cache=cache.mean_cache, var_Q=cache.var_Q,
        var_T_chol=cache.var_T_chol,
        solve_rel_residual=cache.solve_rel_residual, meta=meta)


def posterior_from_mean_cache(
    op,
    mean_cache,
    *,
    v0: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    y=None,
    lanczos_rank: int = 128,
    solve_rel_residual=None,
) -> PosteriorArtifact:
    """Artifact from an externally solved mean cache (the distributed
    engine's `make_mean_cache_solve`): only the r Lanczos MVMs run here, on
    the single-device operator `op`, so a mesh-solved posterior becomes
    servable without redoing the tight solve. Pass the training targets `y`
    to keep them in the artifact; without them the y slot is NaN-filled and
    `meta["has_y"]` is False."""
    Q, T_chol = build_variance_cache(op, v0=v0, generator=generator,
                                     lanczos_rank=lanczos_rank)
    mean_cache = torch.as_tensor(mean_cache, device=op.device)
    rel = torch.as_tensor(
        float("nan") if solve_rel_residual is None else solve_rel_residual,
        dtype=mean_cache.dtype, device=op.device)
    meta = {
        "n": int(op.shape[0]),
        "d": int(op.X.shape[1]),
        "lanczos_rank": int(Q.shape[1]),
        "solve_rel_residual": float(torch.max(rel)),
        "mean_cache_source": "external",
        "has_y": y is not None,
    }
    y_arr = (torch.as_tensor(y, device=op.device) if y is not None
             else torch.full((op.shape[0],), float("nan"),
                             dtype=mean_cache.dtype, device=op.device))
    return PosteriorArtifact(
        config=op.config, params=op.params, X=op.X, y=y_arr,
        mean_cache=mean_cache, var_Q=Q, var_T_chol=T_chol,
        solve_rel_residual=rel, meta=meta)


def _arrays_tree(artifact: PosteriorArtifact) -> dict:
    return {
        "params": artifact.params,
        "X": artifact.X,
        "y": artifact.y,
        "mean_cache": artifact.mean_cache,
        "var_Q": artifact.var_Q,
        "var_T_chol": artifact.var_T_chol,
        "solve_rel_residual": artifact.solve_rel_residual,
    }


def _config_dict(config: OperatorConfig) -> tuple[dict, object]:
    """(the config as the manifest holds it, without geom and plan; the
    plan)."""
    cfg = config._asdict()
    cfg.pop("geom")  # mesh geometry is a runtime choice, not state
    return cfg, cfg.pop("plan")


def artifact_digest(artifact: PosteriorArtifact) -> str:
    """sha256 over every array leaf's (path, shape, dtype, crc32) plus the
    static operator config — the reference's digest, so the same content
    gets the same digest in either package."""
    h = hashlib.sha256()
    for path, leaf in flatten_with_keys(_arrays_tree(artifact)):
        a = np.ascontiguousarray(to_numpy(leaf))
        h.update(path.encode())
        h.update(f"{a.shape}:{a.dtype}".encode())
        h.update(zlib.crc32(a.tobytes()).to_bytes(4, "little"))
    cfg, plan = _config_dict(artifact.config)
    if plan is not None:
        cfg["plan_digest"] = plan.digest
    if not isinstance(cfg["kernel"], str):
        cfg["kernel"] = spec_to_json(cfg["kernel"])
    h.update(json.dumps(cfg, sort_keys=True, default=str).encode())
    return h.hexdigest()


def save_artifact(directory: str, artifact: PosteriorArtifact) -> str:
    """Atomically persist the artifact; returns the snapshot path."""
    meta = dict(artifact.meta)
    meta["artifact_version"] = ARTIFACT_VERSION
    cfg, plan = _config_dict(artifact.config)
    if plan is not None:
        meta["sparse_plan"] = {
            "tile": plan.tile, "margin": plan.margin,
            "assume_sorted": bool((plan.perm[:-1] <= plan.perm[1:]).all()),
            "fill": plan.fill, "support": plan.support,
            "num_pairs": plan.num_pairs, "digest": plan.digest,
        }
    if not isinstance(cfg["kernel"], str):
        cfg["kernel"] = {"__kernel_spec__": spec_to_json(cfg["kernel"])}
    meta["operator_config"] = cfg
    if isinstance(artifact.params, KernelParams):
        meta["kernel_spec"] = spec_to_json(as_spec(artifact.config.kernel))
        meta["params_format"] = "kernel_params"
    else:
        meta["params_format"] = "gp_params"
    return save_checkpoint(directory, _STEP, _arrays_tree(artifact), meta)


def load_artifact(directory: str, *, device=None) -> PosteriorArtifact:
    """CRC-verified restore onto `device` (None = the card). The array
    template comes from the manifest, so no n/d/r knowledge is needed."""
    dev = resolve_device(device)
    manifest = _read_manifest(directory)
    meta = manifest["meta"]
    version = meta.get("artifact_version")
    if version != ARTIFACT_VERSION:
        raise ValueError(
            f"artifact version {version!r} under {directory} not supported "
            f"(this build reads version {ARTIFACT_VERSION}; re-run the fit)")
    zero = np.zeros(())
    if meta.get("params_format") == "kernel_params":
        params_tmpl = params_skeleton(spec_from_json(meta["kernel_spec"]))
    else:
        params_tmpl = GPParams(zero, zero, zero, zero)
    skeleton = {"params": params_tmpl, "X": zero, "y": zero, "mean_cache": zero,
                "var_Q": zero, "var_T_chol": zero, "solve_rel_residual": zero}
    arrays = manifest["arrays"]
    template = tree_map_with_keys(
        lambda key, _: np.zeros(arrays[key]["shape"], arrays[key]["dtype"]),
        skeleton)
    tree, _, meta = load_checkpoint(directory, template)
    tree = {k: (params_map(lambda a: torch.as_tensor(a, device=dev), v)
                if k == "params" else torch.as_tensor(v, device=dev))
            for k, v in tree.items()}
    cfg = dict(meta["operator_config"])
    cfg["geom"] = None
    cfg["plan"] = None
    if isinstance(cfg["kernel"], dict):
        cfg["kernel"] = spec_from_json(cfg["kernel"]["__kernel_spec__"])
    if meta.get("sparse_plan") is not None:
        from repro_torch.sparse import build_plan

        sp = meta["sparse_plan"]
        plan = build_plan(cfg["kernel"], tree["X"], tree["params"],
                          tile=int(sp["tile"]), margin=float(sp["margin"]),
                          assume_sorted=bool(sp.get("assume_sorted", False)))
        if plan.digest != sp["digest"]:
            raise ValueError(
                f"sparsity plan rebuilt from {directory} does not match the "
                f"manifest digest ({plan.digest[:12]} != {sp['digest'][:12]}):"
                f" artifact arrays and manifest disagree")
        cfg["plan"] = plan
    return PosteriorArtifact(
        config=OperatorConfig(**cfg), params=tree["params"], X=tree["X"],
        y=tree["y"], mean_cache=tree["mean_cache"], var_Q=tree["var_Q"],
        var_T_chol=tree["var_T_chol"],
        solve_rel_residual=tree["solve_rel_residual"], meta=meta)


def _read_manifest(directory: str) -> dict:
    path = os.path.join(directory, f"step_{_STEP:08d}")
    if not os.path.exists(os.path.join(path, ".COMPLETE")):
        raise FileNotFoundError(f"no complete artifact under {directory}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)
