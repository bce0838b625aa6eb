"""Quickstart on the PyTorch port: train an exact GP with BBMM + partitioned
MVMs, predict, compare against the SGPR/SVGP baselines, then save the
posterior as a servable artifact and predict through the batched engine.

The counterpart of `examples/quickstart.py`, with the same data, configs
and baselines. It runs on the card unless it is given `--device cpu`:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

`main(argv)` returns the rows it prints (rmse, nll, train seconds per
method).
"""

import argparse
import time

import torch

from repro_torch.core.gp import ExactGP, ExactGPConfig, gaussian_nll, rmse
from repro_torch.core.sgpr import sgpr_precompute, sgpr_predict
from repro_torch.core.svgp import svgp_predict
from repro_torch.data.synthetic import make_regression_dataset
from repro_torch.device import resolve_device
from repro_torch.serve import (
    PredictionEngine, fit_posterior, load_artifact, save_artifact,
)
from repro_torch.train.gp_trainer import (
    GPTrainConfig, fit_exact_gp, fit_sgpr, fit_svgp,
)


def _row(name, mean, var, yt, secs, rows):
    rows[name] = {"rmse": float(rmse(mean, yt)),
                  "nll": float(gaussian_nll(mean, var, yt)), "seconds": secs}
    return rows[name]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    ap.add_argument("--artifact", default="artifacts/quickstart_torch",
                    help="directory for the servable posterior artifact")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # UCI-analogue regression data, the paper's 4/9-2/9-3/9 splits and
    # train-statistics whitening
    s = make_regression_dataset("bike", max_points=2400)
    X = torch.as_tensor(s.X_train, dtype=torch.float32, device=dev)
    y = torch.as_tensor(s.y_train, dtype=torch.float32, device=dev)
    Xt = torch.as_tensor(s.X_test, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(s.y_test, dtype=torch.float32, device=dev)
    print(f"dataset: bike-analogue n={X.shape[0]} d={X.shape[1]} on {dev}")
    rows = {}

    # --- exact GP (the paper) -------------------------------------------
    gp = ExactGP(ExactGPConfig(
        kernel="matern32",        # paper's kernel
        precond_rank=50,          # partial pivoted Cholesky (paper: 100 @ 1M)
        train_cg_tol=1.0,         # loose CG during training suffices (Sec. 3)
        pred_cg_tol=0.01,         # tight solves for prediction
        row_block=512,            # O(n) memory: rows per kernel partition
    ), device=dev)
    cfg = GPTrainConfig(pretrain_subset=800,   # paper: 10k subset pretraining
                        pretrain_lbfgs_steps=5, pretrain_adam_steps=5,
                        finetune_adam_steps=3)
    res = fit_exact_gp(gp, X, y, cfg=cfg, verbose=True, device=dev)
    # one-time precomputation as a servable PosteriorArtifact
    art = fit_posterior(gp.operator(X, res.params), y,
                        generator=torch.Generator(device=dev).manual_seed(0),
                        precond_rank=50, lanczos_rank=100)
    mean, var = gp.predict(X, Xt, res.params, art.cache())
    r = _row("exact", mean, var, yt, res.seconds, rows)
    print(f"exact GP  : rmse={r['rmse']:.4f} nll={r['nll']:.4f} "
          f"({r['seconds']:.1f}s train)")

    # --- the paper's baselines ------------------------------------------
    sp, _, secs = fit_sgpr("matern32", X, y, num_inducing=64, steps=50,
                           device=dev)
    c = sgpr_precompute("matern32", X, y, sp)
    ms, vs = sgpr_predict("matern32", Xt, sp, c)
    r = _row("sgpr", ms, vs, yt, secs, rows)
    print(f"SGPR m=64 : rmse={r['rmse']:.4f} nll={r['nll']:.4f} "
          f"({secs:.1f}s train)")

    vp, _, secs = fit_svgp("matern32", X, y, num_inducing=128, epochs=30,
                           batch=256, lr=0.03, device=dev)
    mv, vv = svgp_predict("matern32", Xt, vp)
    r = _row("svgp", mv, vv, yt, secs, rows)
    print(f"SVGP m=128: rmse={r['rmse']:.4f} nll={r['nll']:.4f} "
          f"({secs:.1f}s train)")

    # --- serving: save the artifact, restore, predict through the engine --
    path = save_artifact(args.artifact, art)
    engine = PredictionEngine(load_artifact(args.artifact, device=dev),
                              chunk_size=256, device=dev)
    t0 = time.time()
    mean_e, var_e = engine.predict(Xt)
    secs = time.time() - t0
    r = _row("engine", mean_e, var_e, yt, secs, rows)
    print(f"engine    : rmse={r['rmse']:.4f} nll={r['nll']:.4f} "
          f"({secs * 1e3:.0f} ms for {Xt.shape[0]} points, artifact={path})")
    return rows


if __name__ == "__main__":
    main()
