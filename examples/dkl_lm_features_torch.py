"""Deep kernel learning over an LM backbone, on the PyTorch port: a
(reduced) smollm-360m backbone embeds token sequences; an exact GP head
regresses a sequence-level target; gradients flow through the MLL's Eq. 2
backward (its gradient with respect to the features) into the backbone.
The port of `examples/dkl_lm_features.py`, at its sizes.

    PYTHONPATH=src python examples/dkl_lm_features_torch.py          # the card
    PYTHONPATH=src python examples/dkl_lm_features_torch.py --cpu
"""

import argparse
import functools

import numpy as np
import torch

from repro_torch.core.dkl import DKLModel, pooled_features
from repro_torch.core.gp import ExactGP, ExactGPConfig, rmse
from repro_torch.core.kernels_math import params_leaves, params_map
from repro_torch.device import resolve_device
from repro_torch.models import get_arch, init_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    cfg = get_arch("smollm-360m").reduced(n_layers=2, d_model=32, vocab=128)
    lm = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.float32, device=dev)
    embed0 = lm.embed.detach().clone()

    # synthetic task: the target depends on token statistics the backbone
    # must learn to expose as features
    rng = np.random.default_rng(0)
    n, seqlen = 256, 32
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(n, seqlen)),
                             device=dev)
    y = torch.as_tensor(np.sin(tokens[:, ::4].cpu().numpy().mean(1) / 8.0)
                        + 0.05 * rng.normal(size=n), dtype=torch.float32,
                        device=dev)

    gp = ExactGP(ExactGPConfig(kernel="matern32", precond_rank=20,
                               row_block=128, train_max_cg_iters=30), device=dev)
    gp_params = params_map(lambda a: a.requires_grad_(),
                           gp.init_params(cfg.d_model, noise=0.2))
    model = DKLModel(gp, functools.partial(pooled_features, cfg, device=dev))
    opt = torch.optim.Adam(list(lm.parameters()) + params_leaves(gp_params),
                           lr=3e-3)

    losses = []
    for i in range(15):
        opt.zero_grad()
        loss, _ = model.loss(tokens, y, lm, gp_params,
                             torch.Generator(device=dev).manual_seed(i))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i % 5 == 0 or i == 14:
            print(f"step {i}: loss={losses[-1]:.4f}")

    with torch.no_grad():
        cache = model.precompute(tokens, y, lm, gp_params,
                                 generator=torch.Generator(device=dev).manual_seed(99))
        mean, _ = model.predict(tokens, tokens, lm, gp_params, cache)
    train_rmse = float(rmse(mean, y))
    print(f"train rmse={train_rmse:.4f} (target std={float(torch.std(y, correction=0)):.4f})")
    reached = bool(abs(float(lm.embed.detach().sum() - embed0.sum())) > 1e-6)
    print("gradients reached the backbone:", reached)
    return {"losses": losses, "train_rmse": train_rmse,
            "reached_backbone": reached}


if __name__ == "__main__":
    main()
