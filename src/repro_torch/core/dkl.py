"""Deep kernel learning — the GP engine as a head on backbone features.

The counterpart of `repro.core.dkl`. The MLL's autograd Function
(`core.mll._ExactMLL`) returns the Eq. 2 gradient with respect to its
inputs X as well as the hyperparameters, so an exact GP can sit on top of
any differentiable feature extractor phi: gradients reach phi's parameters
through `g_X`. For the LM backbones phi is the mean-pooled final hidden
state (`pooled_features`, for every family `models.forward_hidden` takes,
the port-only granitemoehybrid included); `mlp_apply` is a plain MLP for
standalone DKL regression. `train.gp_trainer.fit_dkl` trains the backbone
and the head together.

    loss(theta, phi_params) = -MLL( phi(X; phi_params), y, theta ) / n

Everything else (CG, preconditioner, caches) is unchanged: phi reshapes
the input space the kernel sees. `precompute` and `predict` run under the
caller's grad mode; call them under `torch.no_grad()` unless the result is
to be differentiated.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.model import forward_hidden
from .gp import ExactGP, ExactGPConfig
from .kernels_math import GPParams
from .predcache import PredictionCache


class MLPParams(NamedTuple):
    weights: tuple
    biases: tuple


def init_mlp(generator: torch.Generator | None, sizes: tuple,
             dtype=torch.float32, device=None) -> MLPParams:
    """sizes = (d_in, h1, ..., d_feat); He-normal weights from `generator`
    (None = a generator on the device seeded 0), zero biases."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    ws, bs = [], []
    for i in range(len(sizes) - 1):
        scale = math.sqrt(2.0 / sizes[i])
        ws.append(scale * torch.randn((sizes[i], sizes[i + 1]),
                                      generator=generator, dtype=dtype,
                                      device=dev))
        bs.append(torch.zeros((sizes[i + 1],), dtype=dtype, device=dev))
    return MLPParams(tuple(ws), tuple(bs))


def mlp_apply(params: MLPParams, X: torch.Tensor) -> torch.Tensor:
    """GeLU (the tanh approximation, `jax.nn.gelu`'s default) between
    layers, none after the last."""
    h = X
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        h = h @ w + b
        if i < len(params.weights) - 1:
            h = F.gelu(h, approximate="tanh")
    return h


class DKLModel(NamedTuple):
    """Exact GP over phi(x). phi_apply: (phi_params, X) -> features on the
    GP's device."""

    gp: ExactGP
    phi_apply: Callable

    def loss(self, X, y, phi_params, gp_params: GPParams, generator=None):
        resolve_device(self.gp.device)  # no card and no device: raise first
        feats = self.phi_apply(phi_params, X)
        value, aux = self.gp.mll(feats, y, gp_params, generator)
        return -value / feats.shape[0], aux

    def precompute(self, X, y, phi_params, gp_params, *, v0=None,
                   generator=None) -> PredictionCache:
        feats = self.phi_apply(phi_params, X)
        return self.gp.precompute(feats, y, gp_params, v0=v0,
                                  generator=generator)

    def predict(self, X, Xstar, phi_params, gp_params, cache, **kw):
        feats = self.phi_apply(phi_params, X)
        feats_star = self.phi_apply(phi_params, Xstar)
        return self.gp.predict(feats, feats_star, gp_params, cache, **kw)


def make_mlp_dkl(generator: torch.Generator | None, d_in: int,
                 feature_dim: int = 8, hidden: tuple = (64, 64),
                 config: ExactGPConfig | None = None, device=None):
    """Standalone MLP-featurized DKL regression model on `device` (None =
    the card): (model, phi_params)."""
    sizes = (d_in, *hidden, feature_dim)
    phi_params = init_mlp(generator, sizes, device=device)
    model = DKLModel(gp=ExactGP(config, device=device), phi_apply=mlp_apply)
    return model, phi_params


def pooled_features(cfg, lm, tokens, *, device=None) -> torch.Tensor:
    """Mean-pooled final hidden state of `lm` over (B, S) `tokens`: the
    (B, d_model) fp32 features the GP head sees. `device` (None = the card;
    raises when there is none) must be where `lm` lives."""
    dev = resolve_device(device)
    if lm.embed.device.type != dev.type:
        raise ValueError(f"the LM lives on {lm.embed.device}, not {dev}")
    h, _ = forward_hidden(cfg, lm, {"tokens": torch.as_tensor(tokens, device=dev)})
    return torch.mean(h.to(torch.float32), dim=1)
