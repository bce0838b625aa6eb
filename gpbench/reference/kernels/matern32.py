"""Reference kernel `matern32`: an outputscale times the Matern-3/2 of the
distance over one lengthscale."""

from __future__ import annotations

import torch

from gpbench.reference import SQRT3, sigmoid, softplus

LEAVES = ("lengthscale", "outputscale")


def hyper(raw: dict) -> dict:
    return {"ls": softplus(raw["lengthscale"]), "scale": softplus(raw["outputscale"])}


def value(r, h: dict):
    a = SQRT3 * r / h["ls"]
    return h["scale"] * ((1.0 + a) * torch.exp(-a))


def derivs(r, h: dict, raw: dict) -> dict:
    a = SQRT3 * r / h["ls"]
    e = torch.exp(-a)
    dm_dls = a * a / h["ls"] * e
    return {"lengthscale": h["scale"] * dm_dls * sigmoid(raw["lengthscale"]),
            "outputscale": (1.0 + a) * e * sigmoid(raw["outputscale"])}


def prior_diag(h: dict) -> float:
    return h["scale"]
