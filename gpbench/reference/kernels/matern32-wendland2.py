"""Reference kernel `matern32-wendland2`: the Matern-3/2 of the distance
over its lengthscale times the Wendland C2 taper over its radius, unit
outputscale; zero beyond the radius."""

from __future__ import annotations

import torch

from gpbench.reference import SQRT3, sigmoid, softplus

LEAVES = ("lengthscale", "radius")


def hyper(raw: dict) -> dict:
    return {"ls": softplus(raw["lengthscale"]), "radius": softplus(raw["radius"])}


def _w2(u):
    b = torch.clamp(1.0 - u, min=0.0)
    b2 = b * b
    return b2 * b2 * (4.0 * u + 1.0)


def value(r, h: dict):
    a = SQRT3 * r / h["ls"]
    return (1.0 + a) * torch.exp(-a) * _w2(r / h["radius"])


def derivs(r, h: dict, raw: dict) -> dict:
    a = SQRT3 * r / h["ls"]
    e = torch.exp(-a)
    m = (1.0 + a) * e
    dm_dls = a * a / h["ls"] * e
    u = r / h["radius"]
    b = torch.clamp(1.0 - u, min=0.0)
    # d/dR of (1-u)^4 (4u+1) with u = r/R: 20 u^2 (1-u)^3 / R
    dw_dR = 20.0 * u * u * b * b * b / h["radius"]
    return {"lengthscale": dm_dls * _w2(u) * sigmoid(raw["lengthscale"]),
            "radius": m * dw_dR * sigmoid(raw["radius"])}


def prior_diag(h: dict) -> float:
    return 1.0
