"""A test's reference kernel: an outputscale times exp(-r^2 / 2 l^2)."""

import torch

from gpbench.reference import sigmoid, softplus

LEAVES = ("lengthscale", "outputscale")


def hyper(raw):
    return {"ls": softplus(raw["lengthscale"]), "scale": softplus(raw["outputscale"])}


def value(r, h):
    return h["scale"] * torch.exp(-0.5 * (r / h["ls"]) ** 2)


def derivs(r, h, raw):
    e = torch.exp(-0.5 * (r / h["ls"]) ** 2)
    return {"lengthscale": h["scale"] * e * r * r / h["ls"] ** 3 * sigmoid(raw["lengthscale"]),
            "outputscale": e * sigmoid(raw["outputscale"])}


def prior_diag(h):
    return h["scale"]
