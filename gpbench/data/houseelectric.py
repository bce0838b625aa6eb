"""Data maker `houseelectric`: the analogue of the UCI HouseElectric set
that the program's `repro_torch.data.synthetic` draws (a correlated
three-component Gaussian mixture of inputs, a random-Fourier-feature target
near a Matern GP draw plus noise 0.1, splits 4/9 train, 2/9 val, 3/9 test,
whitened by the train split's statistics), written in torch so that it runs
on the card in a few large calls. The streams differ from the numpy
original."""

from __future__ import annotations

import math

import torch

from gpbench.data import Draw, generator


def make(n: int, d: int, data_seed: int, device) -> Draw:
    """n training rows of the d-dimensional analogue (N = 9 n / 4 points in
    all); the test split is the query pool."""
    g = generator(data_seed, device)
    f64 = dict(dtype=torch.float64, device=device)
    N = n * 9 // 4
    ncomp, feats = 3, 2048
    means = 1.5 * torch.randn((ncomp, d), generator=g, **f64)
    comp = torch.randint(0, ncomp, (N,), generator=g, device=device)
    scale = 0.3 + 0.9 * torch.rand((1, d), generator=g, **f64)
    X = torch.randn((N, d), generator=g, **f64) * scale + means[comp]
    ls = math.sqrt(d)
    half = feats // 2
    w_rbf = torch.randn((half, d), generator=g, **f64)
    # Student-t with 3 degrees of freedom: a normal over sqrt(chi2_3 / 3)
    chi2 = torch.sum(torch.randn((feats - half, d, 3), generator=g, **f64) ** 2, -1)
    w_t = torch.randn((feats - half, d), generator=g, **f64) / torch.sqrt(chi2 / 3.0)
    W = torch.cat([w_rbf, w_t]) / ls
    b = 2.0 * math.pi * torch.rand((feats,), generator=g, **f64)
    a = torch.randn((feats,), generator=g, **f64) * math.sqrt(2.0 / feats)
    y = torch.cat([torch.cos(X[i:i + 16384] @ W.T + b) @ a for i in range(0, N, 16384)]) \
        + 0.1 * torch.randn((N,), generator=g, **f64)
    perm = torch.randperm(N, generator=g, device=device)
    X, y = X[perm], y[perm]
    n_val = round(N * 2 / 9)
    Xtr, ytr = X[:n], y[:n]
    mu, sd = Xtr.mean(0), Xtr.std(0, unbiased=False) + 1e-8
    ymu, ysd = ytr.mean(), ytr.std(unbiased=False) + 1e-8
    return Draw(((Xtr - mu) / sd).float(), ((ytr - ymu) / ysd).float(),
                ((X[n + n_val:] - mu) / sd).float())
