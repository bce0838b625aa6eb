"""A test's data maker: n points on a line with a sine target."""

import torch

from gpbench.data import Draw, generator


def make(n, data_seed, device):
    g = generator(data_seed, device)
    X = torch.rand((n, 1), generator=g, device=device)
    return Draw(X, torch.sin(6.0 * X[:, 0]), X[: n // 2].clone())
