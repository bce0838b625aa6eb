"""Data maker `spatial`: the clustered 2-D sensor field of
`examples/spatial_gp.py` (32 station clusters on the unit square, sigma
0.03, a smooth latent surface plus noise 0.1); the query pool comes from the
same distribution."""

from __future__ import annotations

import torch

from gpbench.data import Draw, generator


def make(n: int, data_seed: int, device, pool: int = 1 << 16) -> Draw:
    """n training points of the clustered field and `pool` query points from
    the same distribution."""
    g = generator(data_seed, device)
    f64 = dict(dtype=torch.float64, device=device)
    centers = torch.rand((32, 2), generator=g, **f64)
    N = n + pool
    X = centers[torch.randint(0, 32, (N,), generator=g, device=device)] \
        + 0.03 * torch.randn((N, 2), generator=g, **f64)
    latent = (torch.sin(6.0 * X[:, 0]) * torch.cos(4.0 * X[:, 1])
              + 0.5 * torch.sin(9.0 * X[:, 0] * X[:, 1]))
    y = latent + 0.1 * torch.randn((N,), generator=g, **f64)
    return Draw(X[:n].float(), y[:n].float(), X[n:].float())
