"""Data maker `token_regression`: sequences of token ids and a regression
target for a deep-kernel-learning cell.

n training and n_test held-out sequences of `seq` ids each, drawn i.i.d.
from a Zipf law of exponent `zipf` over the vocabulary (rank k has weight
k^-zipf; ranks are given to ids by a random permutation), so that a few ids
are frequent and routing over experts is uneven as it is on text. The
target is a fixed random smooth function of the bag of tokens: every id has
a random 16-vector, a sequence's bag is the mean of its ids' vectors, and
the target is a random-Fourier-feature function of the bag (1024 cosines),
standardised over the training split, plus Gaussian noise of standard
deviation `noise`. Everything comes from `data_seed`, on the device."""

from __future__ import annotations

import math

import torch

from gpbench.data import Draw, generator


def make(n: int, n_test: int, seq: int, vocab: int, zipf: float, noise: float,
         data_seed: int, device) -> Draw:
    """X: (n, seq) int64 training ids; y: (n,) fp32; pool: (n_test, seq)
    held-out ids."""
    g = generator(data_seed, device)
    f64 = dict(dtype=torch.float64, device=device)
    weights = torch.arange(1, vocab + 1, **f64) ** -zipf
    ids = torch.randperm(vocab, generator=g, device=device)
    total = (n + n_test) * seq
    ranks = torch.multinomial(weights, total, replacement=True, generator=g)
    tokens = ids[ranks].reshape(n + n_test, seq)
    emb = torch.randn((vocab, 16), generator=g, **f64)
    bag = emb[tokens].mean(1)                                  # (N, 16)
    feats = 1024
    W = torch.randn((feats, 16), generator=g, **f64) * math.sqrt(seq)
    b = 2.0 * math.pi * torch.rand((feats,), generator=g, **f64)
    a = torch.randn((feats,), generator=g, **f64) * math.sqrt(2.0 / feats)
    f = torch.cos(bag @ W.T + b) @ a
    f = (f - f[:n].mean()) / (f[:n].std(unbiased=False) + 1e-12)
    y = f + noise * torch.randn((n + n_test,), generator=g, **f64)
    return Draw(tokens[:n].contiguous(), y[:n].float(), tokens[n:].contiguous())
