"""Synthetic UCI-analogue regression datasets.

The paper's UCI tables are reproduced on *synthetic analogues*: draws from a ground-truth Matérn-like GP (via random
Fourier features — an exact GP draw is O(n^2) and unnecessary for benchmark
data) plus observation noise, matched to each UCI dataset's (n, d). The
reproduction target is the paper's *qualitative* claims (exact < approximate
RMSE, monotone subset-of-data curves, tolerance ablations), not the UCI
numbers themselves.

A copy of `repro.data.synthetic` (numpy only), so that the port imports
nothing of the reference package. One difference: the draw is seeded from a
CRC32 of the dataset name, not from Python's `hash`, which changes with
every process (PYTHONHASHSEED), so the same `(name, seed)` gives the same
arrays in every run. The two packages therefore draw different arrays for
the same name; tests hand one draw to both.

Splits follow the paper: 4/9 train, 2/9 val, 3/9 test, whitened to mean 0 /
std 1 as measured on the training split (targets too).
"""

from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np

# name -> (total points N such that train n matches Table 1, input dim d)
# Table 1 reports the TRAIN size n = (4/9) N.
DATASET_SPECS = {
    "poletele":      (21_600, 26),
    "elevators":     (23_902, 18),
    "bike":          (25_024, 17),
    "kin40k":        (57_600, 8),
    "protein":       (65_851, 9),
    "keggdirected":  (70_308, 20),
    "ctslice":       (77_040, 385),
    "keggu":         (91_593, 27),
    "3droad":        (626_218, 3),
    "song":          (742_095, 90),
    "buzz":          (839_880, 77),
    "houseelectric": (2_950_963, 9),
}


class RegressionSplits(NamedTuple):
    X_train: np.ndarray
    y_train: np.ndarray
    X_val: np.ndarray
    y_val: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray


def _rff_function(rng: np.random.Generator, d: int, num_features: int,
                  lengthscale: float):
    """A random function ~ GP(0, RBF(lengthscale)) via random Fourier features.

    Matérn spectra differ only in the frequency distribution (Student-t);
    we mix Gaussian and Student-t frequencies so the target is *near* but
    not *in* the model class (as with real data).
    """
    half = num_features // 2
    w_rbf = rng.normal(size=(half, d)) / lengthscale
    w_mat = rng.standard_t(df=3.0, size=(num_features - half, d)) / lengthscale
    W = np.concatenate([w_rbf, w_mat], 0)
    b = rng.uniform(0.0, 2.0 * np.pi, size=num_features)
    a = rng.normal(size=num_features) * np.sqrt(2.0 / num_features)

    def f(X, chunk=65536):
        out = np.empty(X.shape[0], np.float64)
        for s in range(0, X.shape[0], chunk):
            out[s:s + chunk] = np.cos(X[s:s + chunk] @ W.T + b) @ a
        return out

    return f


def make_regression_dataset(name: str, seed: int = 0, *,
                            noise_std: float = 0.1,
                            num_features: int = 2048,
                            max_points: int | None = None) -> RegressionSplits:
    """Build the analogue of a UCI dataset; splits + whitening per the paper.

    max_points caps N for CPU-friendly runs (the benchmark harness scales
    down; the full sizes are exercised via the dry-run ShapeDtypeStructs).
    """
    if name not in DATASET_SPECS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASET_SPECS)}")
    N, d = DATASET_SPECS[name]
    if max_points is not None:
        N = min(N, max_points)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2 ** 16))

    # inputs: correlated gaussian mixture (real UCI inputs are not isotropic)
    ncomp = 3
    means = rng.normal(scale=1.5, size=(ncomp, d))
    comp = rng.integers(0, ncomp, size=N)
    X = rng.normal(size=(N, d)) * rng.uniform(0.3, 1.2, size=(1, d)) + means[comp]

    f = _rff_function(rng, d, num_features, lengthscale=np.sqrt(d))
    y = f(X) + noise_std * rng.normal(size=N)

    perm = rng.permutation(N)
    X, y = X[perm], y[perm]
    n_train = round(N * 4 / 9)
    n_val = round(N * 2 / 9)
    splits = RegressionSplits(
        X_train=X[:n_train], y_train=y[:n_train],
        X_val=X[n_train:n_train + n_val], y_val=y[n_train:n_train + n_val],
        X_test=X[n_train + n_val:], y_test=y[n_train + n_val:],
    )
    return whiten_splits(splits)


def whiten_splits(s: RegressionSplits) -> RegressionSplits:
    """Mean-0/std-1 whitening with statistics from the TRAIN split (paper)."""
    mu, sd = s.X_train.mean(0), s.X_train.std(0) + 1e-8
    ymu, ysd = s.y_train.mean(), s.y_train.std() + 1e-8

    def wx(X):
        return ((X - mu) / sd).astype(np.float64)

    def wy(y):
        return ((y - ymu) / ysd).astype(np.float64)

    return RegressionSplits(wx(s.X_train), wy(s.y_train), wx(s.X_val),
                            wy(s.y_val), wx(s.X_test), wy(s.y_test))
