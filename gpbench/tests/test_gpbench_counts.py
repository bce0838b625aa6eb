"""The benchmark's work counts against shapes worked by hand."""

from __future__ import annotations

import math

import pytest

from gpbench import counts

M32 = ("matern32",)


def test_epilogue_counts():
    # distance assembly 4, component weight and sum 2, per factor scale 1 + shape
    assert counts.epilogue_ops(M32) == 4 + 2 + 1 + 6
    assert counts.epilogue_ops(("matern32", "wendland2")) == 4 + 2 + (1 + 6) + (1 + 8)


def test_b1_prediction_chunk():
    """B1 at (1024, 2^16, d 9, t 128): 1024 * 65536 entries of 2*9 + 13 + 2*128."""
    m, n, d, t = 1024, 1 << 16, 9, 128
    flops = m * n * (18 + 13 + 256)
    assert counts.mvm_flops(M32, m, n, d, t) == flops
    nbytes = 4 * ((m + n) * d + n * t + m * t)
    assert counts.mvm_bytes(m, n, d, t) == nbytes
    assert counts.mvm_least_s(M32, m, n, d, t) == pytest.approx(
        max(flops / 495e12, nbytes / 3.35e12))
    assert flops / 495e12 > nbytes / 3.35e12   # bound by the operations


def test_b2_training_step():
    """B2 at (2^16, 2^16, 9, 9): the fused CG step reads its row view and
    residual and writes its (4, t) dots besides B1's operands."""
    n, d, t = 1 << 16, 9, 9
    flops = n * n * (18 + 13 + 18)
    nbytes = 4 * (2 * n * d + n * t + n * t + 2 * n * t + 4 * t)
    assert counts.mvm_flops(M32, n, n, d, t) == flops
    assert counts.mvm_bytes(n, n, d, t, dots=True) == nbytes
    assert counts.mvm_least_s(M32, n, n, d, t, dots=True) == pytest.approx(flops / 495e12)


def test_b4_from_a_small_plan():
    """B4's entries are the (query, point) pairs within the support radius,
    counted on a small set by hand."""
    import torch

    X = torch.tensor([[0.0, 0.0], [0.1, 0.0], [0.5, 0.5], [0.52, 0.5]])
    Z = torch.tensor([[0.05, 0.0], [0.51, 0.5], [0.9, 0.9]])
    inside = torch.cdist(Z, X) < 0.15
    pairs = int(inside.sum())
    assert pairs == 4
    fac = ("matern32", "wendland2")
    per = (2 * 2 + counts.epilogue_ops(fac) + 2 * 1)
    assert counts.mvm_flops(fac, 3, 4, 2, 1, entries=pairs) == pairs * per


def test_backward_and_precond_counts():
    n, d, t, k = 1000, 9, 9, 10
    assert counts.precond_flops(M32, n, d, k) == k * n * (18 + 13) + sum(
        2 * i * n + 2 * n for i in range(k))
    assert counts.backward_flops(M32, n, d, t, 3) == n * n * (18 + 13 + 3 * (4 + 40))
    assert counts.love_flops(5, 128) == 5 * (2 * 128 * 128 + 2 * 128)
    assert math.isclose(counts.least_s(495e12, 0), 1.0)
