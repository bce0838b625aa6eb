"""The data generators: the same seed gives the same inputs, another seed
the same set in another order."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpbench import data

CFGS = {"he": {"data": {"maker": "houseelectric", "n": 512, "d": 9, "data_seed": 0}},
        "sp": {"data": {"maker": "spatial", "n": 1024, "data_seed": 0}}}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_draw_is_deterministic(name):
    a, b = data.make(CFGS[name], "cpu"), data.make(CFGS[name], "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.X.dtype == torch.float32 and a.X.shape[0] == CFGS[name]["data"]["n"]


@pytest.mark.parametrize("name", sorted(CFGS))
def test_seed_permutes_the_same_set(name):
    d = data.make(CFGS[name], "cpu")
    p1, p2 = data.permuted(d, 2**31 + 7), data.permuted(d, 2**31 + 8)
    assert torch.equal(p1.X, data.permuted(d, 2**31 + 7).X)
    assert not torch.equal(p1.X, p2.X)
    key = lambda X, y: sorted(map(tuple, torch.cat([X, y[:, None]], 1).tolist()))
    assert key(p1.X, p1.y) == key(d.X, d.y) == key(p2.X, p2.y)


def test_houseelectric_is_whitened():
    d = data.make(CFGS["he"], "cpu")
    assert torch.allclose(d.X.double().mean(0), torch.zeros(9, dtype=torch.float64), atol=1e-5)
    assert torch.allclose(d.X.double().std(0, unbiased=False), torch.ones(9, dtype=torch.float64),
                          atol=1e-4)
    assert d.pool.shape == (512 * 9 // 4 - 512 - round(512 * 9 // 4 * 2 / 9), 9)


def test_query_rows_per_seed_client_request():
    from gpbench.harness.manifest import load_part

    rows = load_part("queries", "pool_rows").rows
    pool = np.arange(40, dtype=np.float32).reshape(20, 2)
    a = rows(pool, 2**31 + 1, 3, 5, 16)
    assert np.array_equal(a, rows(pool, 2**31 + 1, 3, 5, 16))
    assert not np.array_equal(a, rows(pool, 2**31 + 1, 3, 6, 16))
    assert not np.array_equal(a, rows(pool, 2**31 + 1, 4, 5, 16))
    assert not np.array_equal(a, rows(pool, 2**31 + 2, 3, 5, 16))
    assert a.shape == (16, 2)
