"""The block-sparse kernel's launch order (longest row tile first).

`longest_row_first` orders a CSR's row tiles by descending degree, ties in
ascending row order; `SparsePlan.row_order` computes it once per plan, and
every launch of the block-sparse kernel gets the order of the CSR it runs
(the operator's plan, a query chunk's CSR, a rank's slice of the plan). The
order only schedules blocks, so the results equal the reference's: the
operator's matvec against `repro.sparse`'s operator on the same numpy
inputs, 2e-4 of the largest entry (the conformance tolerance for fp32).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperatorConfig as RefConfig
from repro.core import init_kernel_params as ref_init
from repro.core import make_operator as ref_make
from repro.core import parse_kernel as ref_parse
from repro.sparse import build_plan as ref_build_plan
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.interop import params_from_numpy
from repro_torch.sparse import blocksparse, build_plan, kmvm_sparse
from repro_torch.sparse.kmvm_sparse import longest_row_first

EXPR = "matern32 * wendland2"
TOL = 2e-4


def _clustered(n, seed=0):
    """Points in a few tight clusters, so row degrees differ widely."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(4, 2))
    X = centers[rng.integers(0, 4, n)] + 0.05 * rng.normal(size=(n, 2))
    return X.astype(np.float32)


def _params(radius=0.2):
    import jax

    p = ref_init(ref_parse(EXPR), lengthscale=0.3, radius=radius, noise=0.3,
                 dtype=jnp.float32)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _check_order(order, row_ptr):
    degree = np.diff(np.asarray(row_ptr))
    assert order.dtype == np.int32 and order.shape == degree.shape
    assert np.array_equal(np.sort(order), np.arange(degree.shape[0]))
    d = degree[order]
    assert np.all(d[:-1] >= d[1:])                     # non-increasing
    ties = d[:-1] == d[1:]
    assert np.all(order[:-1][ties] < order[1:][ties])  # stable


@pytest.mark.parametrize("seed", range(4))
def test_longest_row_first_is_a_stable_descending_permutation(seed):
    rng = np.random.default_rng(seed)
    degree = rng.integers(0, 6, size=50)  # many ties, some empty rows
    row_ptr = np.concatenate([[0], np.cumsum(degree)]).astype(np.int32)
    order = longest_row_first(row_ptr)
    _check_order(order, row_ptr)
    # the longest rows lead, ties keep ascending row order
    assert degree[order[0]] == degree.max()
    assert order[0] == int(np.argmax(degree))


def test_longest_row_first_edge_cases():
    assert longest_row_first(np.array([0], np.int32)).shape == (0,)
    np.testing.assert_array_equal(
        longest_row_first(np.array([0, 3, 6, 9], np.int32)), [0, 1, 2])
    np.testing.assert_array_equal(
        longest_row_first(np.array([0, 1, 3, 6], np.int32)), [2, 1, 0])


@pytest.mark.parametrize("tile", (8, 32))
def test_plan_row_order_is_computed_once(tile, monkeypatch):
    _, p = _params()
    plan = build_plan(EXPR, _clustered(300), p, tile=tile)
    calls = []
    real = kmvm_sparse.longest_row_first

    def counting(row_ptr):
        calls.append(1)
        return real(row_ptr)

    monkeypatch.setattr(kmvm_sparse, "longest_row_first", counting)
    first = plan.row_order
    _check_order(first, plan.row_ptr)
    assert np.diff(plan.row_ptr).min() < np.diff(plan.row_ptr).max()
    X = torch.as_tensor(_clustered(300))
    for _ in range(3):  # operators over one plan share its order
        op = make_operator(OperatorConfig(kernel=EXPR, backend="blocksparse",
                                          plan=plan), X, p, device="cpu")
        op.matvec(torch.ones(300))
    assert plan.row_order is first
    assert len(calls) == 1


def test_operator_launches_in_plan_row_order(monkeypatch):
    """The operator hands the plan's order to every launch; its matvec
    equals the reference operator's."""
    p_ref, p = _params()
    X = _clustered(400, seed=1)
    V = np.random.default_rng(2).normal(size=(400, 3)).astype(np.float32)
    seen = []
    real = blocksparse.kmvm_blocksparse

    def spy(*args, **kwargs):
        seen.append(kwargs.get("row_order"))
        return real(*args, **kwargs)

    monkeypatch.setattr(blocksparse, "kmvm_blocksparse", spy)
    port = make_operator(OperatorConfig(kernel=EXPR, backend="blocksparse",
                                        row_block=32), torch.as_tensor(X), p,
                         device="cpu")
    got = port.matvec(torch.as_tensor(V)).numpy()
    assert len(seen) == 1 and seen[0] is not None
    np.testing.assert_array_equal(seen[0].numpy(), port.plan.row_order)
    plan_ref = ref_build_plan(ref_parse(EXPR), jnp.asarray(X), p_ref, tile=32)
    ref = ref_make(RefConfig(kernel=ref_parse(EXPR), backend="blocksparse",
                             plan=plan_ref, interpret=True), jnp.asarray(X), p_ref)
    want = np.asarray(ref.matvec(jnp.asarray(V)), np.float64)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= TOL


def test_cross_and_rank_launches_carry_their_csr_order():
    """A query chunk's launch and a rank's slice of the plan each get the
    order of their own CSR."""
    _, p = _params()
    X = _clustered(300, seed=3)
    op = make_operator(OperatorConfig(kernel=EXPR, backend="blocksparse",
                                      row_block=8), torch.as_tensor(X), p,
                       device="cpu")
    Z = torch.as_tensor(X[:100] + 0.01)
    args, kwargs = op.cross_launch_operands(Z, torch.ones(300))
    _check_order(kwargs["row_order"].numpy(), args[5].numpy())
    plan = op.plan
    r1 = plan.num_tiles // 2
    ptr, _, order = blocksparse._rows_csr(plan, 0, r1, "cpu")
    _check_order(order.numpy(), ptr.numpy())
    for ptr, _, order in blocksparse._chunk_csrs(plan, 2, 0, r1, "cpu"):
        _check_order(order.numpy(), ptr.numpy())
