"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips (in the `cuda` fixture, never at import) when
`torch.cuda.is_available()` is False. On a machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: the shared conftest imports JAX, which the port does not
need.) Tolerances: 2e-4 for fp32 and 5e-2 for bf16, relative to max|out|,
as the reference's kernel tests use; the kernel and its plain version differ
only in summation order. B5 (`kgrad`) has its own, stated at its tests.
"""

import os
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import kgrad, kmvm

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}

# (components, scalars in scalar_layout order)
SPECS = {
    "matern32": ((("matern32",),), [1.3, 1.0]),
    "rbf": ((("rbf",),), [0.8, 1.0]),
    "rq": ((("rq",),), [1.1, 1.0, 2.5]),
    "wendland2": ((("wendland2",),), [1.0, 0.05]),
    "0.5*rbf + matern32": ((("rbf",), ("matern32",)), [1.0, 1.0, 2.0, 0.6]),
}
SHAPES = (              # (m, n, d, t): ragged m and n, d in {9, 385}
    (100, 130, 9, 1),
    (257, 300, 9, 7),
    (64, 1000, 9, 128),
    (33, 700, 385, 2),
    (70, 90, 3, 130),   # t > 128: two column chunks
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


def _inputs(m, n, d, t, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    scale = 2.0 / np.sqrt(d)

    def arr(*shape, s=1.0):
        return torch.as_tensor(s * rng.standard_normal(shape),
                               dtype=torch.float32).to(device)

    Xi, Xj, V = arr(m, d, s=scale), arr(n, d, s=scale), arr(n, t)
    Vrow, R = arr(m, t), arr(m, t)
    return Xi.to(dtype), Xj.to(dtype), V.to(dtype), Vrow, R


def _rel_err(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_kmvm_kernel_matches_plain(cuda, spec, shape, dtype):
    components, scal = SPECS[spec]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, _, _ = _inputs(*shape, dtype, cuda)
    before = kmvm.launch_counts["kmvm"]
    out = kmvm.kmvm_fused(components, Xi, Xj, V, scalars)
    torch.cuda.synchronize()
    assert kmvm.launch_counts["kmvm"] == before + 1
    ref = kmvm.kmvm_plain(components, Xi, Xj, V, scalars)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("spec", ("matern32", "0.5*rbf + matern32"))
def test_kmvm_dots_kernel_matches_plain(cuda, spec, shape, dtype):
    components, scal = SPECS[spec]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, Vrow, R = _inputs(*shape, dtype, cuda)
    out, dots = kmvm.kmvm_fused_dots(components, Xi, Xj, V, Vrow, R, scalars)
    torch.cuda.synchronize()
    ref_out, ref_dots = kmvm.kmvm_dots_plain(components, Xi, Xj, V, Vrow, R,
                                             scalars)
    assert dots.shape == (4, shape[3])
    assert _rel_err(out, ref_out) <= TOL[dtype]
    for q in range(4):
        assert _rel_err(dots[q], ref_dots[q]) <= TOL[dtype], q


# the tile body across spec shapes: 1-4 factors, rq, a sum of products
BODY_SPECS = {
    "rq": ((("rq",),), [1.1, 1.0, 2.5]),
    "matern52 * rq": ((("matern52", "rq"),), [0.9, 1.2, 0.7, 1.5]),
    "matern12 * rbf * wendland2": ((("matern12", "rbf", "wendland2"),),
                                   [1.0, 1.0, 0.8, 0.05]),
    "rbf * matern32 * rq * wendland4": (
        (("rbf", "matern32", "rq", "wendland4"),),
        [1.0, 0.5, 1.0, 0.8, 2.0, 0.05]),
    "0.5*matern32*wendland2 + rbf*rq + matern12": (
        (("matern32", "wendland2"), ("rbf", "rq"), ("matern12",)),
        [0.5, 1.0, 0.05, 1.0, 0.7, 1.2, 3.0, 0.3, 1.0]),
}
# both feature stages (B4: DK = 4 for d <= 4, 16 above; B1-B3: DK = 8 for
# d <= 8, 16 above) and their ragged edges
BODY_DIMS = (1, 2, 3, 4, 5, 9, 16, 17, 385)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("t", (1, 9, 128))
@pytest.mark.parametrize("d", BODY_DIMS)
@pytest.mark.parametrize("spec", sorted(BODY_SPECS))
def test_tile_body_matches_plain_across_specs_and_d(cuda, spec, d, t, dtype):
    """B1, B2 and B3 (one tensor-core tile body) against their plain
    versions for specs of 1-4 factors and 1-3 components, d on both sides
    of each feature stage, ragged m and n, every t-chunk."""
    components, scal = BODY_SPECS[spec]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, Vrow, R = _inputs(130, 301, d, t, dtype, cuda, seed=d)
    out = kmvm.kmvm_fused(components, Xi, Xj, V, scalars)
    out2, dots = kmvm.kmvm_fused_dots(components, Xi, Xj, V, Vrow, R, scalars)
    acc = kmvm.kmvm_fused_chunk(components, Xi, Xj, V, scalars,
                                torch.zeros_like(out))
    torch.cuda.synchronize()
    ref = kmvm.kmvm_plain(components, Xi, Xj, V, scalars)
    ref2, ref_dots = kmvm.kmvm_dots_plain(components, Xi, Xj, V, Vrow, R,
                                          scalars)
    assert _rel_err(out, ref) <= TOL[dtype]
    assert _rel_err(out2, ref2) <= TOL[dtype]
    vr, r = Vrow.float(), R.float()
    terms = (ref2 * vr, r * vr, r * r, vr * vr)
    for q in range(4):
        if t == 1:
            # one column: a sum that may cancel to far below its terms is
            # held to the tolerance of its terms' magnitudes, the scale of
            # any fp32 sum's rounding
            err = float(torch.max(torch.abs(dots[q] - ref_dots[q])))
            assert err <= TOL[dtype] * float(torch.sum(torch.abs(terms[q]))), q
        else:
            assert _rel_err(dots[q], ref_dots[q]) <= TOL[dtype], q
    assert _rel_err(acc, ref) <= TOL[dtype]


def test_row_results_do_not_depend_on_launch_rows(cuda):
    """A row's result is bitwise the same in a 512-row and a 1024-row
    launch (the column split depends on n only) and in a 64-row launch (a
    served batch): a padded serving chunk and an unchunked call agree
    exactly."""
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, _, _ = _inputs(1024, 20000, 9, 128, torch.float32, cuda)
    for t in (1, 128):
        full = kmvm.kmvm_fused(components, Xi, Xj, V[:, :t].contiguous(), scalars)
        for rows in (512, 64):
            part = kmvm.kmvm_fused(components, Xi[:rows].contiguous(), Xj,
                                   V[:, :t].contiguous(), scalars)
            assert torch.equal(full[:rows], part), (t, rows)


def test_dots_rows_do_not_depend_on_launch_rows(cuda):
    """B2 as B1: a row's output is bitwise the same in a 64-, a 512- and a
    1024-row launch, and a launch repeated gives the same dots bit for bit
    (no atomics: per-tile partials summed in tile order)."""
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, Vrow, R = _inputs(1024, 20000, 9, 128, torch.float32, cuda)
    for t in (1, 9, 128):
        cols = [a[:, :t].contiguous() for a in (V, Vrow, R)]
        full, _ = kmvm.kmvm_fused_dots(components, Xi, Xj, cols[0], cols[1],
                                       cols[2], scalars)
        half, dots = kmvm.kmvm_fused_dots(
            components, Xi[:512].contiguous(), Xj, cols[0],
            cols[1][:512].contiguous(), cols[2][:512].contiguous(), scalars)
        again, dots2 = kmvm.kmvm_fused_dots(
            components, Xi[:512].contiguous(), Xj, cols[0],
            cols[1][:512].contiguous(), cols[2][:512].contiguous(), scalars)
        assert torch.equal(full[:512], half), t
        assert torch.equal(dots, dots2), t
        small, _ = kmvm.kmvm_fused_dots(
            components, Xi[:64].contiguous(), Xj, cols[0],
            cols[1][:64].contiguous(), cols[2][:64].contiguous(), scalars)
        assert torch.equal(full[:64], small), t


def test_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    """A CUDA tensor gets the kernel: the plain versions are never called."""
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(kmvm, "kmvm_plain", boom)
    monkeypatch.setattr(kmvm, "kmvm_dots_plain", boom)
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, Vrow, R = _inputs(40, 50, 9, 1, torch.float32, cuda)
    kmvm.kmvm_fused(components, Xi, Xj, V, scalars)
    kmvm.kmvm_fused_dots(components, Xi, Xj, V, Vrow, R, scalars)
    torch.cuda.synchronize()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, _, _ = _inputs(40, 50, 9, 1, torch.float32, cuda)
    with pytest.raises(ValueError):
        kmvm.kmvm_fused(components, Xi.double(), Xj.double(), V.double(), scalars)
    with pytest.raises(ValueError):
        kmvm.kmvm_fused(components, Xi, Xj.T.contiguous().T, V, scalars)
    with pytest.raises(ValueError):
        kmvm.kmvm_fused(components, Xi, Xj.cpu(), V, scalars)
    with pytest.raises(ValueError):
        kmvm.kmvm_fused(((("matern32",),) * 5), Xi, Xj, V,
                        torch.ones(10, device=cuda))


# ---------------------------------------------------------------------------
# B1/B2 at the autotuner's column splits (kernels.autotune)
# ---------------------------------------------------------------------------

SPLITS = (16, 32, 64, 128, 256, 0)   # autotune.DEFAULT_CANDIDATES


@pytest.mark.parametrize("t", (1, 9, 128))
@pytest.mark.parametrize("split", SPLITS)
def test_every_candidate_split_matches_plain_and_keeps_the_pins(cuda, split, t):
    """At each split the autotuner may pick: B1 and B2 against their plain
    versions; B2's out equals B1's bit for bit; a row's B1/B2 result is the
    same bit for bit in a 64-, a 512- and a 1024-row launch."""
    from repro_torch.kernels import autotune

    assert autotune.DEFAULT_CANDIDATES == SPLITS
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, Vrow, R = _inputs(1024, 20000, 9, t, torch.float32, cuda)
    out = kmvm.kmvm_fused(components, Xi, Xj, V, scalars, split)
    out2, dots = kmvm.kmvm_fused_dots(components, Xi, Xj, V, Vrow, R, scalars,
                                      split)
    torch.cuda.synchronize()
    ref, ref_dots = kmvm.kmvm_dots_plain(components, Xi, Xj, V, Vrow, R, scalars)
    assert _rel_err(out, ref) <= TOL[torch.float32]
    assert _rel_err(out2, ref) <= TOL[torch.float32]
    assert torch.equal(out, out2)
    for q in (0, 2, 3):   # <Kv, v>, <r, r>, <v, v>: no cancellation
        assert _rel_err(dots[q], ref_dots[q]) <= TOL[torch.float32], q
    for rows in (512, 64):
        part = kmvm.kmvm_fused(components, Xi[:rows].contiguous(), Xj, V,
                               scalars, split)
        part2, _ = kmvm.kmvm_fused_dots(
            components, Xi[:rows].contiguous(), Xj, V,
            Vrow[:rows].contiguous(), R[:rows].contiguous(), scalars, split)
        assert torch.equal(out[:rows], part), rows
        assert torch.equal(out[:rows], part2), rows


def test_autotuned_operator_sweeps_on_the_card_and_keeps_b2_equal_to_b1(
        cuda, tmp_path, monkeypatch):
    """A real sweep (CUDA-event timings of B1 + B2 at each candidate) into an
    empty cache; the pallas operator with autotune=True launches at the
    swept split: its MVM agrees with the default split's within the
    tolerance, and B2's product equals B1's bit for bit."""
    from repro_torch import obs
    from repro_torch.core.kernels_math import init_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    autotune.clear_memo()
    obs.registry().reset("autotune.")
    X, _, V, _, R = _inputs(8192, 8192, 9, 9, torch.float32, cuda)
    ops_ = {on: make_operator(OperatorConfig(kernel="matern32",
                                             backend="pallas", autotune=on),
                              X, init_params(noise=0.1, device=cuda),
                              device=cuda) for on in (False, True)}
    before = dict(kmvm.launch_counts)
    tuned = ops_[True].matvec(V)
    snap = obs.registry().snapshot()
    assert snap["autotune.sweeps"] == 1 and len(os.listdir(tmp_path)) == 1
    # each candidate: a warm-up and 3 timed launches of B1 and of B2
    n_cand = len(autotune.DEFAULT_CANDIDATES)
    assert kmvm.launch_counts["kmvm_dots"] - before["kmvm_dots"] == 4 * n_cand
    assert _rel_err(tuned, ops_[False].matvec(V)) <= TOL[torch.float32]
    out, _ = ops_[True].fused_matvec_dots(V, R)
    assert torch.equal(out, tuned)
    autotune.clear_memo()


# ---------------------------------------------------------------------------
# B3: the chunk-accumulate step (kmvm_fused_chunk)
# ---------------------------------------------------------------------------

CHUNKS = (             # (m, column chunk sizes): ragged m, 64..4096 columns
    (100, (64, 64, 128)),
    (257, (4096, 1000)),
    (33, (640, 77)),
)


def _chunk_walk(fn, components, Xi, Xj, V, scalars, sizes):
    acc = torch.zeros((Xi.shape[0], V.shape[1]), dtype=torch.float32,
                      device=Xi.device)
    j = 0
    for nc in sizes:
        out = fn(components, Xi, Xj[j:j + nc].contiguous(),
                 V[j:j + nc].contiguous(), scalars, acc)
        assert out is acc
        j += nc
    return acc


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("t", (1, 9, 128))
@pytest.mark.parametrize("case", CHUNKS, ids=lambda c: f"m{c[0]}-{'+'.join(map(str, c[1]))}")
@pytest.mark.parametrize("spec", ("matern32", "0.5*rbf + matern32"))
def test_kmvm_chunk_kernel_matches_plain(cuda, spec, case, t, dtype):
    components, scal = SPECS[spec]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    m, sizes = case
    Xi, Xj, V, _, _ = _inputs(m, sum(sizes), 9, t, dtype, cuda, seed=len(sizes))
    before = kmvm.launch_counts["kmvm_chunk"]
    out = _chunk_walk(kmvm.kmvm_fused_chunk, components, Xi, Xj, V, scalars, sizes)
    torch.cuda.synchronize()
    assert kmvm.launch_counts["kmvm_chunk"] == before + len(sizes)
    ref = _chunk_walk(kmvm.kmvm_chunk_plain, components, Xi, Xj, V, scalars, sizes)
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("t", (1, 9, 128))
def test_kmvm_chunk_walk_equals_one_b1_launch(cuda, t, dtype):
    """Chunks of whole 64-column tiles walked through the accumulator give
    the bits of one B1 launch over the same n <= 4096 columns at t > 1 (B1
    runs one column split there); at t = 1 the final 16-thread tree of each
    row regroups the sum, so a multi-chunk walk agrees within the tolerance
    and a single chunk bit for bit."""
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, _, _ = _inputs(300, 4096, 9, t, dtype, cuda, seed=5)
    full = kmvm.kmvm_fused(components, Xi, Xj, V, scalars)
    one = _chunk_walk(kmvm.kmvm_fused_chunk, components, Xi, Xj, V, scalars, (4096,))
    walk = _chunk_walk(kmvm.kmvm_fused_chunk, components, Xi, Xj, V, scalars,
                       (64, 1024, 2048, 960))
    torch.cuda.synchronize()
    assert torch.equal(one, full)
    if t > 1:
        assert torch.equal(walk, full)
    else:
        assert _rel_err(walk, full) <= TOL[dtype]


def test_cuda_tensor_never_reaches_chunk_plain(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(kmvm, "kmvm_plain", boom)
    monkeypatch.setattr(kmvm, "kmvm_chunk_plain", boom)
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, _, _ = _inputs(40, 50, 9, 3, torch.float32, cuda)
    acc = torch.zeros((40, 3), device=cuda)
    kmvm.kmvm_fused_chunk(components, Xi, Xj, V, scalars, acc)
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        kmvm.kmvm_fused_chunk(components, Xi, Xj, V, scalars, acc.double())
    with pytest.raises(ValueError):
        kmvm.kmvm_fused_chunk(components, Xi, Xj, V, scalars, acc[:, :2])


def test_serving_path_on_card_matches_cpu(cuda):
    """fit_posterior + PredictionEngine on the pallas backend: the card (the
    kernels) against the CPU (their plain versions), same inputs."""
    from repro_torch.core.kernels_math import init_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.serve import PredictionEngine, fit_posterior

    rng = np.random.default_rng(1)
    X = rng.standard_normal((700, 9)).astype(np.float32)
    y = np.sin(X @ rng.standard_normal(9)).astype(np.float32)
    v0 = rng.standard_normal(700).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        kmvm.reset_launch_counts()
        op = make_operator(OperatorConfig(kernel="matern32", backend="pallas"),
                           X, init_params(lengthscale=3.0, outputscale=1.0,
                                          noise=0.05), device=dev)
        art = fit_posterior(op, y, v0=torch.as_tensor(v0), precond_rank=50,
                            lanczos_rank=64, pred_tol=1e-4, max_cg_iters=200)
        eng = PredictionEngine(art, device=dev, chunk_size=256)
        mean, var = eng.predict(X[:300] + 0.1)
        out[str(dev)] = (mean.cpu(), var.cpu(), dict(kmvm.launch_counts))
    (m0, v0_, c0), (m1, v1, c1) = out["cpu"], out[str(cuda)]
    assert c0 == {"kmvm": 0, "kmvm_dots": 0, "kmvm_chunk": 0}
    assert c1["kmvm"] > 0 and c1["kmvm_dots"] > 0
    assert _rel_err(m1, m0) <= 1e-3
    assert _rel_err(v1, v0_) <= 1e-3


# ---------------------------------------------------------------------------
# B4: the block-sparse kernel (repro_torch.sparse.kmvm_sparse)
# ---------------------------------------------------------------------------

# spec -> constrained support radius (None: not compact, all-active plan)
B4_SPECS = {"matern32 * wendland2": 0.15, "wendland4": 0.2,
            "rbf * wendland2 + matern32 * wendland4": 0.15, "matern32": None}
B4_TILES = ((8, 517), (32, 1000), (64, 2093), (256, 5001))  # (tile, ragged n)


def _b4_problem(expr, radius, n, tile, t, dtype, device, seed=0):
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.kernels.ops import fused_pass_or_none
    from repro_torch.sparse import build_plan
    from repro_torch.sparse.blocksparse import fused_operands

    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2)).astype(np.float32)
    params = init_kernel_params(expr, lengthscale=0.2, radius=radius,
                                noise=0.3, device=device)
    plan = build_plan(expr, X, params, tile=tile)
    ppass = fused_pass_or_none(expr, params)
    Xs = torch.as_tensor(X[plan.perm], device=device)
    V = torch.as_tensor(rng.standard_normal((n, t)), dtype=torch.float32,
                        device=device)
    Xp, Vp, scalars = fused_operands(ppass, Xs, V, dtype)
    return (ppass.components, Xp, Vp, scalars,
            torch.as_tensor(plan.row_ptr, device=device),
            torch.as_tensor(plan.pair_cols, device=device), plan.tile)


@pytest.mark.parametrize("tile_n", B4_TILES, ids=lambda s: f"tile{s[0]}n{s[1]}")
@pytest.mark.parametrize("expr", sorted(B4_SPECS))
def test_blocksparse_kernel_matches_plain(cuda, expr, tile_n):
    """B4 against its plain version at t in {1, 9, 128}, fp32 and bf16; on
    the all-active plan of a non-compact spec also against B1."""
    from repro_torch.sparse import kmvm_sparse

    for t in (1, 9, 128):
        for dtype in (torch.float32, torch.bfloat16):
            comps, Xp, Vp, sc, rp, cols, tile = _b4_problem(
                expr, B4_SPECS[expr], tile_n[1], tile_n[0], t, dtype, cuda)
            before = kmvm_sparse.launch_counts["kmvm_blocksparse"]
            out = kmvm_sparse.kmvm_blocksparse(comps, Xp, Xp, Vp, sc, rp, cols,
                                               tile=tile)
            torch.cuda.synchronize()
            assert kmvm_sparse.launch_counts["kmvm_blocksparse"] == before + 1
            ref = kmvm_sparse.kmvm_blocksparse_plain(comps, Xp, Xp, Vp, sc, rp,
                                                     cols, tile=tile)
            assert out.shape == ref.shape and out.dtype == torch.float32
            assert _rel_err(out, ref) <= TOL[dtype], (t, dtype)
            if B4_SPECS[expr] is None:
                dense = kmvm.kmvm_fused(comps, Xp, Xp, Vp, sc)
                assert _rel_err(out, dense) <= TOL[dtype], (t, dtype)


@pytest.mark.parametrize("tile_n", B4_TILES, ids=lambda s: f"tile{s[0]}n{s[1]}")
def test_blocksparse_row_order_changes_no_bits(cuda, tile_n):
    """B4 launched longest row first (the plan's order) equals B4 launched
    in plan order (null) and on the identity permutation, bit for bit."""
    from repro_torch.sparse import kmvm_sparse

    for t in (1, 9, 128):
        for dtype in (torch.float32, torch.bfloat16):
            comps, Xp, Vp, sc, rp, cols, tile = _b4_problem(
                "rbf * wendland2 + matern32 * wendland4", 0.15, tile_n[1],
                tile_n[0], t, dtype, cuda, seed=t)
            order = kmvm_sparse.longest_row_first(rp.cpu().numpy())
            assert not np.array_equal(order, np.arange(order.size))
            runs = [kmvm_sparse.kmvm_blocksparse(
                comps, Xp, Xp, Vp, sc, rp, cols, tile=tile, row_order=o)
                for o in (torch.as_tensor(order, device=cuda), None,
                          torch.arange(order.size, dtype=torch.int32,
                                       device=cuda))]
            torch.cuda.synchronize()
            assert torch.equal(runs[0], runs[1]), (t, dtype)
            assert torch.equal(runs[0], runs[2]), (t, dtype)
    with pytest.raises(ValueError):
        kmvm_sparse.kmvm_blocksparse(comps, Xp, Xp, Vp, sc, rp, cols, tile=tile,
                                     row_order=torch.as_tensor(order[:-1],
                                                               device=cuda))
    with pytest.raises(ValueError):
        kmvm_sparse.kmvm_blocksparse(comps, Xp, Xp, Vp, sc, rp, cols, tile=tile,
                                     row_order=torch.as_tensor(order).long().to(cuda))


def test_blocksparse_rows_do_not_depend_on_zero_tiles(cuda):
    """A query row's cross-covariance is the same bits whatever extra
    (all-zero) column tiles its list holds: the engine's sorted chunks equal
    the unchunked call."""
    from repro_torch.sparse import kmvm_sparse

    comps, Xp, Vp, sc, rp, cols, tile = _b4_problem(
        "matern32 * wendland2", 0.15, 5001, 256, 1, torch.float32, cuda)
    Z = Xp[:64].contiguous()
    near = torch.unique(cols[:int(rp[1])]).to(torch.int32)
    every = torch.arange(-(-5001 // tile), dtype=torch.int32, device=cuda)
    a, b = (kmvm_sparse.kmvm_blocksparse(
        comps, Z, Xp, Vp, sc,
        torch.tensor([0, c.numel()], dtype=torch.int32, device=cuda), c,
        tile=tile, row_tile=64) for c in (near, every))
    assert near.numel() < every.numel()
    assert torch.equal(a, b)


def test_blocksparse_serving_launch_matches_plain(cuda):
    """B4 at the serving shape: cross_matvec's one launch for a sorted query
    chunk (64-row query tiles against 256-row plan tiles, query rows repeated
    per column segment) at t = 1 and t = 100, against the plain version on
    the same operands."""
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.sparse import kmvm_sparse, morton_order

    X, _ = _spatial(10000, 5)
    Z, _ = _spatial(1000, 6)
    Z = torch.as_tensor(Z[morton_order(Z)], device=cuda)
    op = make_operator(OperatorConfig(kernel="matern32 * wendland2",
                                      backend="blocksparse", row_block=256),
                       X, init_kernel_params("matern32 * wendland2",
                                             radius=0.15, device=cuda),
                       device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for t in (1, 100):
        V = torch.randn((10000, t), generator=g, device=cuda)
        args, kwargs = op.cross_launch_operands(Z, V)
        assert (kwargs["tile"], kwargs["row_tile"]) == (256, 64)
        assert args[1].shape[0] > 1024  # more than one column segment
        out = kmvm_sparse.kmvm_blocksparse(*args, **kwargs)
        torch.cuda.synchronize()
        ref = kmvm_sparse.kmvm_blocksparse_plain(*args, **kwargs)
        assert _rel_err(out, ref) <= TOL[torch.float32], t


def test_cuda_tensor_never_reaches_blocksparse_plain(cuda, monkeypatch):
    """A CUDA tensor gets B4 — through the wrapper and through the operator's
    matvec and cross_matvec: the plain versions are never called."""
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.sparse import kmvm_sparse

    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(kmvm_sparse, "kmvm_blocksparse_plain", boom)
    monkeypatch.setattr(kmvm, "kmvm_plain", boom)
    comps, Xp, Vp, sc, rp, cols, tile = _b4_problem(
        "matern32 * wendland2", 0.15, 1000, 32, 9, torch.float32, cuda)
    kmvm_sparse.kmvm_blocksparse(comps, Xp, Xp, Vp, sc, rp, cols, tile=tile)
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(700, 2)).astype(np.float32)
    op = make_operator(OperatorConfig(kernel="matern32 * wendland2",
                                      backend="blocksparse", row_block=64),
                       X, init_kernel_params("matern32 * wendland2",
                                             radius=0.2, device=cuda),
                       device=cuda)
    op.matvec(torch.ones((700, 3), device=cuda))
    op.cross_matvec(op.X[:50] + 0.01, torch.ones(700, device=cuda))
    torch.cuda.synchronize()


def _spatial(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(8, 2))
    X = (centers[rng.integers(0, 8, n)]
         + 0.04 * rng.standard_normal((n, 2))).astype(np.float32)
    y = (np.sin(6 * X[:, 0]) * np.cos(4 * X[:, 1])
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def test_sparse_training_on_card_matches_cpu(cuda):
    """Two warm-start engine steps + Adam on the blocksparse backend with
    the same injected probes: loss and hyperparameters on the card (B4)
    equal the CPU run (the plain version)."""
    from repro_torch.core.gp import ExactGPConfig
    from repro_torch.core.kernels_math import init_kernel_params, params_leaves
    from repro_torch.optim import adam_init, adam_update
    from repro_torch.sparse import build_plan
    from repro_torch.train.solver_state import WarmStartEngine

    X, y = _spatial(900, 0)
    probes = np.random.default_rng(1).standard_normal((900, 8)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        params = init_kernel_params("matern32 * wendland2", noise=0.3,
                                    radius=0.15, device=dev)
        plan = build_plan("matern32 * wendland2", X, params, tile=64)
        cfg = ExactGPConfig(kernel="matern32 * wendland2", precond_rank=20,
                            train_max_cg_iters=50, backend="blocksparse",
                            plan=plan).mll_config()
        engine = WarmStartEngine(cfg)
        state = adam_init(params)
        losses = []
        for _ in range(2):
            loss, _, g = engine.step(torch.as_tensor(X, device=dev),
                                     torch.as_tensor(y, device=dev), params,
                                     probes=torch.as_tensor(probes, device=dev))
            params, state = adam_update(params, g, state, 0.1)
            losses.append(float(loss))
        out[str(dev)] = (losses, [float(a) for a in params_leaves(params)])
    cpu, card = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-4, atol=1e-4)


def test_sparse_serving_on_card_matches_cpu(cuda):
    """fit_posterior + the Morton-sorting engine on the blocksparse backend:
    the card against the CPU run, same inputs and Lanczos start vector."""
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.serve import PredictionEngine, fit_posterior
    from repro_torch.sparse import kmvm_sparse

    X, y = _spatial(1500, 2)
    Z, _ = _spatial(300, 3)
    v0 = np.random.default_rng(4).standard_normal(1500).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        kmvm_sparse.reset_launch_counts()
        op = make_operator(
            OperatorConfig(kernel="matern32 * wendland2", backend="blocksparse",
                           row_block=64), X,
            init_kernel_params("matern32 * wendland2", noise=0.1, radius=0.15,
                               device=dev), device=dev)
        art = fit_posterior(op, y, v0=torch.as_tensor(v0), precond_rank=30,
                            lanczos_rank=48, pred_tol=1e-4, max_cg_iters=300)
        eng = PredictionEngine(art, device=dev, chunk_size=128)
        assert eng.sort_queries
        mean, var = eng.predict(Z)
        out[str(dev)] = (mean.cpu(), var.cpu(),
                         kmvm_sparse.launch_counts["kmvm_blocksparse"])
    (m0, v0_, c0), (m1, v1, c1) = out["cpu"], out[str(cuda)]
    assert c0 == 0 and c1 > 0
    assert _rel_err(m1, m0) <= 1e-3
    assert _rel_err(v1, v0_) <= 1e-3


@pytest.mark.parametrize("t", (1, 9))
def test_b1_b2_at_d960_on_pooled_backbone_features(cuda, t):
    """B2 (and B1) at d = 960, smollm-360m's width, on the mean-pooled
    hidden states of a backbone of that width cut to 2 layers, against the
    plain versions at the kernels' tolerance. The lengthscale is the
    features' median pairwise distance, so K is far from the identity: the
    off-diagonal part of K @ V must be at least 10x the tolerance, or the
    comparison could not see a wrong cross term or feature walk."""
    from repro_torch.core.dkl import pooled_features
    from repro_torch.core.kernels_math import init_params
    from repro_torch.kernels.ops import fused_pass_or_none
    from repro_torch.models import get_arch
    from repro_torch.models import init_params as lm_init_params

    cfg = get_arch("smollm-360m").reduced(n_layers=2, d_model=960)
    lm = lm_init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        torch.float32, cuda)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(1000, 32))
    with torch.no_grad():
        X = pooled_features(cfg, lm, tokens, device=cuda)
    assert X.shape == (1000, 960)
    ell = float(torch.pdist(X).median())
    ppass = fused_pass_or_none("matern32",
                               init_params(lengthscale=ell, device=cuda))
    Xs = (X / ppass.lengthscale).contiguous()
    scalars = torch.stack([torch.as_tensor(s, dtype=torch.float32, device=cuda)
                           for s in ppass.scalars])
    V, R = (torch.as_tensor(rng.standard_normal((1000, t)), dtype=torch.float32,
                            device=cuda) for _ in range(2))
    components = ppass.components
    out = kmvm.kmvm_fused(components, Xs, Xs, V, scalars)
    out2, dots = kmvm.kmvm_fused_dots(components, Xs, Xs, V, V, R, scalars)
    torch.cuda.synchronize()
    ref2, ref_dots = kmvm.kmvm_dots_plain(components, Xs, Xs, V, V, R, scalars)
    k0 = kmvm._epilogue(components, scalars, torch.zeros((1, 1), device=cuda))
    off_diag = ref2 - k0 * V
    assert float(off_diag.abs().max()) >= 10 * TOL[torch.float32] * float(ref2.abs().max())
    assert _rel_err(out, ref2) <= TOL[torch.float32]
    assert _rel_err(out2, ref2) <= TOL[torch.float32]
    terms = (ref2 * V, R * V, R * R, V * V)
    for q in range(4):
        err = float(torch.max(torch.abs(dots[q] - ref_dots[q])))
        if t == 1:  # one column: held to its terms' magnitudes, as above
            assert err <= TOL[torch.float32] * float(torch.sum(torch.abs(terms[q]))), q
        else:
            assert _rel_err(dots[q], ref_dots[q]) <= TOL[torch.float32], q


def test_serving_spans_stay_off_the_cards_timeline(cuda):
    """Two 4096-row requests through a MicroBatcher on a block-sparse engine
    (the benchmark's batcher settings), traced under `torch.profiler` with
    CUDA: no device-side event carries a program span's name, so the card's
    busy time counts device work only, and every host-only span is a host
    range of the profile at its JSONL stamp (one clock). The spans run on
    the batcher's thread, and the profiler records ranges of other threads
    than its own only with `profile_all_threads`."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.serve import (BatcherConfig, MicroBatcher, PredictionEngine,
                                   fit_posterior)

    X, y = _spatial(20000, 9)
    Z, _ = _spatial(4096, 10)
    kernel = "matern32 * wendland2"
    op = make_operator(OperatorConfig(kernel=kernel, backend="blocksparse", row_block=256),
                       X, init_kernel_params(kernel, lengthscale=0.2, radius=0.15,
                                             noise=0.1, device=cuda), device=cuda)
    art = fit_posterior(op, y, v0=torch.ones(20000, device=cuda), precond_rank=20,
                        lanczos_rank=32)
    engine = PredictionEngine(art, chunk_size=1024, device=cuda)
    config = BatcherConfig(max_batch=128, max_wait_ms=2.0, bucket_sizes=(16, 64, 128))
    with MicroBatcher(engine, config) as mb:
        mb.submit(Z).result(timeout=120)          # every kernel built
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            obs.enable_tracing(None)
            try:
                for _ in range(2):
                    mb.submit(Z).result(timeout=120)
                deadline = time.monotonic() + 30
                while mb.batches_run < 3 and time.monotonic() < deadline:
                    time.sleep(0.001)
                torch.cuda.synchronize()
            finally:
                obs.disable_tracing(snapshot_metrics=False)
    spans = [e for e in obs.drain_events() if e.get("ph") == "X" and "span_id" in e]
    kinds = {k[len("span."):]: v["kind"] for k, v in obs.registry().snapshot().items()
             if k.startswith("span.") and v["count"]}
    assert mb.batches_run == 3 and kinds["sparse_csr"] == "host"
    events = [(e.name(), "cuda" in str(e.device_type()).lower(), e.start_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()]
    assert any(dev for _, dev, _ in events)        # the card's timeline was traced
    assert not {n for n, dev, _ in events if dev} & set(kinds)
    host = {}
    for n, dev, start in events:
        if not dev:
            host.setdefault(n, []).append(start)
    host_spans = [e for e in spans if kinds[e["name"]] == "host"]
    assert {e["name"] for e in host_spans} == {
        "serve_batch_wait", "serve_assemble", "serve_scatter", "serve_morton_sort",
        "sparse_csr"}
    for e in host_spans:
        assert min(abs(e["ts"] - s) for s in host.get(e["name"], [float("inf")])) <= 500.0, e


# ---------------------------------------------------------------------------
# B5: the Eq. 2 backward's kernel (kernels.kgrad)
# ---------------------------------------------------------------------------

# (components, scalars in scalar_layout order): the kernel's (1, 1) and
# (2, 2) classes
KG_SPECS = {
    "matern32": ((("matern32",),), [1.0, 1.0]),
    "rbf": ((("rbf",),), [1.0, 1.0]),
    "matern12": ((("matern12",),), [1.0, 1.0]),
    "matern52": ((("matern52",),), [1.0, 1.0]),
    "rq": ((("rq",),), [1.0, 1.0, 2.5]),
    "wendland2": ((("wendland2",),), [1.0, 0.05]),
    "wendland4": ((("wendland4",),), [1.0, 0.05]),
    "0.5*rbf + matern32": ((("rbf",), ("matern32",)), [1.0, 1.0, 0.5, 0.6]),
    "matern32 * wendland2": ((("matern32", "wendland2"),), [1.0, 1.0, 0.05]),
    "rq * matern52 + matern12": ((("rq", "matern52"), ("matern12",)),
                                 [1.0, 1.0, 2.5, 0.7, 0.4, 1.3]),
}
KG_CASES = (  # (spec, n, d, t): the training shape, ragged n, d in {2, 9, 16},
    # t 1 and t 20 (two column passes); every spec at a ragged n
    *(("matern32",) + s for s in ((65536, 9, 9), (1000, 9, 9), (4097, 9, 9),
                                   (1000, 2, 9), (4097, 16, 9), (1000, 9, 1),
                                   (1000, 9, 20))),
    *((spec, 4097, 9, 9) for spec in KG_SPECS if spec != "matern32"),
)
KG_TOL = 1e-4


def _kg_inputs(n, d, t, device, seed=0):
    rng = np.random.default_rng(seed)

    def arr(*shape, s=1.0):
        return torch.as_tensor(s * rng.standard_normal(shape), dtype=torch.float32,
                               device=device)

    return arr(n, d, s=2.0 / np.sqrt(d)), arr(n, t), arr(n, t)


def _kg_scales(components, scal, want):
    """Each output's scale: a slot's own magnitude; for S0 and S1, the sum
    of the magnitudes of the slot sums they add (sum_c w_c |R_wc|, sum_cf
    w_c |R_qcf|), since two slots of opposite sign can cancel there."""
    out = want.abs().clone()
    out[0] = out[1] = 0.0
    s = 0
    for kinds in components:
        out[0] += scal[s] * want[2 + s].abs()
        s += 1
        for kind in kinds:
            out[1] += scal[s] * want[2 + s].abs()   # w_c |R_qcf| = q_cf |dq/dq_cf|
            s += 2 if kind == "rq" else 1
    return out


@pytest.mark.parametrize("case", KG_CASES, ids=lambda c: f"{c[0]}-n{c[1]}d{c[2]}t{c[3]}")
def test_kgrad_kernel_matches_plain(cuda, case):
    """B5 against its plain version run in fp64 on the same fp32 inputs.
    Tolerance 1e-4 of each output's scale (`_kg_scales`; a thousandth of
    the largest at least, for an output near zero): both sum in fp64, and
    the kernel's entries carry fp32 rounding (3xTF32 products, fp32
    epilogue), ~1e-7 of each term of a sum of zero-mean terms, which leaves
    ~1e-6 of the sum."""
    spec, n, d, t = case
    components, scal = KG_SPECS[spec]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    X, A, V = _kg_inputs(n, d, t, cuda)
    got = kgrad.kgrad_fused(components, X, A, V, scalars)
    torch.cuda.synchronize()
    want = kgrad.kgrad_plain(components, X.double(), A.double(), V.double(),
                             scalars.double())
    assert got.shape == want.shape == (2 + len(scal),)
    floor = 1e-3 * float(want.abs().max())
    scale = torch.clamp(_kg_scales(components, scal, want), min=floor)
    err = (got.double() - want).abs() / scale
    assert float(err.max()) <= KG_TOL, (got, want)


def test_kgrad_two_launches_give_the_same_bits(cuda):
    components, scal = KG_SPECS["0.5*rbf + matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    X, A, V = _kg_inputs(20000, 9, 9, cuda, seed=1)
    a = kgrad.kgrad_fused(components, X, A, V, scalars)
    b = kgrad.kgrad_fused(components, X, A, V, scalars)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_cuda_tensor_never_reaches_kgrad_plain(cuda, monkeypatch):
    """A CUDA tensor gets B5 (and its launch count moves, apart from
    kmvm.launch_counts); the wrapper raises on what the kernel does not
    take."""
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(kgrad, "kgrad_plain", boom)
    components, scal = KG_SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    X, A, V = _kg_inputs(300, 9, 9, cuda)
    kmvm.reset_launch_counts()
    before = kgrad.launches
    kgrad.kgrad_fused(components, X, A, V, scalars)
    torch.cuda.synchronize()
    assert kgrad.launches == before + 1
    assert sum(kmvm.launch_counts.values()) == 0
    with pytest.raises(ValueError):
        kgrad.kgrad_fused(components, X.double(), A.double(), V.double(), scalars)
    with pytest.raises(ValueError):
        kgrad.kgrad_fused(components, *_kg_inputs(300, 17, 9, cuda), scalars)
    with pytest.raises(ValueError):
        kgrad.kgrad_fused(components, X, A[:, :4].contiguous(), V, scalars)
    with pytest.raises(ValueError):   # three components: the autograd loop's
        kgrad.kgrad_fused(((("rbf",),) * 3), X, A, V, torch.ones(6, device=cuda))


def test_engine_step_fused_route_matches_autograd_on_card(cuda, monkeypatch):
    """One `WarmStartEngine` step on the card (pallas, matern32, 2^14 rows,
    d 9, 8 probes): the fused route's gradient against the autograd loop's
    on the same solves, within 1e-5 relative per leaf."""
    from repro_torch.core.kernels_math import init_params, params_leaves
    from repro_torch.core.mll import MLLConfig, eq2_route_counter
    from repro_torch.kernels import ops
    from repro_torch.train.solver_state import WarmStartEngine

    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.standard_normal((16384, 9)) / 3.0, dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(np.sin(X.cpu().numpy().sum(1)), dtype=torch.float32,
                        device=cuda)
    p = init_params(lengthscale=1.0, noise=0.05, device=cuda)
    cfg = MLLConfig(kernel="matern32", backend="pallas", precond_rank=50,
                    num_probes=8, cg_tol=1.0)

    def step():
        gen = torch.Generator(device=cuda).manual_seed(0)
        return params_leaves(WarmStartEngine(cfg).step(X, y, p, gen)[2])

    fused = eq2_route_counter("fused")
    before = fused.value
    got = step()
    assert fused.value == before + 1
    monkeypatch.setattr(ops, "kgrad_pass_or_none", lambda *args: None)
    want = step()
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)), (got, want)


def test_float64_pallas_backward_keeps_the_loop_on_card(cuda):
    """B5 computes in fp32, so a float64 X on the card keeps the autograd
    loop: the pallas operator's gradients are the partitioned operator's
    in float64 (the same loop; 1e-12 of the largest, far below fp32's
    ~1e-7); the same problem in float32 takes B5."""
    from repro_torch.core.kernels_math import init_params, params_leaves
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.kernels import kgrad

    rng = np.random.default_rng(3)
    X, A, V = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float64,
                               device=cuda) for s in ((1000, 9), (1000, 4), (1000, 4)))

    def grads(backend, dtype):
        op = make_operator(OperatorConfig(kernel="matern32", backend=backend),
                           X.to(dtype), init_params(lengthscale=1.3, noise=0.05,
                                                     dtype=dtype, device=cuda),
                           device=cuda)
        return op.routed_quad_form_grads(A.to(dtype), V.to(dtype), need_x=False)

    before = kgrad.launches
    gp, gx, route = grads("pallas", torch.float64)
    want, want_x, _ = grads("partitioned", torch.float64)
    assert (route, kgrad.launches) == ("autograd", before)
    for a, b in [*zip(params_leaves(gp), params_leaves(want)), (gx, want_x)]:
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-12 * float(b.abs().max()))
    assert grads("pallas", torch.float32)[2] == "fused"
    assert kgrad.launches == before + 1
