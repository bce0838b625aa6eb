"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips (in the `cuda` fixture, never at import) when
`torch.cuda.is_available()` is False. On a machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: the shared conftest imports JAX, which the port does not
need.) Tolerances: 2e-4 for fp32 and 5e-2 for bf16, relative to max|out|,
as the reference's kernel tests use; the kernel and its plain version differ
only in summation order.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import kmvm

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


def test_row_results_do_not_depend_on_launch_rows(cuda):
    """A row's result is bitwise the same in a 512-row and a 1024-row
    launch (the column split depends on n only): a padded serving chunk and
    an unchunked call agree exactly."""
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cuda)
    Xi, Xj, V, _, _ = _inputs(1024, 20000, 9, 128, torch.float32, cuda)
    for t in (1, 128):
        full = kmvm.kmvm_fused(components, Xi, Xj, V[:, :t].contiguous(), scalars)
        half = kmvm.kmvm_fused(components, Xi[:512].contiguous(), Xj,
                               V[:, :t].contiguous(), scalars)
        assert torch.equal(full[:512], half)


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
    assert c0 == {"kmvm": 0, "kmvm_dots": 0}
    assert c1["kmvm"] > 0 and c1["kmvm_dots"] > 0
    assert _rel_err(m1, m0) <= 1e-3
    assert _rel_err(v1, v0_) <= 1e-3
