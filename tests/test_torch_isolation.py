"""The port stands alone: no JAX, nothing of `repro`, and no silent CPU.

* No file under src/repro_torch/ (the obs modules and the obs_report /
  obs_diff launchers among them), not chip_smoke.py, the port's examples
  or `scripts/serve_lm_profile.py`, imports `jax` or `repro` (an AST
  scan).
* With JAX made unimportable, `repro_torch` imports and predicts on the CPU.
* Entry points with no `device` raise when there is no card, rather than
  running on the CPU (the operators, the posterior fit and engine, the
  engine on a saved artifact (`PredictionEngine.from_dir`), the launchers, the serving fleet, training: `fit_exact_gp`, `exact_mll`, the
  blocksparse backend, the distributed engine: `init_distributed`,
  `make_mesh`, `make_host_mesh`, the sharded operator, and the baselines:
  `fit_sgpr`, `fit_svgp`, `init_sgpr_params`, `init_svgp_params`, the
  autotuner's `tiles_for_spec` / `prewarm`, and deep kernel learning: the
  LM's `init_params` / `LM` and its layers' `attn_params`, `mlp_params`,
  `norm_param`, `ssd_params`, `pooled_features`,
  `init_mlp`, `make_mlp_dkl`, `DKLModel.loss`).
* A non-CPU tensor handed to a kernel wrapper never reaches the plain
  version (with a real CUDA tensor: tests/test_torch_gpu.py).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.kernels_math import init_kernel_params, init_params
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.kernels import kmvm
from repro_torch.serve import PredictionEngine, fit_posterior

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "dkl_lm_features_torch.py",
    ROOT / "examples" / "serve_lm_torch.py", ROOT / "scripts" / "serve_lm_profile.py"]


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {bad}"


def test_port_runs_with_jax_unimportable():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch.core.kernels_math import init_params\n"
        "from repro_torch.core.operators import OperatorConfig, make_operator\n"
        "from repro_torch.serve import PredictionEngine, fit_posterior\n"
        "import repro_torch.launch.serve_gp, repro_torch.interop\n"
        "import repro_torch.train.gp_trainer, repro_torch.sparse\n"
        "import repro_torch.core.distributed, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.obs\n"
        "import repro_torch.launch.obs_report, repro_torch.launch.obs_diff\n"
        "from repro_torch.obs import costmodel, health, measure, profiling\n"
        "from repro_torch.obs import regress, report\n"
        "import repro_torch.core.sgpr, repro_torch.core.svgp\n"
        "import repro_torch.kernels.autotune, repro_torch.train.checkpoint\n"
        "from repro_torch.train import CheckpointManager, fit_sgpr, fit_svgp\n"
        "from repro_torch.serve import ServeFleet, ContinuousBatcher\n"
        "import repro_torch.models, repro_torch.core.dkl, repro_torch.configs\n"
        "from repro_torch.models import get_arch, list_archs\n"
        "assert all(get_arch(a).name == a for a in list_archs())\n"
        "X = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)\n"
        "op = make_operator(OperatorConfig(backend='pallas'), X, init_params(),"
        " device='cpu')\n"
        "art = fit_posterior(op, np.sin(X[:, 0]), precond_rank=8, lanczos_rank=8)\n"
        "m, v = PredictionEngine(art, device='cpu', chunk_size=16).predict(X[:5])\n"
        "assert torch.isfinite(m).all() and torch.isfinite(v).all()\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_quickstart_runs_with_jax_unimportable(tmp_path):
    """examples/quickstart_torch.py on the CPU: the paper's comparison at the
    quickstart's size, the exact GP ahead of both baselines."""
    code = (
        "import sys, json; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "sys.path.insert(0, 'examples')\n"
        "import quickstart_torch\n"
        f"rows = quickstart_torch.main(['--device', 'cpu', '--artifact', {str(tmp_path)!r}])\n"
        "print(json.dumps(rows))\n")
    # one thread: beside a loaded test run, a many-threaded CPU torch stalls
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rows) == {"exact", "sgpr", "svgp", "engine"}
    assert all(np.isfinite(v) for r in rows.values() for v in r.values())
    assert rows["exact"]["rmse"] < min(rows["sgpr"]["rmse"], rows["svgp"]["rmse"])
    assert abs(rows["engine"]["rmse"] - rows["exact"]["rmse"]) < 1e-4


def test_tf32_is_off():
    assert repro_torch.device is not None  # importing the package sets them
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((8, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_operator(OperatorConfig(), X, init_params())
    op = make_operator(OperatorConfig(backend="dense"),
                       X + np.arange(8, dtype=np.float32)[:, None],
                       init_params(), device="cpu")
    art = fit_posterior(op, np.ones(8, np.float32), precond_rank=2, lanczos_rank=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictionEngine(art)
    from repro_torch.serve import save_artifact

    save_artifact(str(tmp_path), art)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictionEngine.from_dir(str(tmp_path))
    assert PredictionEngine.from_dir(str(tmp_path), device="cpu").op.device.type == "cpu"
    from repro_torch.kernels.autotune import prewarm, tiles_for_spec

    for call in (lambda: tiles_for_spec("matern32", init_params(), 8, 8, 2, 1),
                 lambda: prewarm("matern32", init_params(), 8, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from repro_torch.serve import ServeFleet

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeFleet()
    from repro_torch.launch import serve_gp

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gp.main(["--n", "16"])
    from repro_torch.core.gp import ExactGP, ExactGPConfig
    from repro_torch.core.mll import MLLConfig, exact_mll
    from repro_torch.sparse import BlockSparseOperator
    from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp

    y = np.ones(8, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_exact_gp(ExactGP(ExactGPConfig()), X, y, method="adam",
                     cfg=GPTrainConfig(plain_adam_steps=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exact_mll(MLLConfig(), torch.as_tensor(X), torch.as_tensor(y),
                  init_params())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_operator(OperatorConfig(kernel="matern32 * wendland2",
                                     backend="blocksparse"), X,
                      init_kernel_params("matern32 * wendland2"))
    assert BlockSparseOperator.grad_backend == "blocksparse"


def test_baseline_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core import init_sgpr_params, init_svgp_params
    from repro_torch.train import fit_sgpr, fit_svgp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).normal(size=(16, 2)).astype(np.float32)
    y = np.ones(16, np.float32)
    for call in (lambda: fit_sgpr("matern32", X, y, 4, steps=1),
                 lambda: fit_svgp("matern32", X, y, 4, epochs=1, batch=8),
                 lambda: init_sgpr_params(X, 4),
                 lambda: init_svgp_params(X, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("dots", (False, True))
def test_non_cpu_tensor_never_reaches_plain(monkeypatch, dots):
    def boom(*a, **k):
        raise AssertionError("plain version called on a non-CPU tensor")

    monkeypatch.setattr(kmvm, "kmvm_plain", boom)
    monkeypatch.setattr(kmvm, "kmvm_dots_plain", boom)
    meta = {"device": "meta"}
    X, V = torch.empty((8, 3), **meta), torch.empty((8, 1), **meta)
    scalars = torch.empty((2,), **meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if dots:
            kmvm.kmvm_fused_dots((("rbf",),), X, X, V, V, V, scalars)
        else:
            kmvm.kmvm_fused((("rbf",),), X, X, V, scalars)


def test_non_cpu_tensor_never_reaches_blocksparse_plain(monkeypatch):
    from repro_torch.sparse import kmvm_sparse

    def boom(*a, **k):
        raise AssertionError("plain version called on a non-CPU tensor")

    monkeypatch.setattr(kmvm_sparse, "kmvm_blocksparse_plain", boom)
    meta = {"device": "meta"}
    X, V = torch.empty((8, 3), **meta), torch.empty((8, 1), **meta)
    ptr = torch.empty((2,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmvm_sparse.kmvm_blocksparse((("rbf",),), X, X, V,
                                     torch.empty((2,), **meta), ptr, ptr,
                                     tile=8)


def test_dkl_entry_points_raise_without_a_card(monkeypatch):
    """The LM, its pooled features and the DKL loss refuse to run on the
    CPU when no card is there and no device is named."""
    from repro_torch.core.dkl import (
        DKLModel, init_mlp, make_mlp_dkl, mlp_apply, pooled_features)
    from repro_torch.core.gp import ExactGP
    from repro_torch.models import LM, get_arch
    from repro_torch.models import init_params as lm_init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("smollm-360m").reduced(n_layers=1, d_model=32, vocab=64)
    lm = LM(cfg, dtype=torch.float32, device="cpu")
    tokens = np.zeros((4, 8), np.int64)
    phi = init_mlp(None, (3, 4), device="cpu")
    X, y = np.zeros((8, 3), np.float32), np.zeros(8, np.float32)
    from repro_torch.models.attention import attn_params
    from repro_torch.models.layers import mlp_params, norm_param
    from repro_torch.models.ssd import ssd_params

    for call in (lambda: lm_init_params(cfg),
                 lambda: LM(cfg),
                 lambda: attn_params(None, 8, 2, 2, 4, torch.float32),
                 lambda: mlp_params("swiglu", None, 8, 16, torch.float32),
                 lambda: norm_param("rmsnorm", 8, torch.float32),
                 lambda: ssd_params(None, get_arch("mamba2-130m").reduced(),
                                    torch.float32),
                 lambda: pooled_features(cfg, lm, tokens),
                 lambda: init_mlp(None, (3, 4)),
                 lambda: make_mlp_dkl(None, 3),
                 lambda: DKLModel(ExactGP(), mlp_apply).loss(
                     X, y, phi, init_params())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_distributed_entry_points_raise_without_a_card(monkeypatch):
    """The launcher without --device, the mesh constructors and the sharded
    operator refuse to run on the CPU when no card is there, before any
    process group is joined."""
    import types

    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "gp-exact-1m", "--gp-n", "16", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_distributed()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_host_mesh()
    assert not dist.is_initialized()
    stub = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((1, 1)))
    geom = D.make_geometry(stub, 8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_operator(D.DistMLLConfig().operator_config(geom),
                      np.zeros((8, 2), np.float32), init_params())


def test_non_cpu_tensor_never_reaches_chunk_plain(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a non-CPU tensor")

    monkeypatch.setattr(kmvm, "kmvm_plain", boom)
    monkeypatch.setattr(kmvm, "kmvm_chunk_plain", boom)
    meta = {"device": "meta"}
    X, V = torch.empty((8, 3), **meta), torch.empty((8, 1), **meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmvm.kmvm_fused_chunk((("rbf",),), X, X, V, torch.empty((2,), **meta),
                              torch.empty((8, 1), **meta))
