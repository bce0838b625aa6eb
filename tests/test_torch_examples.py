"""CPU smoke runs of the port's examples added with the dry run and the LM
trainer, at small sizes:

* `examples/spatial_gp_torch.py` (the counterpart of `spatial_gp.py`):
  `matern32 * wendland2` on `blocksparse` at n = 512, 2 Adam steps; the
  plan prunes tiles, the pruned MVM equals the dense-slab one, and the fit
  predicts the latent surface.
* `examples/distributed_gp_torch.py` (the counterpart of
  `distributed_gp.py`): a gloo world of 2 ranks it starts itself, a 2-D
  mesh, 2 MLL steps, the mean-cache solve, then the artifact and engine.
* `examples/train_lm_torch.py`: the reduced LM learns in 12 steps.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import importlib.util
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spatial_gp_example():
    out = _load("spatial_gp_torch").main(["--device", "cpu", "--n", "512",
                                          "--steps", "2"])
    assert out["fill"] < 1.0
    # |K_hat V| reaches ~10 here; each backend is within ~5e-4 of a float64
    # MVM (fp32 rounding of the squared-distance expansion, ROADMAP C3)
    assert out["mvm_max_dev"] < 2e-3
    assert math.isfinite(out["rmse"]) and out["rmse"] < 0.5
    assert len(out["loss_trace"]) == 2


def test_distributed_gp_example(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("RANK", None)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "distributed_gp_torch.py"),
         "--device", "cpu", "--world", "2", "--points", "2304", "--steps", "2",
         "--artifact", str(tmp_path / "art")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout
    assert "mesh: {'data': 1, 'model': 2} mode=2d on gloo/cpu" in lines
    assert "step 1: nll/n=" in lines
    assert "mean-cache solve: rel_residual=" in lines
    rmse = float(lines.split("1000 predictions: rmse=")[1].split()[0])
    eng = float(lines.split("engine (restored artifact): rmse=")[1].split()[0])
    assert rmse < 1.0 and abs(eng - rmse) < 1e-3


def test_train_lm_example():
    out = _load("train_lm_torch").main(["--device", "cpu", "--steps", "12",
                                        "--batch", "2", "--seq", "32"])
    assert out["steps"] == 12 and out["last"] < out["first"]
