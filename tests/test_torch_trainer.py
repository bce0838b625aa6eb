"""The port's fault-tolerant training loop (`repro_torch.train.trainer`),
elastic rescale (`repro_torch.train.elastic`), token pipeline
(`repro_torch.data.tokens`) and the LM path of `launch.train`.

* The loop mirrors `tests/test_checkpoint_trainer.py:88-162`: it runs and
  checkpoints (the final forced save), resumes from the latest complete
  step, skips a NaN step without advancing the state (the step function
  gets the same state back, bit for bit), aborts after too many
  consecutive skips, and skips a step slower than `step_timeout_s`.
  Checkpoints of bf16 tensors restore as bf16 bit for bit.
* Elastic reshard across meshes on a gloo world of 4 (subprocess ranks, as
  `tests/_torch_dist_worker.py` runs them): a (4, 1) run's checkpoint
  restored onto (2, 2) gathers to the original arrays bit for bit, and
  `validate_divisibility` returns the reference's problem strings.
* `TokenPipeline`: `tests/test_data_optim.py:47`'s shape and next-token
  checks, and the port's first three batches equal the reference's
  `_synth_stream` bit for bit for seed 0.
* `launch.train --arch smollm-360m --device cpu` at (2, 32), reduced: 3
  steps with a checkpoint, then a resume to step 5 (a subprocess: the
  launcher joins a process group).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import spawn
from repro_torch.train.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.train.trainer import TrainLoopConfig, run_train_loop

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
QUIET = {"log_fn": lambda *_: None}


def _quadratic_step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch)
    loss = torch.sum((w - batch) ** 2)
    return {"w": w}, {"loss": loss}


def _batches(bad_at=None):
    i = 0
    while True:
        if bad_at is not None and i == bad_at:
            yield torch.full((4,), float("nan"))
        else:
            yield torch.ones((4,)) * (i % 3)
        i += 1


def test_train_loop_runs_and_checkpoints(tmp_path):
    cfg = TrainLoopConfig(total_steps=12, ckpt_dir=str(tmp_path),
                          ckpt_every=5, log_every=100)
    res = run_train_loop(_quadratic_step, {"w": torch.zeros((4,))},
                         _batches(), cfg, **QUIET)
    assert res.steps_run == 12
    assert CheckpointManager(str(tmp_path)).latest_step() == 12  # final save
    assert len(res.metrics_history) == 12


def test_train_loop_resumes(tmp_path):
    cfg = TrainLoopConfig(total_steps=5, ckpt_dir=str(tmp_path),
                          ckpt_every=100, log_every=100)
    first = run_train_loop(_quadratic_step, {"w": torch.zeros((4,))},
                           _batches(), cfg, **QUIET)
    seen = []

    def spy(state, batch):
        seen.append(state["w"].clone())
        return _quadratic_step(state, batch)

    res = run_train_loop(spy, {"w": torch.zeros((4,))}, _batches(),
                         cfg._replace(total_steps=9), **QUIET)
    assert res.steps_run == 4  # resumed from 5
    assert torch.equal(seen[0], first.state["w"])   # restored as saved
    assert isinstance(res.state["w"], torch.Tensor)


def test_train_loop_skips_nan_steps():
    """Fault containment: a NaN step is skipped, the state NOT advanced."""
    given = []

    def spy(state, batch):
        given.append(state)
        return _quadratic_step(state, batch)

    cfg = TrainLoopConfig(total_steps=6, log_every=100)
    res = run_train_loop(spy, {"w": torch.zeros((4,))}, _batches(bad_at=2),
                         cfg, **QUIET)
    assert res.steps_run == 6 and res.skipped == 1
    assert torch.all(torch.isfinite(res.state["w"]))
    # the call after the NaN step got the very state the NaN step was given
    assert given[3] is given[2]
    assert torch.equal(given[3]["w"], given[2]["w"])


def test_train_loop_aborts_on_persistent_failure():
    cfg = TrainLoopConfig(total_steps=10, max_consecutive_skips=3, log_every=100)

    def all_nan(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    with pytest.raises(RuntimeError, match="consecutive"):
        run_train_loop(all_nan, {"w": torch.zeros((2,))}, _batches(), cfg, **QUIET)


def test_train_loop_skips_slow_steps():
    calls = []

    def slow_once(state, batch):
        calls.append(1)
        if len(calls) == 2:
            import time
            time.sleep(0.3)
        return _quadratic_step(state, batch)

    cfg = TrainLoopConfig(total_steps=3, log_every=100, step_timeout_s=0.2)
    res = run_train_loop(slow_once, {"w": torch.zeros((4,))}, _batches(), cfg,
                         **QUIET)
    assert res.steps_run == 3 and res.skipped == 1 and len(calls) == 4


def test_bf16_state_checkpoints_bit_for_bit(tmp_path):
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    cfg = TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path), log_every=100)

    def keep(state, batch):
        return {"w": state["w"] + 0.5}, {"loss": torch.tensor(1.0)}

    first = run_train_loop(keep, {"w": w}, _batches(), cfg, **QUIET)
    seen = []

    def spy(state, batch):
        seen.append(state["w"])
        return keep(state, batch)

    run_train_loop(spy, {"w": torch.zeros(5, 3, dtype=torch.bfloat16)},
                   _batches(), cfg._replace(total_steps=2), **QUIET)
    assert seen[0].dtype == torch.bfloat16
    assert torch.equal(seen[0].view(torch.int16), first.state["w"].view(torch.int16))
    arrays, step, _ = load_checkpoint(str(tmp_path), {"w": w}, step=1)
    assert step == 1 and arrays["w"].dtype == np.uint16


def test_elastic_reshard_across_meshes(tmp_path):
    outs = spawn("elastic_reshard", 4, {"dir": str(tmp_path / "ck")}, tmp_path)
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    for rank, o in enumerate(outs):
        assert o["step"] == 5 and o["problems"] == []
        np.testing.assert_array_equal(o["w2_full"], w)
        assert o["mesh_shape"] == (2, 2)
        assert o["placements"] == ["S(0)", "S(1)"]
        r, c = divmod(rank, 2)
        np.testing.assert_array_equal(o["w2_local"], w[4 * r:4 * r + 4, 4 * c:4 * c + 4])
        np.testing.assert_array_equal(o["w4_local"], w[2 * rank:2 * rank + 2])


def test_validate_divisibility_problem_strings(tmp_path):
    outs = spawn("elastic_reshard", 4, {"dir": str(tmp_path / "ck")}, tmp_path)
    assert outs[0]["bad"] == [
        "['v'] dim 0 (3) % mesh('data',) (2) != 0"]


def test_token_pipeline_shapes_and_alignment():
    from repro_torch.data.tokens import TokenPipeline, token_batch_specs

    pipe = TokenPipeline(None, vocab=100, batch=4, seq=16, seed=0, device="cpu")
    try:
        b = next(pipe)
        assert b.tokens.shape == (4, 16) and b.targets.shape == (4, 16)
        assert b.tokens.dtype == torch.int32
        assert int(b.tokens.max()) < 100
        np.testing.assert_array_equal(b.tokens.numpy()[:, 1:],
                                      b.targets.numpy()[:, :-1])
    finally:
        pipe.close()
    spec = token_batch_specs(4, 16)
    assert spec["tokens"].shape == (4, 16) and spec["tokens"].device.type == "meta"


def test_token_pipeline_matches_reference_stream():
    from repro.data.tokens import _synth_stream as ref_stream
    from repro_torch.data.tokens import TokenPipeline

    ref = ref_stream(1000, 3, 32, 0)
    pipe = TokenPipeline(None, vocab=1000, batch=3, seq=32, seed=0, device="cpu")
    try:
        for _ in range(3):
            b, r = next(pipe), next(ref)
            assert b.tokens.numpy().dtype == r["tokens"].dtype == np.int32
            np.testing.assert_array_equal(b.tokens.numpy(), r["tokens"])
            np.testing.assert_array_equal(b.targets.numpy(), r["targets"])
    finally:
        pipe.close()


def _train(tmp_path, steps):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--device", "cpu", "--batch", "2", "--seq", "32",
         "--steps", str(steps), "--ckpt", str(tmp_path), "--ckpt-every", "3",
         "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=300)


def test_launch_train_lm_checkpoints_and_resumes(tmp_path):
    out = _train(tmp_path, 3)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] arch=smollm-360m-smoke" in out.stdout
    assert "[train] done: 3 steps, 0 skipped tokens/s=" in out.stdout
    assert "tok/s=" in out.stdout
    ck = tmp_path / "smollm-360m-smoke"
    assert CheckpointManager(str(ck)).latest_step() == 3
    out = _train(tmp_path, 5)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[trainer] resumed from step 3" in out.stdout
    assert "[train] done: 2 steps, 0 skipped" in out.stdout
    assert CheckpointManager(str(ck)).latest_step() == 5
