"""`repro_torch.train.checkpoint`: the reference's manager and layout tests
(`tests/test_checkpoint_trainer.py`: bitwise restore, corruption, incomplete
checkpoints, retention, shape mismatch) on the port, `CheckpointManager`'s
save-every-k / resume, and both packages reading each other's files: an
`SVGPParams` tree written by the port's manager loads bit for bit through
the reference's `load_checkpoint`, and the other way round."""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import svgp as ref_svgp
from repro.train import checkpoint as ref_checkpoint
from repro_torch.core import init_svgp_params
from repro_torch.core.kernels_math import params_leaves
from repro_torch.interop import params_from_numpy
from repro_torch.train import CheckpointManager, load_checkpoint, save_checkpoint


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 8), generator=g),
            "stats": {"mu": torch.zeros((8,)), "step": torch.tensor(3)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [np.asarray(tree)]


def _steps(directory):
    return sorted(int(p.split("_")[1]) for p in os.listdir(directory)
                  if p.startswith("step_"))


def test_save_load_bitwise(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree, {"note": "x"})
    loaded, step, meta = load_checkpoint(str(tmp_path), tree)
    assert step == 7 and meta["note"] == "x"
    for a, b in zip(_leaves(tree), _leaves(loaded)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_corruption_detected(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    npz = os.path.join(path, "arrays.npz")
    data = open(npz, "rb").read()
    # flip bytes inside the zip payload
    corrupted = data[:200] + bytes([data[200] ^ 0xFF]) + data[201:]
    open(npz, "wb").write(corrupted)
    with pytest.raises(Exception):
        load_checkpoint(str(tmp_path), tree)


def test_incomplete_checkpoint_ignored(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    # a preempted writer: a directory without .COMPLETE
    os.makedirs(tmp_path / "step_00000002")
    _, step, _ = load_checkpoint(str(tmp_path), tree)
    assert step == 1
    assert CheckpointManager(str(tmp_path)).latest_step() == 1


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=2)
    tree = _tree()
    for s in range(1, 6):
        mgr.maybe_save(s, tree)
    assert _steps(tmp_path) == [4, 5]


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), {"w": torch.zeros((5,))})


def test_manager_saves_every_k_and_resumes(tmp_path):
    """maybe_save writes at multiples of save_every (or when forced), keep=0
    keeps everything, restore_or_init resumes from the newest complete
    checkpoint or returns the template at step 0."""
    mgr = CheckpointManager(str(tmp_path), save_every=3, keep=0)
    template = _tree()
    assert mgr.latest_step() is None
    assert mgr.restore_or_init(template) == (template, 0, {})
    paths = [mgr.maybe_save(s, _tree(s), {"s": s}) for s in range(1, 8)]
    assert [p is not None for p in paths] == [False, False, True, False,
                                              False, True, False]
    assert mgr.maybe_save(7, _tree(7), {"s": 7}, force=True).endswith(
        "step_00000007")
    assert _steps(tmp_path) == [3, 6, 7]
    tree, step, meta = mgr.restore_or_init(template)
    assert step == 7 and meta == {"s": 7}
    for a, b in zip(_leaves(_tree(7)), _leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _ref_svgp(seed=0):
    X = np.random.default_rng(seed).normal(size=(40, 3))
    p = ref_svgp.init_svgp_params(jax.random.PRNGKey(seed), jnp.asarray(X), 6,
                                  dtype=jnp.float32)
    return p._replace(q_mu=p.q_mu + 0.25)


def test_ports_manager_writes_what_the_reference_reads(tmp_path):
    X = torch.as_tensor(np.random.default_rng(1).normal(size=(40, 3)))
    vp = init_svgp_params(X, 6, dtype=torch.float32, device="cpu")
    vp = vp._replace(q_mu=vp.q_mu + 0.5)
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=1)
    mgr.maybe_save(4, {"svgp": vp, "step": torch.tensor(4)}, {"epoch": 4})
    tmpl = {"svgp": _ref_svgp(), "step": np.zeros((), np.int64)}
    got, step, meta = ref_checkpoint.load_checkpoint(str(tmp_path), tmpl)
    assert step == 4 and meta == {"epoch": 4}
    for a, b in zip(params_leaves(vp), jax.tree.leaves(got["svgp"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype


def test_references_manager_writes_what_the_port_reads(tmp_path):
    p_ref = _ref_svgp(2)
    mgr = ref_checkpoint.CheckpointManager(str(tmp_path), save_every=1)
    mgr.maybe_save(9, {"svgp": p_ref})
    X = torch.as_tensor(np.random.default_rng(1).normal(size=(40, 3)))
    tmpl = {"svgp": init_svgp_params(X, 6, dtype=torch.float32, device="cpu")}
    got, step, _ = CheckpointManager(str(tmp_path)).restore_or_init(tmpl)
    assert step == 9
    vp = params_from_numpy(got["svgp"], "cpu")
    assert type(vp).__name__ == "SVGPParams"
    for a, b in zip(params_leaves(vp), jax.tree.leaves(p_ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
