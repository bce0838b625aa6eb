"""LM training over several ranks: the port's sharded train step, token
stream, loop and checkpoints on gloo worlds, against the JAX reference.

Ranks are `torch.multiprocessing.spawn` processes with one thread each
(tests/_torch_dist_worker.py, rank programs in
tests/_torch_lm_dist_worker.py, which import no JAX).

(a) One fp32 step at lr 1e-6 of reduced smollm-360m (dense) and
    granite-moe-3b-a800m (MoE), global batch 4 x 64, from the reference's
    `init_params`: smollm on meshes (2, 1) and (2, 2), granite on (4, 1)
    and (2, 2), so each arch runs once with data > 1 and once with
    model > 1. The reference runs `jax.jit(make_train_step(cfg, mesh))` on
    the same (data, model) mesh shape in one subprocess with 4 fake XLA
    devices (its state and batch placed by its own
    `train_state_shardings` / `batch_shardings`; the mesh is
    `jax.make_mesh` with `Auto` axes, since the `Explicit` axes its
    `make_host_mesh` gets on this jax refuse sharding constraints), and
    returns its arrays through an .npz. Gates, on every rank: loss,
    grad_norm and ce within 3e-5 relative; the gathered parameters and
    both AdamW moments within 2e-4 of their largest entry (the tolerances
    of tests/test_torch_specs_steps.py, and its reason for lr 1e-6); the
    same against the port's own one-rank step. Reduced mamba2-130m on
    (2, 2) (its SSD replicated over model) is held against the one-rank
    step alone, and smollm on (2, 2) with `microbatch=2` (each rank's rows
    split in two) against `microbatch=1`, at the same tolerances. The
    state's placements are `param_pspec`'s, the step replicated, and the
    ops that ran on replicated operands are ones `shardctx.REPLICATE_OK`
    names (printed with -s; the set depends on DTensor's version).
(b) `launch.train --arch smollm-360m --device cpu` (reduced, global batch
    4 x 32, bf16 weights) on a world of 2 with the environment `torchrun`
    gives: 3 steps with a checkpoint at 3, written once (by rank 0) with
    `arrays.npz`, `MANIFEST.json` and `.COMPLETE`; it resumes on a world of
    1 to step 5, and a world-1 checkpoint resumes on a world of 2, each
    restored state equal to the checkpoint bit for bit; only rank 0 prints
    `[train]` / `[trainer]` lines. The world-2 losses lie within 5e-4
    relative of the world-1 losses on the same global batches (see
    `LOSS_TOL`).
(c) Agreement: SIGTERM on rank 1 only during step 2 stops both ranks after
    step 2 with one final checkpoint at 2; a NaN loss on rank 0 only is
    skipped by both ranks and the next step gets the same state; a step
    slower than the watchdog on rank 1 only is skipped by both.
(d) The stream: on a (2, 2) mesh rank r keeps rows [c B / D, (c + 1) B / D)
    of the reference's global draw (c its data coordinate), as a DTensor
    of the global shape; a global batch the data axes do not divide raises
    naming both sizes.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_dist_worker as worker  # noqa: E402

from repro.data.tokens import _synth_stream as ref_stream  # noqa: E402
from repro.models import get_arch as ref_get_arch  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro_torch.interop import lm_reference_leaf  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import get_arch  # noqa: E402
from repro_torch.models.shardctx import REPLICATE_OK  # noqa: E402
from repro_torch.train.checkpoint import load_checkpoint  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAT_TOL = 2e-4
VAL_TOL = 3e-5
LR = 1e-6
# bf16 weights and gradients: the sharded step sums the gradients' partial
# sums in another order than one rank does, so a bf16 gradient or weight
# can round one ulp (2^-8 relative) apart. At lr 1e-3 that moved the
# losses here by at most 4e-5 relative over 3 steps (9e-5 by step 6),
# while training on one rank's half of the batch moves step 1's loss by
# 4e-3: 5e-4 sits between the two
LOSS_TOL = 5e-4
CASES = (("smollm-360m", (2, 1)), ("smollm-360m", (2, 2)),
         ("granite-moe-3b-a800m", (4, 1)), ("granite-moe-3b-a800m", (2, 2)))
# held against the port's one-rank step only (which
# tests/test_torch_specs_steps.py holds against the reference's): mamba2's
# SSD runs replicated over model, its heads not dividing it
PORT_CASES = (("mamba2-130m", (2, 2)),)
ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "mamba2-130m")
MICROBATCH = ("smollm-360m", (2, 2))   # also run with microbatch=2

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.launch import steps
from repro.models import get_arch, init_params
from repro.models.sharding import batch_shardings

inp = np.load(sys.argv[1])
lr = float(sys.argv[3])
out = {}
for case in sys.argv[4:]:
    arch, d, m = case.split(",")
    d, m = int(d), int(m)
    cfg = get_arch(arch).reduced()
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         (AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:d * m])
    state = steps.init_train_state(cfg, jax.random.PRNGKey(0), jnp.float32)
    state = state._replace(
        params=init_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    state = jax.device_put(state, steps.train_state_shardings(mesh, state))
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "targets")}
    batch = jax.device_put(batch, batch_shardings(mesh, batch))
    new, met = jax.jit(steps.make_train_step(cfg, mesh, lr=lr))(state, batch)
    tag = f"{arch}|{d}x{m}|"
    for k, v in met.items():
        out[tag + "metric|" + k] = np.asarray(v)
    for part in ("params", "mu", "nu"):
        flat = jax.tree_util.tree_flatten_with_path(getattr(new, part))[0]
        for path, leaf in flat:
            out[tag + part + "|" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def _close(a, b, tol=MAT_TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30))


def _scalar_close(a, b, tol=VAL_TOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol * abs(b), (a, b)


def _batch(vocab):
    rng = np.random.default_rng(3)
    return {k: rng.integers(0, vocab, size=(4, 64)).astype(np.int32)
            for k in ("tokens", "targets")}


def _ref_params(arch):
    cfg = ref_get_arch(arch).reduced()
    return jax.tree.map(np.asarray, ref_init_params(cfg, jax.random.PRNGKey(0),
                                                    jnp.float32))


def _tree(template, npz, prefix):
    flat, tdef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        tdef, [npz[prefix + jax.tree_util.keystr(p)] for p, _ in flat])


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    """The reference's SPMD steps (a subprocess, started first) beside the
    port's gloo worlds of 2 and 4 (the world of 4 also runs (d))."""
    tmp = tmp_path_factory.mktemp("lm_dist")
    vocab = get_arch(ARCHS[0]).reduced().vocab
    assert all(get_arch(a).reduced().vocab == vocab for a in ARCHS)
    batch = _batch(vocab)
    np.savez(tmp / "in.npz", **batch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "ref.npz"), str(LR),
         *(f"{a},{d},{m}" for a, (d, m) in CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        params = {a: _ref_params(a) for a in ARCHS}
        port = {}
        for world in (2, 4):
            cases = [{"arch": a, "mesh": s,
                      "microbatch": 2 if (a, s) == MICROBATCH else 0}
                     for a, s in CASES + PORT_CASES if s[0] * s[1] == world]
            p = {"train_steps": {"cases": cases, "params": params,
                                 "batch": batch, "lr": LR}}
            if world == 4:
                p["stream"] = {"mesh": (2, 2), "vocab": 1000, "batch": 4,
                               "seq": 16, "n": 2}
            (tmp / f"w{world}").mkdir()
            outs = worker.spawn("_torch_lm_dist_worker:several", world, p,
                                tmp / f"w{world}")
            port[world] = outs
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as f:
        ref_out = {k: f[k] for k in f.files}
    return params, batch, ref_out, port


@pytest.fixture(scope="module")
def one_rank(steps_run):
    """The port's plain one-rank step on the same state and batch."""
    params, batch, _, _ = steps_run
    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        from repro_torch.interop import lm_params_from_numpy

        lm = lm_params_from_numpy(cfg, params[arch], "cpu")
        p = {k: v.detach() for k, v in lm.named_parameters()}
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        st = steps.TrainState(p, mu, {k: v.clone() for k, v in mu.items()},
                              torch.zeros((), dtype=torch.int32))
        new, met = steps.make_train_step(cfg, None, lr=LR)(
            st, {k: torch.as_tensor(v) for k, v in batch.items()})
        out[arch] = (new, {k: float(v) for k, v in met.items()})
    return out


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_step_matches_reference_spmd(steps_run, one_rank, arch, mesh):
    params, _, ref, port = steps_run
    outs = port[mesh[0] * mesh[1]]
    tag = f"{arch}|{mesh[0]}x{mesh[1]}|"
    rp = {part: _tree(params[arch], ref, tag + part + "|")
          for part in ("params", "mu", "nu")}
    plain, plain_met = one_rank[arch]
    for out in outs:
        got = out["train_steps"][(arch, mesh)]
        met, st = got["metrics"], got["state"]
        for k in ("loss", "grad_norm", "ce"):
            _scalar_close(met[k], ref[tag + "metric|" + k])
            _scalar_close(met[k], plain_met[k])
        _scalar_close(met["moe_aux"] + 1.0, float(ref[tag + "metric|moe_aux"]) + 1.0)
        assert st["step"] == 1
        for name in st["params"]:
            for part in ("params", "mu", "nu"):
                _close(st[part][name], lm_reference_leaf(rp[part], name))
                _close(st[part][name], getattr(plain, part)[name].numpy())
        # each rank fed its own rows of the global batch
        assert got["local_rows"] == 4 // mesh[0]


@pytest.mark.parametrize("arch,mesh", PORT_CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in PORT_CASES])
def test_step_matches_one_rank(steps_run, one_rank, arch, mesh):
    _, _, _, port = steps_run
    plain, plain_met = one_rank[arch]
    for out in port[mesh[0] * mesh[1]]:
        got = out["train_steps"][(arch, mesh)]
        for k in ("loss", "grad_norm", "ce"):
            _scalar_close(got["metrics"][k], plain_met[k])
        for part in ("params", "mu", "nu"):
            for name, v in getattr(plain, part).items():
                _close(got["state"][part][name], v.numpy())


def test_microbatch_slices_the_local_batch(steps_run):
    """`microbatch=2` on a sharded batch (each rank's rows split in two)
    equals `microbatch=1` at the conformance tolerances."""
    _, _, _, port = steps_run
    arch, mesh = MICROBATCH
    for out in port[mesh[0] * mesh[1]]:
        got = out["train_steps"][(arch, mesh)]
        mb = got["microbatch"]
        for k in ("loss", "grad_norm", "ce"):
            _scalar_close(mb["metrics"][k], got["metrics"][k])
        for part in ("params", "mu", "nu"):
            for name, v in got["state"][part].items():
                _close(mb["state"][part][name], v)


def test_state_layout_and_replicated_ops(steps_run):
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import param_pspec, placements

    _, _, _, port = steps_run
    for arch, mesh in CASES + PORT_CASES:
        fake = type("M", (), {"axis_names": ("data", "model"),
                              "devices": np.zeros(mesh)})()
        got = port[mesh[0] * mesh[1]][0]["train_steps"][(arch, mesh)]
        print(arch, mesh, "ran replicated:", got["fallbacks"])
        assert set(got["fallbacks"]) <= REPLICATE_OK
        assert got["step_placements"] == ["R", "R"]
        lm = LM(get_arch(arch).reduced(), device="meta")
        for name, p in lm.named_parameters():
            want = placements(fake, param_pspec(fake, name, tuple(p.shape)), p.ndim)
            assert got["placements"][name] == [str(w) for w in want], name


def test_stream_shards_the_global_batch(steps_run):
    _, _, _, port = steps_run
    ref = ref_stream(1000, 4, 16, 0)
    draws = [next(ref) for _ in range(2)]
    for out in port[4]:
        s = out["stream"]
        d = s["coords"][0]
        assert s["global_shape"] == (4, 16)
        assert s["placements"] == ["S(0)", "R"]
        for i, r in enumerate(draws):
            np.testing.assert_array_equal(s["tokens"][i], r["tokens"][2 * d:2 * d + 2])
            np.testing.assert_array_equal(s["targets"][i], r["targets"][2 * d:2 * d + 2])
        assert "5" in s["error"] and "2" in s["error"], s["error"]


# -- (b), (c): the launcher ----------------------------------------------------


def _argv(ckpt, steps_, every=3):
    return ["--arch", "smollm-360m", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--steps", str(steps_), "--ckpt", str(ckpt),
            "--ckpt-every", str(every), "--log-every", "1"]


CK = "smollm-360m-smoke"


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """World 2: 3 steps into X, the SIGTERM and NaN runs, the watchdog;
    world 1: X resumed to 5, 3 fresh steps into Y; world 2: Y resumed to 5."""
    tmp = tmp_path_factory.mktemp("lm_launch")
    x, y = tmp / "x", tmp / "y"
    for d in ("s1", "s2", "s3"):
        (tmp / d).mkdir()
    first = worker.spawn("_torch_lm_dist_worker:several", 2, {
        "launch": {"runs": [{"argv": _argv(x, 3)},
                            {"argv": _argv(tmp / "term", 3, every=100),
                             "hook": "sigterm"},
                            {"argv": _argv(tmp / "nan", 3, every=100),
                             "hook": "nan"}]},
        "timeout": {"timeout": 1.0, "sleep": 2.5}}, tmp / "s1")
    one = worker.spawn("_torch_lm_dist_worker:launch", 1, {
        "runs": [{"argv": _argv(x, 5)}, {"argv": _argv(y, 3)}]}, tmp / "s2")[0]
    last = worker.spawn("_torch_lm_dist_worker:launch", 2, {
        "runs": [{"argv": _argv(y, 5)}]}, tmp / "s3")
    return tmp, first, one, last


def _ckpt_equals(state, directory, step):
    """A gathered state equals the checkpoint at `step` bit for bit (bf16
    compared as its uint16 bits)."""
    template = steps.TrainState(state["params"], state["mu"], state["nu"],
                                np.int32(state["step"]))
    arrays, got, _ = load_checkpoint(str(directory), template, step=step)
    assert got == step and int(arrays.step) == state["step"] == step
    for part in ("params", "mu", "nu"):
        for k, v in getattr(template, part).items():
            a = getattr(arrays, part)[k]
            assert a.dtype == v.dtype and np.array_equal(a, v), (part, k)


def _ckpt_dir_of(root):
    return root / CK


def test_launcher_world_of_two_checkpoints_once(launches):
    tmp, first, _, _ = launches
    r0, r1 = (o["launch"][0] for o in first)
    for r in (r0, r1):
        assert r["steps_run"] == 3 and r["skipped"] == 0
        assert r["mesh"] == {"data": 2, "model": 1}
        assert r["losses"] == r0["losses"]
    assert r0["writes"] == [3] and r1["writes"] == []
    step3 = _ckpt_dir_of(tmp / "x") / "step_00000003"
    assert sorted(os.listdir(step3)) == [".COMPLETE", "MANIFEST.json", "arrays.npz"]
    assert (step3 / ".COMPLETE").read_text() == "ok"
    assert "[train] arch=smollm-360m-smoke" in r0["stdout"]
    assert "[trainer] step 3:" in r0["stdout"]
    assert "[train] done: 3 steps, 0 skipped tokens/s=" in r0["stdout"]
    assert "[train" not in r1["stdout"]
    assert set(r0["fallbacks"]) <= REPLICATE_OK


def test_world_two_checkpoint_resumes_on_one_bit_for_bit(launches):
    tmp, first, one, _ = launches
    r = one[0]
    assert r["mesh"] == {"data": 1, "model": 1}
    assert "[trainer] resumed from step 3" in r["stdout"]
    assert r["steps_run"] == 2 and r["final"]["step"] == 5
    _ckpt_equals(r["first_state"], _ckpt_dir_of(tmp / "x"), 3)
    # the resumed run's final checkpoint is in the one-rank layout as well
    _ckpt_equals(r["final"], _ckpt_dir_of(tmp / "x"), 5)


def test_world_one_checkpoint_resumes_on_two_bit_for_bit(launches):
    tmp, _, one, last = launches
    for out in last:
        r = out[0]
        assert r["mesh"] == {"data": 2, "model": 1}
        assert r["steps_run"] == 2 and r["final"]["step"] == 5
        _ckpt_equals(r["first_state"], _ckpt_dir_of(tmp / "y"), 3)
    assert "[trainer] resumed from step 3" in last[0][0]["stdout"]
    assert "[train" not in last[1][0]["stdout"]
    assert last[0][0]["writes"] == [5] and last[1][0]["writes"] == []


def test_world_two_losses_follow_world_one(launches):
    _, first, one, _ = launches
    w2 = first[0]["launch"][0]["losses"]
    w1 = one[1]["losses"]
    assert len(w1) == len(w2) == 3
    for a, b in zip(w2, w1):
        assert abs(a - b) <= LOSS_TOL * abs(b), (w2, w1)


def test_sigterm_on_one_rank_stops_both(launches):
    tmp, first, _, _ = launches
    for rank, out in enumerate(first):
        r = out["launch"][1]
        assert r["steps_run"] == 2, rank
        assert r["writes"] == ([2] if rank == 0 else [])
    assert sorted(os.listdir(_ckpt_dir_of(tmp / "term"))) == ["step_00000002"]


def test_nan_on_one_rank_is_skipped_by_both(launches):
    _, first, _, _ = launches
    for out in first:
        r = out["launch"][2]
        assert r["skipped"] == 1 and r["steps_run"] == 3
        assert r["same_after_skip"]
        assert np.all(np.isfinite(r["losses"]))
    a, b = (out["launch"][2]["final"] for out in first)
    for name in a["params"]:
        assert np.array_equal(a["params"][name], b["params"][name])
    assert "SKIPPED (non-finite metrics)" in first[0]["launch"][2]["stdout"]


def test_timeout_on_one_rank_is_skipped_by_both(launches):
    _, first, _, _ = launches
    outs = [out["timeout"] for out in first]
    for o in outs:
        assert o["world"] == 2
        assert o["steps_run"] == 3 and o["skipped"] == 1 and o["calls"] == 4
    np.testing.assert_array_equal(outs[0]["w"], outs[1]["w"])
    assert any("SKIPPED (timeout" in ln for ln in outs[0]["lines"])
    assert outs[1]["lines"] == []
