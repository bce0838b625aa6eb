"""The port's dry-run cells (`repro_torch.launch.specs`), step factories
(`repro_torch.launch.steps`) and gradient clipping against the reference.

* `SHAPES` and `cell_for` equal the reference's for every arch and shape
  (long_500k skipped for the full-attention archs, as
  `tests/test_models_smoke.py:117` holds).
* `input_specs` / `decode_specs` give the reference's shapes and dtypes
  (the port's per-layer caches against the reference's stacked ones),
  on the `meta` device: nothing is allocated.
* `_adamw` on seeded numpy trees equals the reference's within 1e-6 over
  3 steps; `clip_by_global_norm` passes `tests/test_data_optim.py:82`'s
  case and equals the reference's on a mixed-dtype tree.
* One `make_train_step` step in fp32 at reduced smollm-360m (dense),
  mamba2-130m (ssm) and granite-moe-3b-a800m (moe) against the
  reference's on a one-device mesh, the reference's weights carried
  across: loss, grad_norm and the model's metrics within 3e-5; the updated
  parameters and both Adam moments within 2e-4 of their largest entry (the
  conformance tolerances). lr is 1e-6 for the parameter check: AdamW's
  first step moves an entry by lr * sign(g), so a gradient entry at the
  fp32 noise floor may take either sign in either package, and only a
  small lr keeps such entries inside the tolerance; the moments carry the
  gradients exactly. `microbatch=2` equals `microbatch=1` within the same
  tolerances, and a step leaves the state it was given untouched.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import specs as ref_specs
from repro.launch import steps as ref_steps
from repro.models import get_arch as ref_get_arch
from repro.models import init_params as ref_init_params
from repro.models import registry as ref_registry
from repro.optim import clip_by_global_norm as ref_clip
from repro_torch.interop import lm_params_from_numpy, lm_reference_leaf
from repro_torch.launch import specs, steps
from repro_torch.models import get_arch
from repro_torch.optim import clip_by_global_norm

MAT_TOL = 2e-4
VAL_TOL = 3e-5
LM_ARCHS = tuple(a for a in ref_registry.ARCH_IDS if a != "gp-exact-1m")
STEP_ARCHS = ("smollm-360m", "mamba2-130m", "granite-moe-3b-a800m")
_DT = {jnp.dtype("int32"): torch.int32, jnp.dtype("bfloat16"): torch.bfloat16,
       jnp.dtype("bool"): torch.bool, jnp.dtype("float32"): torch.float32}


def _close(a, b, tol=MAT_TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30))


def _scalar_close(a, b, tol=VAL_TOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol * abs(b), (a, b)


def test_shapes_and_cells_match_reference():
    assert specs.SHAPES == ref_specs.SHAPES
    for arch in LM_ARCHS:
        rcfg, cfg = ref_get_arch(arch), get_arch(arch)
        for shape in specs.SHAPES:
            assert specs.cell_for(cfg, shape)._asdict() == \
                ref_specs.cell_for(rcfg, shape)._asdict()
        skip = specs.cell_for(cfg, "long_500k").skip
        assert bool(skip) == (not cfg.sub_quadratic)
    from repro.configs.gp_exact_1m import CONFIG as RGP
    from repro_torch.configs.gp_exact_1m import CONFIG as GP
    assert [c._asdict() for c in specs.gp_cells(GP)] == \
        [c._asdict() for c in ref_specs.gp_cells(RGP)]
    rx = ref_specs.gp_input_specs(RGP)
    px = specs.gp_input_specs(GP)
    for k in rx:
        assert tuple(px[k].shape) == rx[k].shape and px[k].device.type == "meta"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_and_decode_specs_match_reference(arch):
    rcfg, cfg = ref_get_arch(arch), get_arch(arch)
    for shape in ("train_4k", "prefill_32k"):
        rb = ref_specs.input_specs(rcfg, ref_specs.cell_for(rcfg, shape))
        pb = specs.input_specs(cfg, specs.cell_for(cfg, shape))
        assert set(rb) == set(pb)
        for k in rb:
            assert tuple(pb[k].shape) == rb[k].shape, k
            assert pb[k].dtype == _DT[jnp.dtype(rb[k].dtype)], k
            assert pb[k].device.type == "meta"
    shapes = ["decode_32k"] + (["long_500k"] if cfg.sub_quadratic else [])
    for shape in shapes:
        rstate, rtok = ref_specs.decode_specs(rcfg, ref_specs.cell_for(rcfg, shape))
        pstate, ptok = specs.decode_specs(cfg, specs.cell_for(cfg, shape))
        assert tuple(ptok.shape) == rtok.shape and ptok.dtype == torch.int32
        assert len(pstate["caches"]) == cfg.n_layers
        flat = jax.tree_util.tree_flatten_with_path(rstate["caches"])[0]
        for path, leaf in flat:
            keys = [p.key for p in path]
            for cache in pstate["caches"]:
                node = cache
                for k in keys:
                    node = node[k]
                assert (cfg.n_layers,) + tuple(node.shape) == leaf.shape, keys
                assert node.dtype == _DT[jnp.dtype(leaf.dtype)], keys
                assert node.device.type == "meta"


def test_adamw_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rm = {k: jnp.zeros(v.shape, jnp.float32) for k, v in rp.items()}
    rv = dict(rm)
    rstep = jnp.zeros((), jnp.int32)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    tm = {k: torch.zeros(v.shape) for k, v in p.items()}
    tv = {k: torch.zeros(v.shape) for k, v in p.items()}
    tstep = torch.zeros((), dtype=torch.int32)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        rp, rm, rv, rstep = ref_steps._adamw(
            rp, {k: jnp.asarray(v) for k, v in g.items()}, rm, rv, rstep, lr=1e-2)
        before = {k: v.clone() for k, v in tp.items()}
        tp2, tm, tv, tstep = steps._adamw(
            tp, {k: torch.as_tensor(v) for k, v in g.items()}, tm, tv, tstep,
            lr=1e-2)
        for k in tp:   # the inputs are not touched
            assert torch.equal(tp[k], before[k])
        tp = tp2
    assert int(tstep) == int(rstep) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(rm[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tv[k].numpy(), np.asarray(rv[k]), rtol=0, atol=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert np.isclose(float(norm), 5.0)
    assert np.isclose(float(torch.linalg.norm(clipped["a"])), 1.0)
    # below the bound: unchanged
    small, norm = clip_by_global_norm({"a": torch.tensor([0.3, 0.4])}, 1.0)
    assert np.isclose(float(norm), 0.5) and torch.equal(small["a"], torch.tensor([0.3, 0.4]))
    # a mixed tree against the reference (dtype kept per leaf)
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32) * 3}
    tc, _ = clip_by_global_norm(
        {"w": torch.as_tensor(tree["w"]),
         "b": torch.as_tensor(tree["b"]).to(torch.bfloat16)}, 2.0)
    assert tc["b"].dtype == torch.bfloat16 and tc["w"].dtype == torch.float32
    rc, rn = ref_clip({k: jnp.asarray(v) for k, v in tree.items()}, 2.0)
    tc, tn = clip_by_global_norm({k: torch.as_tensor(v) for k, v in tree.items()}, 2.0)
    _scalar_close(tn, rn, 1e-6)
    for k in tree:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]), rtol=0, atol=1e-6)


def ref_host_mesh():
    """A one-device ("data", "model") mesh whose axes take sharding
    constraints (`Auto`; the reference's `make_host_mesh` gets `Explicit`
    axes on this jax, which `with_sharding_constraint` refuses)."""
    from jax.sharding import AxisType

    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _batch(cfg, b=4, s=32, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)}
    return batch


def _port_state(cfg, ref_params):
    lm = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), "cpu")
    params = {k: p.detach() for k, p in lm.named_parameters()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    return steps.TrainState(params, mu, {k: v.clone() for k, v in mu.items()},
                            torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch):
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    lr = 1e-6
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(0), jnp.float32)
    rstate = ref_steps.init_train_state(rcfg, jax.random.PRNGKey(0), jnp.float32)
    rstate = rstate._replace(params=rparams)
    batch = _batch(cfg)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, ref_host_mesh(), lr=lr))
    rnew, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})

    state = _port_state(cfg, rparams)
    before = {k: v.clone() for k, v in state.params.items()}
    step = steps.make_train_step(cfg, None, lr=lr)
    new, met = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in before:                       # the given state is untouched
        assert torch.equal(state.params[k], before[k])
        assert not torch.any(state.mu[k] != 0)
    assert int(new.step) == int(rnew.step) == 1
    for k in ("loss", "grad_norm", "ce"):
        _scalar_close(met[k], rmet[k])
    _scalar_close(met["moe_aux"] + 1.0, rmet["moe_aux"] + 1.0)
    rp = jax.tree.map(np.asarray, rnew.params)
    rm = jax.tree.map(np.asarray, rnew.mu)
    rv = jax.tree.map(np.asarray, rnew.nu)
    for name in new.params:
        _close(new.params[name], lm_reference_leaf(rp, name))
        _close(new.mu[name], lm_reference_leaf(rm, name))
        _close(new.nu[name], lm_reference_leaf(rv, name))


@pytest.mark.parametrize("arch", ("smollm-360m", "granite-moe-3b-a800m"))
def test_microbatch_equals_full_batch(arch):
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(1), jnp.float32)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, seed=4).items()}
    outs = []
    for mb in (1, 2):
        step = steps.make_train_step(cfg, None, lr=1e-6, microbatch=mb)
        outs.append(step(_port_state(cfg, rparams), batch))
    (a, ma), (b, mb_) = outs
    for k in ("loss", "grad_norm", "ce"):
        _scalar_close(mb_[k], ma[k])
    for name in a.params:
        _close(b.mu[name], a.mu[name])
        _close(b.params[name], a.params[name])


def test_init_train_state_defaults_to_bf16():
    cfg = get_arch("smollm-360m").reduced()
    st = steps.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in st.params.values())
    assert all(m.dtype == torch.float32 and not m.any() for m in st.mu.values())
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    specs_ = steps.train_state_shardings(
        type("M", (), {"axis_names": ("data", "model"),
                       "devices": np.zeros((2, 2))})(), st)
    assert specs_.step == () and specs_.params["embed"] == ("model", "data")
