"""The port has the reference's public names, and the ones this slice
added hold the reference's tests.

* Every reference module has a counterpart module in `repro_torch`.
* Each package's `__all__` (core, train, data, optim, models, serve,
  sparse, obs, kernels) holds the reference's names, and each module
  defines the public functions and classes the reference's module defines,
  except the names ruled out of the port:
    - `lax_map` (JAX-only);
    - `block_params` / `block_apply` / `block_decode` / `moe_params`,
      replaced by the LM's `nn.Module`s (`Block`, `MoE`);
    - the Pallas kernels (`kmvm_pallas*`, `kmvm_blocksparse_pallas`,
      `pallas_sorted_kmvm`), replaced by the CUDA kernels' wrappers;
    - `launch.roofline.collective_bytes`, which parses XLA HLO; the port
      prices `CommDebugMode`-counted collectives (`collective_stats`).
* Mirrors of the reference's tests of the names added here:
  `default_row_block` (`tests/test_partitioned.py:86`), `num_components`
  (`tests/test_kernel_algebra.py:215`), `slq_logdet(..., with_aux=True)`
  (`tests/test_obs.py:436`), and `lengthscale` / `outputscale`,
  `solve_tolerance_iters`, `quad_form`, `kernel_rows` against the
  reference on the same inputs.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import ast
import importlib
import importlib.util
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro

RULED_OUT = {"lax_map", "block_params", "block_apply", "block_decode",
             "moe_params", "kmvm_pallas", "kmvm_pallas_chunk",
             "kmvm_pallas_dots", "kmvm_blocksparse_pallas",
             "pallas_sorted_kmvm", "collective_bytes"}
PACKAGES = ("core", "train", "data", "optim", "models", "serve", "sparse",
            "obs", "kernels")


def _ref_modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro.__path__, "repro."))


def _port_name(name: str) -> str:
    return "repro_torch." + name[len("repro."):]


def test_every_reference_module_has_a_counterpart():
    missing = []
    for name in _ref_modules():
        try:
            importlib.import_module(_port_name(name))
        except ModuleNotFoundError:
            missing.append(name)
    assert missing == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_all_holds_the_reference_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref_names = set(getattr(ref, "__all__", ()))
    port_names = set(getattr(port, "__all__", ()))
    assert ref_names - port_names - RULED_OUT == set()
    for n in port_names:
        assert hasattr(port, n), n


def _defined_in_source(name: str) -> set:
    """Public top-level functions and classes of a reference module, read
    from its source: importing some of them has side effects (the dry run
    sets XLA flags for the whole process)."""
    spec = importlib.util.find_spec(name)
    with open(spec.origin) as f:
        tree = ast.parse(f.read())
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))
            and not node.name.startswith("_")}


@pytest.mark.parametrize("name", _ref_modules())
def test_module_defines_the_reference_names(name):
    port = importlib.import_module(_port_name(name))
    missing = sorted(_defined_in_source(name) - set(dir(port)) - RULED_OUT)
    assert missing == []


def test_default_row_block_hbm_budget():
    from repro_torch.core.partitioned import default_row_block

    rb = default_row_block(n=1 << 20, d=9, t=9, hbm_budget_bytes=2 << 30)
    assert rb % 128 == 0
    assert rb * (1 << 20) * 4 <= (2 << 30) + 128 * (1 << 20) * 4
    assert default_row_block(n=100, d=1, t=1) == 8192  # clamped high
    from repro.core.partitioned import default_row_block as ref

    for n in (1, 100, 5000, 1 << 20, 1 << 24):
        assert default_row_block(n, 3, 2) == ref(n, 3, 2)


def test_num_components_and_scales():
    from repro.core import kernels_math as rkm
    from repro_torch.core import kernels_math as km

    spec = km.parse_kernel("0.5*rbf + matern32")
    kp = km.init_kernel_params(spec, lengthscale=0.9, noise=0.2)
    assert km.num_components(spec) == 2
    for expr in ("rbf", "matern32", "0.5*rbf + matern32", "(rbf + linear) * matern52",
                 "scale(rq)*linear + rbf * wendland2"):
        assert km.num_components(km.parse_kernel(expr)) == \
            rkm.num_components(rkm.parse_kernel(expr)), expr
    assert km.num_components("matern32") == 1
    p = km.init_params(noise=0.3, lengthscale=0.7, outputscale=1.3)
    rp = rkm.init_params(noise=0.3, lengthscale=0.7, outputscale=1.3)
    assert float(km.lengthscale(p)) == pytest.approx(float(rkm.lengthscale(rp)), rel=1e-6)
    assert float(km.outputscale(p)) == pytest.approx(float(rkm.outputscale(rp)), rel=1e-6)
    assert float(km.lengthscale(p)) == pytest.approx(0.7, rel=1e-6)


def test_solve_tolerance_iters_matches_reference():
    from repro.core.pcg import solve_tolerance_iters as ref
    from repro_torch.core.pcg import solve_tolerance_iters

    for tol in (5.0, 1.0, 0.5, 0.1, 0.05, 0.01, 1e-3, 1e-8):
        assert solve_tolerance_iters(tol) == ref(tol)


def test_quad_form_and_kernel_rows_match_reference():
    from repro.core import init_params as ref_init
    from repro.core.partitioned import kernel_rows as ref_rows
    from repro.core.partitioned import quad_form as ref_quad
    from repro_torch.core.kernels_math import init_params
    from repro_torch.core.partitioned import kernel_rows, quad_form

    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, 3))
    A, B = rng.normal(size=(96, 4)), rng.normal(size=(96, 4))
    idx = np.array([3, 0, 17, 95])
    rp = ref_init(noise=0.3, dtype=jnp.float64)
    p = init_params(noise=0.3, dtype=torch.float64)
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    for add_noise in (True, False):
        got = quad_form("matern32", T(X), T(A), T(B), p, row_block=32,
                        add_noise=add_noise)
        want = ref_quad("matern32", jnp.asarray(X), jnp.asarray(A),
                        jnp.asarray(B), rp, row_block=32, add_noise=add_noise)
        assert float(got) == pytest.approx(float(want), rel=1e-10)
    got1 = quad_form("matern32", T(X), T(A[:, 0]), T(B[:, 0]), p, row_block=32)
    want1 = ref_quad("matern32", jnp.asarray(X), jnp.asarray(A[:, 0]),
                     jnp.asarray(B[:, 0]), rp, row_block=32)
    assert float(got1) == pytest.approx(float(want1), rel=1e-10)
    rows = kernel_rows("matern32", T(X), T(idx), p)
    np.testing.assert_allclose(rows.numpy(), np.asarray(
        ref_rows("matern32", jnp.asarray(X), jnp.asarray(idx), rp)),
        rtol=1e-12, atol=1e-14)


def test_slq_with_aux():
    from repro_torch.core.kernels_math import init_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.core.slq import SLQAux, slq_logdet

    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(64, 2)))
    params = init_params(noise=0.3, dtype=X.dtype)
    op = make_operator(OperatorConfig(kernel="matern32",
                                      backend="partitioned", row_block=32),
                       X, params, device="cpu")
    ld, aux = slq_logdet(op, torch.Generator().manual_seed(0), num_probes=4,
                         precond_rank=10, max_iters=30, tol=1e-6,
                         with_aux=True)
    assert isinstance(aux, SLQAux) and aux.num_probes == 4
    assert aux.iterations.shape == (4,) and bool(torch.all(aux.iterations > 0))
    assert aux.rel_residual.shape == (4,)
    ld_plain = slq_logdet(op, torch.Generator().manual_seed(0), num_probes=4,
                          precond_rank=10, max_iters=30, tol=1e-6)
    assert float(ld) == float(ld_plain)


def test_launch_modules_public_names():
    """launch has no `__all__` in either package: its modules' names are
    held by `test_module_defines_the_reference_names`; here the LM path's
    entry points are importable where the reference has them."""
    from repro_torch.launch import dryrun, mesh, roofline, specs, steps

    for mod, names in ((mesh, ("make_production_mesh", "make_host_mesh",
                               "mesh_axis_sizes", "data_axes")),
                       (steps, ("TrainState", "init_train_state",
                                "train_state_shardings", "make_train_step",
                                "make_prefill_step", "make_decode_step",
                                "metrics_shardings", "make_gp_train_step",
                                "make_gp_predict_setup")),
                       (specs, ("SHAPES", "Cell", "cell_for", "input_specs",
                                "decode_specs", "gp_cells", "gp_input_specs")),
                       (roofline, ("Roofline", "analyze", "peak_flops_for",
                                   "model_flops_for", "format_row")),
                       (dryrun, ("run_lm_cell", "run_gp_cell", "main",
                                 "_two_pass", "_extrapolate"))):
        for n in names:
            assert hasattr(mod, n), (mod.__name__, n)
