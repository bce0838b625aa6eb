"""The port has the reference's public names, down to class members and
function parameters, and the ones the port added hold the reference's tests.

* Every reference module has a counterpart module in `repro_torch`.
* Each package's `__all__` (core, train, data, optim, models, serve,
  sparse, obs, kernels) holds the reference's names, and each module
  defines the public functions, classes and module constants the
  reference's module defines, except the names ruled out of the port:
    - `lax_map` (JAX-only);
    - `block_params` / `block_apply` / `block_decode` / `moe_params`,
      replaced by the LM's `nn.Module`s (`Block`, `MoE`);
    - the Pallas kernels (`kmvm_pallas*`, `kmvm_blocksparse_pallas`,
      `pallas_sorted_kmvm`), replaced by the CUDA kernels' wrappers;
    - `launch.roofline.collective_bytes`, which parses XLA HLO; the port
      prices `CommDebugMode`-counted collectives (`collective_stats`);
    - `kernels.kmvm.DEFAULT_BM` / `DEFAULT_BN`, the Pallas block shape:
      the Hopper launch's row tile is fixed at 64 by the `mma.sync`
      fragment layout, and its column split depends on n only, which
      keeps a row's result independent of the launch's rows
      (`tests/test_torch_gpu.py::test_row_results_do_not_depend_on_launch_rows`).
* Every public method, property and classmethod of every public class of
  the reference (read from its source) exists on the port's class.
* Every public function's and method's parameters are the reference's: each
  name is in the port's signature, the positional ones in the reference's
  places, a `*args` / `**kwargs` where the reference has one, and every
  parameter the port adds has a default, so a call written against the
  reference binds. The recorded differences, and only these:
    - `key` -> `generator` everywhere: the port draws from explicit
      `torch.Generator`s. Some became keyword-only (`init_sgpr_params`,
      `fit_posterior`, `ServeFleet.observe`, ...); the positional check
      stops at the first parameter the port takes by keyword only;
    - `params` -> `lm` in `models.model` and `models.sharding`: the LM is
      a stack of `nn.Module`s, not a parameter tree;
    - `interpret` is dropped everywhere: it runs a Pallas kernel in the
      interpreter, and a port kernel's plain version runs exactly when its
      tensor lies on the CPU;
    - `platform` is dropped from `kernels.autotune`: the key's card is its
      `device_name` (which also replaces the key's `interpret` field);
    - `bm` / `bn` are dropped from `kernels.ops` (`kmvm_block`,
      `kmvm_fused_matmat`, `pallas_block_fn`) for the reason of
      `DEFAULT_BM` / `DEFAULT_BN` above; a call that passes them raises
      `TypeError` rather than being ignored.
* Mirrors of the reference's tests of the names added here:
  `default_row_block` (`tests/test_partitioned.py:86`), `num_components`
  (`tests/test_kernel_algebra.py:215`), `slq_logdet(..., with_aux=True)`
  (`tests/test_obs.py:436`), and `lengthscale` / `outputscale`,
  `solve_tolerance_iters`, `quad_form`, `kernel_rows` against the
  reference on the same inputs. The members added with the signature
  check are held against the reference in tests/test_torch_api_surface.py.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import ast
import importlib
import importlib.util
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro

RULED_OUT = {"lax_map", "block_params", "block_apply", "block_decode",
             "moe_params", "kmvm_pallas", "kmvm_pallas_chunk",
             "kmvm_pallas_dots", "kmvm_blocksparse_pallas",
             "pallas_sorted_kmvm", "collective_bytes", "DEFAULT_BM",
             "DEFAULT_BN"}
RENAMED = {"key": "generator"}
RENAMED_IN = {"repro.models.model": {"params": "lm"},
              "repro.models.sharding": {"params": "lm"}}
DROPPED = {"interpret"}
DROPPED_IN = {"repro.kernels.autotune": {"platform"},
              "repro.kernels.ops": {"bm", "bn"}}
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


def _source_tree(name: str) -> ast.Module:
    """A reference module's syntax tree, read from its source: importing
    some of them has side effects (the dry run sets XLA flags for the whole
    process)."""
    spec = importlib.util.find_spec(name)
    with open(spec.origin) as f:
        return ast.parse(f.read())


def _defined_in_source(name: str) -> set:
    """Public top-level functions, classes and assigned names (constants)
    of a reference module."""
    names = set()
    for node in _source_tree(name).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("name", _ref_modules())
def test_module_defines_the_reference_names(name):
    port = importlib.import_module(_port_name(name))
    missing = sorted(_defined_in_source(name) - set(dir(port)) - RULED_OUT)
    assert missing == []


def _public_classes(name: str) -> list:
    return [node for node in _source_tree(name).body
            if isinstance(node, ast.ClassDef) and not node.name.startswith("_")
            and node.name not in RULED_OUT]


def _public_defs(body) -> list:
    return [node for node in body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not node.name.startswith("_") and node.name not in RULED_OUT]


@pytest.mark.parametrize("name", _ref_modules())
def test_class_members_hold_the_reference_names(name):
    """Every public method, property, classmethod and staticmethod of every
    public class of the reference module exists on the port's class."""
    port = importlib.import_module(_port_name(name))
    missing = []
    for cls in _public_classes(name):
        port_cls = getattr(port, cls.name)
        missing += [f"{cls.name}.{fn.name}" for fn in _public_defs(cls.body)
                    if not hasattr(port_cls, fn.name)]
    assert missing == []


def _callables(name: str, port) -> list:
    """(label, reference FunctionDef, port callable) of every public
    function and every public non-property method of the module."""
    out = [(fn.name, fn, getattr(port, fn.name))
           for fn in _public_defs(_source_tree(name).body)]
    for cls in _public_classes(name):
        port_cls = getattr(port, cls.name)
        for fn in _public_defs(cls.body):
            obj = inspect.getattr_static(port_cls, fn.name)
            if isinstance(obj, property):
                continue
            out.append((f"{cls.name}.{fn.name}", fn,
                        getattr(obj, "__func__", obj)))  # unbound, with self / cls
    return out


def _signature_gaps(name: str, label: str, ref_fn, port_fn) -> list:
    params = inspect.signature(port_fn).parameters.values()
    # a rename applies where the port lacks the reference's name (`key` is
    # also a cache key's name, kept as it is in `autotune.key_hash`)
    renamed = {k: v for k, v in {**RENAMED, **RENAMED_IN.get(name, {})}.items()
               if k not in {p.name for p in params}}
    dropped = DROPPED | DROPPED_IN.get(name, set())
    a = ref_fn.args
    ref_pos = [renamed.get(x.arg, x.arg) for x in a.posonlyargs + a.args
               if x.arg not in dropped]
    ref_kw = [renamed.get(x.arg, x.arg) for x in a.kwonlyargs
              if x.arg not in dropped]
    pos = [p.name for p in params
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    kw_only = {p.name for p in params if p.kind == p.KEYWORD_ONLY}
    kinds = {p.kind for p in params}
    gaps = [f"{label}: no parameter {n!r}" for n in ref_pos + ref_kw
            if n not in pos and n not in kw_only]
    for i, n in enumerate(ref_pos):
        if n in kw_only or n not in pos:
            break
        if i >= len(pos) or pos[i] != n:
            gaps.append(f"{label}: positional {n!r} at {pos.index(n)}, "
                        f"the reference's at {i}")
    if a.vararg is not None and inspect.Parameter.VAR_POSITIONAL not in kinds:
        gaps.append(f"{label}: no *{a.vararg.arg}")
    if a.kwarg is not None and inspect.Parameter.VAR_KEYWORD not in kinds:
        gaps.append(f"{label}: no **{a.kwarg.arg}")
    ref_names = set(ref_pos) | set(ref_kw)
    gaps += [f"{label}: added parameter {p.name!r} has no default"
             for p in params if p.name not in ref_names
             and p.default is p.empty
             and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    return gaps


@pytest.mark.parametrize("name", _ref_modules())
def test_function_parameters_hold_the_reference_names(name):
    """Every public function's and method's parameters are the reference's,
    up to the recorded renames and drops (module docstring)."""
    port = importlib.import_module(_port_name(name))
    gaps = []
    for label, ref_fn, port_fn in _callables(name, port):
        gaps += _signature_gaps(name, label, ref_fn, port_fn)
    assert gaps == []


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
