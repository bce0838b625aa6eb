"""The port's distributed engine against the reference's, both on 4 ranks.

The reference runs in a subprocess on 4 fake CPU devices
(`--xla_force_host_platform_device_count`, the pattern of its own
tests/test_distributed.py): `dist_kmvm` in the 1-D and 2-D layouts, serial
and overlapped, at n = 256 and a padded n = 250, and `make_mean_cache_solve`,
on a 2 x 2 (data x model) mesh, writing .npz files. The port computes the
same on a gloo world of 4 (tests/_torch_dist_worker.py) from the same numpy
inputs. fp64, matern32, d = 6; tolerance 1e-10. (The hex pins of
tests/test_distributed_2d.py are not used: that test already fails on this
tree.)
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_dist_worker as worker  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map

from repro.core import init_params
from repro.core.distributed import (
    DistMLLConfig, dist_kmvm, make_geometry, make_mean_cache_solve,
    pad_to_geometry, replicate, shard_vector)

inp = np.load(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"))
params = init_params(noise=0.2, dtype=jnp.float64)
out = {}
for n in (256, 250):
    X = jnp.asarray(inp["X"][:n])
    for mode in ("1d", "2d"):
        for overlap in (False, True):
            geom = make_geometry(mesh, n, X.shape[1], mode=mode, row_block=32,
                                 overlap=overlap)
            f = jax.jit(shard_map(
                lambda Xr, V_loc: dist_kmvm(geom, "matern32", Xr, V_loc, params),
                mesh=mesh, in_specs=(P(), geom.vector_pspec()),
                out_specs=geom.vector_pspec(), check_rep=False))
            o = f(replicate(mesh, pad_to_geometry(geom, X)),
                  shard_vector(mesh, geom, jnp.asarray(inp["V"][:n])))
            out[f"mvm_{n}_{mode}_{int(overlap)}"] = np.asarray(o)[:n]
        cfg = DistMLLConfig(kernel="matern32", precond_rank=40)
        solve = make_mean_cache_solve(mesh, geom, cfg, tol=1e-10, max_iters=400)
        a, _ = solve(replicate(mesh, pad_to_geometry(geom, X)),
                     shard_vector(mesh, geom, jnp.asarray(inp["y"][:n])), params)
        out[f"solve_{n}_{mode}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from repro_torch.core.kernels_math import init_params

    tmp = tmp_path_factory.mktemp("ref")
    rng = np.random.default_rng(11)
    n, d = 256, 6
    X = rng.normal(size=(n, d))
    inp = {"X": X, "V": rng.normal(size=(n, 3)),
           "y": np.sin(X @ rng.normal(size=d)) + 0.1 * rng.normal(size=n)}
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"), str(tmp / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    (tmp / "port").mkdir()
    port = worker.spawn("ref_cases", 4, {
        **inp, "params": init_params(noise=0.2, dtype=torch.float64)},
        tmp / "port")
    stdout, stderr = proc.communicate(timeout=600)
    assert "REF_OK" in stdout, stderr[-3000:]
    return dict(np.load(tmp / "ref.npz")), port


KEYS = [f"mvm_{n}_{mode}_{ov}" for n in (256, 250) for mode in ("1d", "2d")
        for ov in (0, 1)] + [f"solve_{n}_{mode}" for n in (256, 250)
                             for mode in ("1d", "2d")]


@pytest.mark.parametrize("key", KEYS)
def test_port_matches_reference_engine(both, key):
    ref, port = both
    for out in port:
        assert out[key].shape == ref[key].shape
        assert np.max(np.abs(out[key] - ref[key])) < 1e-10
