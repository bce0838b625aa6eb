"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
top-level name whole; the reference loads nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from gpbench.harness.isolation import FORBIDDEN, forbidden_loaded

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_SCAN = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import {mods}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(mods: str) -> list:
    code = _SCAN.format(root=ROOT, src=os.path.join(ROOT, "src"), mods=mods)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_compare_whole():
    assert forbidden_loaded(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert forbidden_loaded(["repro.core"]) == ["repro"]
    assert forbidden_loaded(["jax._src", "flax"]) == ["flax", "jax"]
    assert {"jax", "jaxlib", "flax", "repro", "benchmarks"} == FORBIDDEN


def _parts(folder: str) -> list:
    d = os.path.join(ROOT, "gpbench", *folder.split("/"))
    return sorted(f[:-3] for f in os.listdir(d) if f.endswith(".py") and f != "__init__.py")


def test_reference_loads_nothing_of_the_program():
    """The reference, the counts, the data makers and the query generators,
    every file of each loaded as the harness loads it."""
    load = "; ".join(
        [f"gpbench.reference.load_kernel({k!r})" for k in _parts("reference/kernels")]
        + [f"load_part('data', {m!r})" for m in _parts("data")]
        + [f"load_part('queries', {q!r})" for q in _parts("queries")])
    mods = _loaded("gpbench.reference, gpbench.counts, gpbench.data\n"
                   "from gpbench.harness.manifest import load_part\n" + load)
    assert forbidden_loaded(mods) == []
    assert not [m for m in mods if m.split(".")[0] == "repro_torch"]


@pytest.mark.parametrize("driver", _parts("drivers"))
def test_harness_and_program_load_no_jax(driver):
    mods = _loaded("gpbench.harness.trace, gpbench.run, repro_torch.train.gp_trainer, "
                   "repro_torch.serve\nfrom gpbench.harness.manifest import load_driver\n"
                   f"load_driver({driver!r})")
    assert forbidden_loaded(mods) == []
