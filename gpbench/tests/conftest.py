"""Shared set-up of the benchmark's own tests: the checkout's `src/` and
root on the path, and small CPU versions of the cells."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# configuration overrides that make each configuration small enough for the
# CPU (the shapes of the kernels and the solver settings are the same)
SMALL = {
    "houseelectric-2e16": {"data": {"n": 512}, "gp": {"lanczos_rank": 16}},
    "taper-2e18": {"data": {"n": 1024}, "gp": {"lanczos_rank": 16}},
}
SMALL_TRAFFIC = {"clients": 2, "rows": 64, "check_requests": 4}


@pytest.fixture
def small_cell():
    """`small_cell(name)`: the manifest's cell with a small traffic mix,
    and the configuration overrides that shrink it."""
    from gpbench.harness import manifest

    def make(name):
        cell = manifest.find_cell(name)
        if "clients" in cell.traffic:
            cell = cell._replace(traffic=dict(cell.traffic, **SMALL_TRAFFIC))
        return cell, SMALL[cell.config["name"]]

    return make


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the program's CUDA kernels run only there")
    return torch.cuda.get_device_name(0)
