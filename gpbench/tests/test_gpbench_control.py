"""The control at a size a test run holds: the reference at TF32 in the
program's place (and, for training, each fault a training cell can have)
reads not correct against the committed limits; the program reads correct.
On the card at the cells' own sizes the same readings come from
`python3 gpbench/controls.py` (PERF.md gives them)."""

from __future__ import annotations

import pytest
import torch

from gpbench.controls import readings
from gpbench.harness import manifest

CELLS = ["he-train", "he-serve", "taper-serve"]


def _fails(nums: dict, limits: dict) -> list:
    return [k for k, v in limits.items() if not nums[k] <= v]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(cell, small_cell):
    torch.set_num_threads(2)
    c, overrides = small_cell(cell)
    row = readings(c, 2**31 + 211, seconds=0.3, control=True, device="cpu",
                   overrides=overrides)
    kind = manifest.load_driver(c.traffic["driver"]).LIMITS
    limits = c.config["limits"][kind]
    assert not _fails(row["checks"], limits), row["checks"]
    assert _fails(row["tf32"], limits), row["tf32"]
    if kind == "train":
        for fault in ("half", "altered"):
            assert _fails(row[fault], limits), (fault, row[fault])


def test_own_fit_readings(small_cell):
    """`--own-fit`: the answers against a float64 fit of the reference's
    own caches; at this size CG runs past its tolerance, and the program's
    answers lie far closer to them than the TF32 stand-in's."""
    torch.set_num_threads(2)
    c, overrides = small_cell("he-serve")
    row = readings(c, 2**31 + 213, seconds=0.3, control=True, device="cpu",
                   overrides=overrides, own_fit=True)
    own = row["own"]
    for k in ("mean_gap", "var_gap"):
        assert own["program"][k] < 1e-4 and own["tf32"][k] > 10 * own["program"][k], own
