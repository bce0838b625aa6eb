"""On the card: every cell runs once through the harness with a short
window and proves correct, and the TF32 control of each cell reads not
correct against the committed limits. Skips without a card.

    PYTHONPATH=src python3 -m pytest -q -m gpu gpbench/tests/test_gpbench_gpu.py
"""

from __future__ import annotations

import time

import pytest

from gpbench.harness import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, card):
    from gpbench.run import run_cell

    line = run_cell(manifest.find_cell(cell), seed=2**31 + 303, seconds=2.0, trace=False,
                    device="cuda", t_start=time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["device"]["kind"] == card


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell, card):
    from gpbench.controls import readings

    c = manifest.find_cell(cell)
    row = readings(c, 2**31 + 304, seconds=2.0, control=True, device="cuda")
    limits = c.config["limits"][manifest.load_driver(c.traffic["driver"]).LIMITS]
    assert any(row["tf32"][k] > v for k, v in limits.items()), row["tf32"]
