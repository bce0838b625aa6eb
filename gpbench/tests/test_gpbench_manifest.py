"""The manifest against the contract, and the harness finding every file by
the name the manifest or a configuration or mix gives it; a new cell,
configuration, data maker, reference kernel, traffic mix, driver, query
generator and metric take only new files and new entries."""

from __future__ import annotations

import json
import os
import re
import shutil
import time

import pytest

from gpbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HERE = os.path.dirname(os.path.abspath(__file__))


def _man():
    return manifest.load_manifest()


def test_top_level_keys_and_sizes():
    man = _man()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert man["command"] == ["python3", "gpbench/run.py"]
    assert man["paths"] == ["gpbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16 and 1 <= len(man["per_layer"]) <= 128


def test_entries_keys_names_units():
    man = _man()
    names = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gpbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_every_cell_resolves(cell):
    """Every file a cell names is found by its name: the driver, the data
    maker, the query generator, the reference kernel and the readers."""
    from gpbench.reference import load_kernel

    c = manifest.find_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(manifest.load_reader(m["name"]))
    driver = manifest.load_driver(c.traffic["driver"])
    assert callable(driver.run) and callable(driver.controls)
    assert callable(manifest.load_part("data", c.config["data"]["maker"]).make)
    if "queries" in c.traffic:
        assert callable(manifest.load_part("queries", c.traffic["queries"]).rows)
    kern = load_kernel(c.config["gp"]["reference_kernel"])
    assert set(kern.LEAVES) <= set(c.config["leaves"])
    limits = c.config["limits"][driver.LIMITS]
    assert limits and all(v > 0 for v in limits.values())


def test_a_new_cell_takes_only_new_files(tmp_path):
    """Copies the benchmark, then adds from tests/fixture, by new files and
    new manifest entries only, a configuration with a data maker and a
    reference kernel of its own, a traffic mix with its own driver (loop)
    and query generator, an end-to-end and a per-layer metric and a cell;
    finds each by name and runs the cell on the CPU through `run_cell`."""
    from gpbench.run import run_cell

    root = tmp_path / "checkout"
    bench = root / "gpbench"
    shutil.copytree(manifest.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    fx = os.path.join(HERE, "fixture")
    added = []
    for dirpath, _, files in os.walk(os.path.join(fx, "bench")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), os.path.join(fx, "bench"))
            assert not (bench / rel).exists(), f"{rel} is not a new file"
            (bench / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(os.path.join(dirpath, f), bench / rel)
            added.append(rel)
    assert {r.split(os.sep)[0] for r in added} >= {
        "configs", "traffic", "metrics", "drivers", "data", "queries", "reference"}
    man = _man()
    with open(os.path.join(fx, "entries.json")) as f:
        add = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        man[key].append(add[key])
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(man, f)
    cell = manifest.find_cell("tiny-serve", root=str(root), bench=str(bench))
    assert cell.config["name"] == "tiny-config" and cell.traffic["name"] == "tiny-mix"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "tiny_rows_per_s"}
    assert {m["name"] for m in cell.per_layer} == {"tiny.requests"}
    for trace in (False, True):
        line = run_cell(cell, seed=2**31 + 5, seconds=1.0, trace=trace, device="cpu",
                        t_start=time.perf_counter())
        assert line["correct"], line["checks"]
        assert line["checks"]["sum_gap"]["value"] < 1e-9
    assert set(line["metrics"]) == {"tiny.requests"} and line["metrics"]["tiny.requests"]["value"] == 5
    # the cells already there are found as before, with the same files
    he = manifest.find_cell("he-serve", root=str(root), bench=str(bench))
    assert he.chips == 1 and he.traffic["driver"] == "closed_loop"
