"""The benchmark's manifest and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name the manifest
or another file gives it:

    <root>/BENCHMARK.json                   the cells and the metrics
    <bench>/configs/<config>.json           a configuration (the manifest's `file`)
    <bench>/traffic/<traffic>.json          a traffic mix: the parameters its driver reads
    <bench>/metrics/<metric>.py             a per-layer metric's reader, `read(rec)`
    <bench>/drivers/<driver>.py             the loop a mix names (`"driver"`):
                                            `run(ctx)` and `controls(cap, full)`
    <bench>/data/<maker>.py                 a configuration's data maker
                                            (`"data": {"maker": ...}`), `make(...)`
    <bench>/queries/<queries>.py            a mix's query generator (`"queries"`),
                                            `rows(pool, seed, client, k, rows)`
    <bench>/reference/kernels/<kernel>.py   the plain reference's kernel function a
                                            configuration names (`"reference_kernel"`)

`root` is the checkout's root and `bench` the benchmark's folder; a test
points both at a directory of its own. A configuration as a cell carries it
holds its folder under the key "bench", so that every file it names is
found there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import NamedTuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # the configuration file's content, plus "name" and "bench"
    traffic: dict         # the traffic file's content, plus its "name"
    end_to_end: tuple     # the manifest's entries of this cell's e2e metrics
    per_layer: tuple      # the manifest's entries of this cell's layer metrics
    bench: str = BENCH    # the benchmark folder its files were found in


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether `cell` reports the metric: listed under its `workloads`, or,
    without that key, every cell that reports what it moves (end-to-end
    metrics without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def find_cell(name: str, root: str = ROOT, bench: str = BENCH) -> Cell:
    """The cell `name` of the manifest under `root`, with its configuration,
    traffic and metrics."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(known: {sorted(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in man["configs"]}
    centry = cfgs[w["config"]]
    with open(os.path.join(root, centry["file"])) as f:
        config = dict(json.load(f), name=w["config"], bench=bench)
    with open(os.path.join(bench, "traffic", f"{w['traffic']}.json")) as f:
        traffic = dict(json.load(f), name=w["traffic"])
    e2e = tuple(m for m in man["end_to_end"] if _reports(m, name, set()))
    names = {m["name"] for m in e2e}
    layer = tuple(m for m in man["per_layer"] if _reports(m, name, names))
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer, bench)


_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_LOADED: dict = {}


def load_part(folder: str, name: str, bench: str = BENCH):
    """The module <bench>/<folder>/<name>.py, loaded once per path."""
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(bench, folder, f"{name}.py")
    if path not in _LOADED:
        tag = re.sub(r"[^A-Za-z0-9_]", "_", f"{folder}_{name}")
        spec = importlib.util.spec_from_file_location(f"gpbench_{tag}", path)
        if spec is None or not os.path.exists(path):
            raise FileNotFoundError(f"no {folder} file {name!r} under {bench}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def load_reader(metric: str, bench: str = BENCH):
    """The `read(rec)` function of <bench>/metrics/<metric>.py."""
    return load_part("metrics", metric, bench).read


def load_driver(name: str, bench: str = BENCH):
    """The driver module <bench>/drivers/<name>.py."""
    return load_part("drivers", name, bench)
