"""Run one cell of the benchmark once and print its result line.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, its driver, data maker,
query generator, reference kernel and metrics come from BENCHMARK.json at
the checkout's root and the files they name (see
`gpbench/harness/manifest.py`). The program under test is `repro_torch`,
imported from the checkout's `src/`. With `--trace 0` the result carries
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from the traced window (`torch.profiler` and the program's own spans and
counters). Every run checks what the timed path produced against the plain
reference (`gpbench/reference/`) and prints each compared number beside its
limit. It exits without a result when the cards the cell asks for are not
there, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, overrides=None, fault=None) -> dict:
    """Run `cell` once on `device` and emit its result line (returned)."""
    from gpbench.harness import device as dev_mod
    from gpbench.harness import manifest, output
    from gpbench.harness.isolation import check_isolation
    from gpbench.harness.window import Context

    run_dir = os.path.join(ROOT, "build", "gpbench",
                           f"{cell.name}-{seed}-trace{int(trace)}")
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, t_start=t_start, run_dir=run_dir,
                  overrides=overrides or {}, fault=fault)
    driver = manifest.load_driver(cell.traffic["driver"], cell.bench)
    out = driver.run(ctx)
    check_isolation()
    metrics, breakdown = {}, None
    dev = dev_mod.device_record(cell.chips, out.peak_bytes)
    if trace:
        rec = dict(out.records, cell=cell.name)
        for m in cell.per_layer:
            value = manifest.load_reader(m["name"], cell.bench)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = out.records.get("profile") or {}
        dev.update(busy_s=prof.get("busy_s", 0.0), window_s=prof.get("window_s", 0.0))
        breakdown = {"device_ops": prof.get("device_ops", []),
                     "idle_gaps": prof.get("idle_gaps", [])}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    return output.emit(checks=out.checks, attempted=out.attempted,
                       failed=out.failed, metrics=metrics, device=dev,
                       breakdown=breakdown)


def main(argv=None) -> int:
    args = parse(argv)
    from gpbench.harness import device, manifest

    device.prepare_process()
    cell = manifest.find_cell(args.workload)
    device.require_cards(cell.chips)
    import torch

    torch.set_num_threads(4)
    run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
             device="cuda", t_start=T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
