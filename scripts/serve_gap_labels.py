"""A benchmark cell's traced run with every thread profiled, so that the
card's idle gaps are labelled by what the serving threads were doing.

    python3 scripts/serve_gap_labels.py --workload taper-serve --seed <n> [--seconds 10]

Needs the card. `gpbench/run.py --trace 1` profiles the thread that runs
the window, and `torch.profiler` records the ranges and ops of other
threads only when asked to (its experimental `profile_all_threads`); the
serving work runs on the batcher's worker thread, so its host-only spans
(`obs.host_span`) and ops never label a gap there. This runs the same cell,
through the benchmark's own driver and reducer, with that option on, and
prints the result line: `breakdown.idle_gaps` holds the ten longest gaps,
each labelled by the shortest host range or op that covers its middle.
Its times are not the cell's: every op of every thread is recorded, which
slows the host.
"""

from __future__ import annotations

import functools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch.profiler
    from torch._C._profiler import _ExperimentalConfig

    torch.profiler.profile = functools.partial(
        torch.profiler.profile,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    from gpbench import run

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--seconds" not in argv:
        argv += ["--seconds", "10"]
    return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
