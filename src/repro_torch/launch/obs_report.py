"""obs_report — turn a span-trace JSONL into a per-phase table.

    PYTHONPATH=src python -m repro_torch.launch.obs_report trace.jsonl \
        [--root fit_exact_gp] [--compare-model] [--hbm-gbps 3350] \
        [--health health.jsonl] [--json]

The counterpart of `repro.launch.obs_report`, with its flags and output.
Input is what `repro_torch.obs` tracing writes (REPRO_TORCH_OBS_TRACE=
trace.jsonl, or `obs.trace_session(path)` around any entry point — e.g.
`repro_torch.launch.train --obs-trace`). Output: the per-phase wall-clock
breakdown (self-time attribution, so phase rows partition the root span's
duration exactly — untracked host time appears as "(self)" rows), a
per-request serve section when the trace carries `req:<rid>` flows, and
the metrics-registry snapshot the trace carries.

`--compare-model` adds the measured-vs-modeled table: per (backend,
phase) measured wall ms set against the cost model's byte prediction,
converted to ms at `--hbm-gbps` (default: the H100 SXM's 3350 GB/s; see
`repro_torch.obs.measure`). `--health <jsonl>` summarizes a solver
health-event log (REPRO_TORCH_OBS_HEALTH) alongside the trace.

The same JSONL loads in Perfetto / chrome://tracing after
`jq -s . trace.jsonl > trace.json`.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.obs.health import load_health, summarize_health
from repro_torch.obs.measure import (
    DEFAULT_HBM_GBPS,
    format_model_comparison,
    phase_model_comparison,
)
from repro_torch.obs.report import (
    assign_self_times,
    format_report,
    load_trace,
    phase_breakdown,
    request_breakdown,
    split_request_spans,
)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="obs_report",
        description="Per-phase breakdown of a repro_torch.obs trace JSONL")
    ap.add_argument("trace", help="trace JSONL written by repro_torch.obs "
                                  "(or repro.obs)")
    ap.add_argument("--root", default="fit_exact_gp",
                    help="span name treated as the wall-clock root "
                         "(default: fit_exact_gp; falls back to the trace "
                         "extent when absent)")
    ap.add_argument("--compare-model", action="store_true",
                    help="append the measured-vs-modeled per-phase table "
                         "(needs a trace from a traced fit: the engine's "
                         "phased dispatch stamps measured_ms + modeled "
                         "bytes on each phase span)")
    ap.add_argument("--hbm-gbps", type=float, default=DEFAULT_HBM_GBPS,
                    help="reference HBM bandwidth for modeled-bytes -> "
                         "modeled-ms conversion (default %(default)s)")
    ap.add_argument("--health", default=None,
                    help="solver health-event JSONL (REPRO_TORCH_OBS_HEALTH) to "
                         "summarize alongside the trace")
    ap.add_argument("--json", action="store_true",
                    help="emit the breakdown as JSON instead of markdown")
    args = ap.parse_args(argv)

    events, metrics = load_trace(args.trace)
    spans = assign_self_times(events)
    phase_spans, req_spans = split_request_spans(spans)

    if args.json:
        rows, wall = phase_breakdown(phase_spans, root=args.root)
        payload = {
            "trace": args.trace,
            "wall_ms": wall,
            "phases": [r._asdict() for r in rows],
            "requests": request_breakdown(req_spans),
            "metrics": metrics,
        }
        if args.compare_model:
            payload["model_comparison"] = phase_model_comparison(
                events, hbm_gbps=args.hbm_gbps)
        if args.health:
            payload["health"] = summarize_health(load_health(args.health))
        print(json.dumps(payload, indent=1))
        return

    print(format_report(args.trace, root=args.root))
    if args.compare_model:
        rows = phase_model_comparison(events, hbm_gbps=args.hbm_gbps)
        print("\n## Measured vs modeled\n")
        print(format_model_comparison(rows, hbm_gbps=args.hbm_gbps))
    if args.health:
        summary = summarize_health(load_health(args.health))
        print("\n## Solver health\n")
        if not summary:
            print("(no health events)")
        for kind, info in sorted(summary.items()):
            print(f"- {kind}: {info['count']} event(s), worst severity "
                  f"{info['severity']}; last: {info['last']}")


if __name__ == "__main__":
    main()
