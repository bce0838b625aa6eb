"""Trace-to-table: turn a span JSONL into a per-phase breakdown.

The counterpart of `repro.obs.report`, reading the same Chrome-trace JSONL
(either package's):

* `load_trace(path)` — parse events + the final metrics snapshot.
* `assign_self_times(events)` — per-tid interval nesting (the containment
  rule Chrome uses to draw stacks) attributes each span's SELF time =
  duration minus its direct children. Self times partition wall clock:
  summing self over all spans reproduces the root span's duration, so
  "phase total vs wall clock" is an identity, not an estimate — any gap
  shows up as the parent's own self time (printed as `<name> (self)` when
  a parent also has children).
* `phase_breakdown(events)` — aggregate self time by span name: count,
  total/self ms, % of wall.
* `format_report(...)` — the printable table plus the metrics section
  (counters, gauges, histogram summaries).

Consumed by `repro_torch.launch.obs_report`.
"""

from __future__ import annotations

import json
from typing import Any, NamedTuple


class Span(NamedTuple):
    name: str
    ts: float          # us
    dur: float         # us
    tid: int
    args: dict
    self_us: float     # dur minus direct children (assign_self_times)
    depth: int


def load_trace(path: str) -> tuple[list[dict], dict | None]:
    """Parse a trace JSONL -> (events, metrics_snapshot_or_None).

    Tolerates a Chrome-JSON-array export too (a file starting with '[').
    Garbled JSONL lines are SKIPPED, not fatal: a process killed mid-write
    leaves a truncated last line, and the whole point of the signal-flushed
    sink is that such a trace is still readable. Non-dict entries are
    dropped for the same reason. The LAST `repro.metrics` metadata event
    wins (one is appended per `disable_tracing()` flush).
    """
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("["):
        raw = json.loads(text)
        if isinstance(raw, dict):  # chrome {"traceEvents": [...]}
            raw = raw.get("traceEvents", [])
    else:
        raw = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                raw.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # truncated tail / interleaved garbage
    metrics = None
    events = []
    for ev in raw:
        if not isinstance(ev, dict):
            continue
        if ev.get("name") == "repro.metrics" and ev.get("ph") == "M":
            metrics = ev.get("args")
        else:
            events.append(ev)
    return events, metrics


def assign_self_times(events: list[dict]) -> list[Span]:
    """Complete ("X") events -> Spans with self time and stack depth.

    Per tid: sort by (ts, -dur) and run the containment stack — a span
    whose interval lies inside the previous unfinished span is its child;
    each child's duration is subtracted from the parent's self time.

    Malformed traces degrade instead of corrupting the attribution: events
    missing ts/dur (an unclosed span some emitter wrote half of) are
    dropped, and a PARTIALLY-overlapping sibling — one that starts inside
    the previous span but ends after it — only debits the overlapping
    portion from that span's self time, so self times stay non-negative by
    construction rather than by clamping real signal away.
    """
    spans: list[Span] = []
    by_tid: dict[int, list[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if not isinstance(ev.get("ts"), (int, float)) or \
                not isinstance(ev.get("dur"), (int, float)):
            continue
        by_tid.setdefault(ev.get("tid", 0), []).append(ev)

    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        # stack entries: [event, child_dur_accumulator]
        stack: list[list[Any]] = []
        finished: list[tuple[dict, float, int]] = []

        def close(entry):
            ev, child_dur = entry
            depth = len(stack)
            finished.append((ev, ev["dur"] - child_dur, depth))

        for ev in evs:
            while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= ev["ts"]:
                close(stack.pop())
            if stack:
                p = stack[-1][0]
                overlap = min(ev["ts"] + ev["dur"],
                              p["ts"] + p["dur"]) - ev["ts"]
                stack[-1][1] += max(overlap, 0.0)
            stack.append([ev, 0.0])
        while stack:
            close(stack.pop())
        for ev, self_us, depth in finished:
            spans.append(Span(name=ev["name"], ts=ev["ts"], dur=ev["dur"],
                              tid=tid, args=ev.get("args", {}),
                              self_us=max(self_us, 0.0), depth=depth))
    spans.sort(key=lambda s: s.ts)
    return spans


class PhaseRow(NamedTuple):
    name: str
    count: int
    total_ms: float    # sum of durations (inclusive)
    self_ms: float     # sum of self times (exclusive; partitions wall)
    pct_wall: float    # self_ms / wall_ms


def wall_ms(spans: list[Span], root: str | None = None) -> float:
    """Wall-clock of the trace: the root span's duration when named (or
    when exactly one top-level span exists), else the overall extent."""
    if not spans:
        return 0.0
    if root is not None:
        named = [s for s in spans if s.name == root]
        if named:
            return sum(s.dur for s in named) / 1e3
    return (max(s.ts + s.dur for s in spans) - min(s.ts for s in spans)) / 1e3


def phase_breakdown(spans: list[Span],
                    root: str | None = None) -> tuple[list[PhaseRow], float]:
    """Aggregate SELF time by span name -> (rows sorted by self desc, wall).

    A span that has children contributes its self time under
    "<name> (self)" so the table reads as a partition: phase self times
    sum to the wall clock exactly (untracked host time appears as the
    enclosing span's (self) row, never silently)."""
    wall = wall_ms(spans, root)
    agg: dict[str, list[float]] = {}
    for s in spans:
        has_children = s.self_us < s.dur - 1e-9
        name = f"{s.name} (self)" if has_children else s.name
        row = agg.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        agg[name][1] += s.dur / 1e3
        agg[name][2] += s.self_us / 1e3
    rows = [PhaseRow(name=k, count=v[0], total_ms=v[1], self_ms=v[2],
                     pct_wall=(100.0 * v[2] / wall if wall else 0.0))
            for k, v in agg.items()]
    rows.sort(key=lambda r: -r.self_ms)
    return rows, wall


def split_request_spans(
        spans: list[Span]) -> tuple[list[Span], list[Span]]:
    """Partition spans into (phase_spans, request_spans).

    Request-scoped serve spans live on synthetic `req:<rid>` tids
    (`serve.batching._emit_request_spans`) and OVERLAP the real threads'
    phase spans in wall time — folding them into the phase table would
    double-count the wall clock, so the report gives them their own
    section instead."""
    phase, req = [], []
    for s in spans:
        (req if str(s.tid).startswith("req:") else phase).append(s)
    return phase, req


def _pct(vals: list, q: float) -> float:
    """Nearest-rank percentile (stdlib-only; exact at these sizes)."""
    if not vals:
        return float("nan")
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))]


def request_breakdown(req_spans: list[Span]) -> list[dict]:
    """Per-model latency decomposition of the traced serve requests:
    end-to-end percentiles plus mean queue/solve split (ms)."""
    per_tid: dict[str, dict] = {}
    for s in req_spans:
        d = per_tid.setdefault(str(s.tid), {})
        d[s.name] = d.get(s.name, 0.0) + s.dur
        if s.name == "serve_request":
            d["model"] = s.args.get("model", "?")
    groups: dict[str, list[dict]] = {}
    for d in per_tid.values():
        if "serve_request" in d:
            groups.setdefault(str(d.get("model", "?")), []).append(d)
    rows = []
    for model in sorted(groups):
        ds = groups[model]
        tot = [d["serve_request"] / 1e3 for d in ds]
        qs = [d.get("serve_queue", 0.0) / 1e3 for d in ds]
        ss = [d.get("serve_solve", 0.0) / 1e3 for d in ds]
        rows.append({"model": model, "count": len(ds),
                     "p50_ms": _pct(tot, 50), "p99_ms": _pct(tot, 99),
                     "max_ms": max(tot),
                     "queue_ms_mean": sum(qs) / len(qs),
                     "solve_ms_mean": sum(ss) / len(ss)})
    return rows


def format_request_table(rows: list[dict]) -> str:
    out = ["| model | requests | p50_ms | p99_ms | max_ms | "
           "queue_ms (mean) | solve_ms (mean) |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['model']} | {r['count']} | {r['p50_ms']:.2f} | "
                   f"{r['p99_ms']:.2f} | {r['max_ms']:.2f} | "
                   f"{r['queue_ms_mean']:.2f} | {r['solve_ms_mean']:.2f} |")
    return "\n".join(out)


def _fmt_num(v) -> str:
    if isinstance(v, float):
        if v != v:  # nan
            return "nan"
        if abs(v) >= 1e6 or (abs(v) < 1e-3 and v != 0):
            return f"{v:.3e}"
        return f"{v:.3f}".rstrip("0").rstrip(".")
    return str(v)


def format_phase_table(rows: list[PhaseRow], wall: float) -> str:
    out = ["| phase | count | total_ms | self_ms | % wall |",
           "|---|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r.name} | {r.count} | {r.total_ms:.1f} | "
                   f"{r.self_ms:.1f} | {r.pct_wall:.1f} |")
    covered = sum(r.self_ms for r in rows)
    out.append(f"\nwall-clock {wall:.1f} ms; phase self-time total "
               f"{covered:.1f} ms ({100.0 * covered / wall if wall else 0.0:.1f}%)")
    return "\n".join(out)


def format_metrics(snapshot: dict | None) -> str:
    if not snapshot:
        return "(no metrics snapshot in trace)"
    lines = ["| metric | value |", "|---|---|"]
    for name, val in sorted(snapshot.items()):
        if isinstance(val, dict):  # histogram summary
            c = val.get("count", 0)
            lines.append(
                f"| {name} | count={c} mean={_fmt_num(val.get('mean'))} "
                f"p50={_fmt_num(val.get('p50'))} "
                f"p99={_fmt_num(val.get('p99'))} "
                f"max={_fmt_num(val.get('max'))} |")
        else:
            lines.append(f"| {name} | {_fmt_num(val)} |")
    return "\n".join(lines)


def format_report(path: str, root: str | None = None) -> str:
    """The full obs_report text for one trace file."""
    events, metrics = load_trace(path)
    spans = assign_self_times(events)
    phase_spans, req_spans = split_request_spans(spans)
    rows, wall = phase_breakdown(phase_spans, root=root)
    parts = [f"# obs report: {path}",
             f"events: {len(events)} spans: {len(spans)}", "",
             "## Per-phase breakdown (Table-2 style)", "",
             format_phase_table(rows, wall)]
    req_rows = request_breakdown(req_spans)
    if req_rows:
        parts += ["", "## Requests (traced serve flows)", "",
                  format_request_table(req_rows)]
    parts += ["", "## Metrics", "", format_metrics(metrics)]
    return "\n".join(parts)
