"""Noise-aware BENCH-JSON regression diffing (the perf gate).

The counterpart of `repro.obs.regress`, with its schema and tolerances. A
benchmark run emits `BENCH_<name>.json`: a header, per-record dicts, and a
metrics-registry snapshot; the committed copies under
`experiments/benchmarks/` are the repo's baselines. This module diffs a
fresh run against them with a per-metric direction + tolerance schema, so
`launch/obs_diff` fails when a metric regresses beyond noise.

Schema design:

* Columns are classified by NAME PATTERN into metrics (gated, with a
  direction and a tolerance) and identity columns (everything unmatched —
  dataset, backend, scheduler, sweep parameters...). A record's identity
  key is the tuple of its identity-column values; records are matched
  across files by that key, so reordering or appending rows never breaks
  the diff.
* Tolerances are generous where the quantity is timing on a noisy host
  (rel 50% on `_ms`/`_s` columns: the gate catches 2x cliffs, not 5%
  drift) and tight where the quantity is accuracy (rel 5% on rmse/nll) or
  structure (iteration/launch counts: abs slack 2).
* `direction` makes the gate one-sided: a *faster* time or *higher* QPS
  never fails, however large the change.
* Values may be numbers, `'x±y'` strings (the mean is compared), numeric
  strings, or `'-'` placeholders (skipped). Missing records or columns
  WARN rather than fail — benchmarks grow.

`--tol-scale` multiplies every tolerance (the baselines may come from a
different machine class).
"""

from __future__ import annotations

import json
import math
import re
from typing import NamedTuple


class MetricRule(NamedTuple):
    """One schema entry: columns matching `pattern` (re.search) are gated
    with this direction and tolerance. First matching rule wins."""

    pattern: str
    direction: str   # "lower" | "higher" | "info" (tracked, never gated)
    rel_tol: float   # fraction of |baseline|
    abs_tol: float   # additive slack (units of the column)


# Ordered: first match wins. Patterns are matched against the column name.
SCHEMA: tuple[MetricRule, ...] = (
    # structure/efficiency counters — deterministic solver behavior
    MetricRule(r"saved_pct$", "higher", 0.30, 5.0),
    MetricRule(r"(^|_)(iters|launches|refreshes)(_|$)", "lower", 0.25, 2.0),
    # ratios where bigger is the point
    MetricRule(r"speedup|useful_ratio", "higher", 0.30, 0.05),
    MetricRule(r"qps", "higher", 0.30, 0.0),
    # tracked-but-ungated: win indicators flip on near-ties (the rmse
    # columns already gate accuracy), batch-shape stats and fill are
    # descriptive, signed MLL values have no safe relative tolerance
    MetricRule(r"wins|batch_rows|^fill$|mll_diff|final_mll|final_loss"
               r"|^opt_steps$", "info", 0.0, 0.0),
    # accuracy — deterministic up to float reassociation
    MetricRule(r"rmse|nll|^value$", "lower", 0.05, 0.02),
    MetricRule(r"err", "lower", 1.00, 1e-4),
    # modeled roofline columns — machine-independent, tight
    MetricRule(r"(flops|bytes)/dev|temp_GiB", "lower", 0.05, 0.0),
    # wall-clock — noisy on shared hosts, one-sided and generous
    MetricRule(r"(_ms|_s|seconds)$", "lower", 0.50, 10.0),
)


def rule_for(column: str) -> MetricRule | None:
    """The first schema rule matching `column`, or None (identity col)."""
    for rule in SCHEMA:
        if re.search(rule.pattern, column):
            return rule
    return None


_PM = re.compile(r"^\s*([-+0-9.eE]+)\s*±")


def parse_value(v) -> float | None:
    """Numeric view of a BENCH cell: floats/ints pass through, 'x±y'
    yields x, numeric strings parse, '-'/None/unparseable -> None."""
    if v is None or isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    if not s or s == "-":
        return None
    m = _PM.match(s)
    if m:
        s = m.group(1)
    try:
        return float(s)
    except ValueError:
        return None


class Finding(NamedTuple):
    bench: str
    record: str      # human-readable identity key
    column: str
    baseline: float
    current: float
    direction: str
    tolerance: float  # the applied (scaled) tolerance
    status: str       # "regression" | "improvement"


class DiffResult(NamedTuple):
    bench: str
    checked: int                 # gated (bench, record, column) cells
    regressions: list            # [Finding]
    improvements: list           # [Finding]
    warnings: list               # [str]


def _identity_key(header: list, record: dict) -> tuple:
    return tuple((c, str(record.get(c))) for c in header
                 if rule_for(c) is None)


def _key_str(key: tuple) -> str:
    return " ".join(f"{c}={v}" for c, v in key if v not in ("None",))


def compare_bench(baseline: dict, current: dict, *,
                  tol_scale: float = 1.0) -> DiffResult:
    """Diff one current BENCH dict against its baseline dict."""
    name = baseline.get("bench", current.get("bench", "?"))
    header = baseline.get("header") or []
    warnings: list = []
    cur_by_key: dict = {}
    for rec in current.get("records", []):
        cur_by_key.setdefault(_identity_key(header, rec), []).append(rec)

    checked = 0
    regressions: list = []
    improvements: list = []
    for rec in baseline.get("records", []):
        key = _identity_key(header, rec)
        bucket = cur_by_key.get(key)
        if not bucket:
            warnings.append(f"{name}: record [{_key_str(key)}] missing "
                            f"from current run")
            continue
        cur = bucket.pop(0)
        for col in header:
            rule = rule_for(col)
            if rule is None or rule.direction == "info":
                continue
            b = parse_value(rec.get(col))
            c = parse_value(cur.get(col))
            if b is None:
                continue  # '-' placeholder rows
            if c is None:
                warnings.append(f"{name}: [{_key_str(key)}] {col} is "
                                f"non-numeric in current run")
                continue
            checked += 1
            tol = (rule.abs_tol + rule.rel_tol * abs(b)) * tol_scale
            if rule.direction == "lower":
                worse, better = c > b + tol, c < b - tol
            else:
                worse, better = c < b - tol, c > b + tol
            if not (math.isfinite(c) and math.isfinite(b)):
                worse, better = not (c == b or math.isnan(c)
                                     and math.isnan(b)), False
            f = Finding(bench=name, record=_key_str(key), column=col,
                        baseline=b, current=c, direction=rule.direction,
                        tolerance=tol,
                        status="regression" if worse else "improvement")
            if worse:
                regressions.append(f)
            elif better:
                improvements.append(f)
    return DiffResult(bench=name, checked=checked, regressions=regressions,
                      improvements=improvements, warnings=warnings)


def load_bench(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "records" not in data:
        raise ValueError(f"{path}: not a BENCH json (no records)")
    return data


def format_diff(results: list, *, tol_scale: float = 1.0) -> str:
    """Markdown report over a list of DiffResults (the CI artifact)."""
    lines = ["# BENCH regression report", ""]
    total_reg = sum(len(r.regressions) for r in results)
    total_imp = sum(len(r.improvements) for r in results)
    total_checked = sum(r.checked for r in results)
    lines.append(f"benches compared: {len(results)} · gated cells: "
                 f"{total_checked} · regressions: {total_reg} · "
                 f"improvements: {total_imp} · tol-scale: {tol_scale:g}")
    lines.append("")
    for r in results:
        lines.append(f"## {r.bench} — {len(r.regressions)} regression(s), "
                     f"{len(r.improvements)} improvement(s), "
                     f"{r.checked} cells checked")
        for f in r.regressions:
            lines.append(
                f"- **REGRESSION** [{f.record}] `{f.column}`: "
                f"{f.baseline:g} -> {f.current:g} "
                f"({f.direction} is better; tolerance ±{f.tolerance:g})")
        for f in r.improvements:
            lines.append(
                f"- improvement [{f.record}] `{f.column}`: "
                f"{f.baseline:g} -> {f.current:g}")
        for w in r.warnings:
            lines.append(f"- warning: {w}")
        lines.append("")
    return "\n".join(lines)


def diff_to_json(results: list) -> dict:
    return {
        "benches": [
            {"bench": r.bench, "checked": r.checked,
             "regressions": [f._asdict() for f in r.regressions],
             "improvements": [f._asdict() for f in r.improvements],
             "warnings": list(r.warnings)}
            for r in results
        ],
        "total_regressions": sum(len(r.regressions) for r in results),
    }
