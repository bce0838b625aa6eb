"""The result line: one JSON object, the last line of standard output, with
the compared numbers beside their limits as its last key and as the last
lines of standard error."""

from __future__ import annotations

import json
import math
import sys
from typing import NamedTuple


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def emit(*, checks: list, attempted: int, failed: int, metrics: dict,
         device: dict, breakdown: dict | None = None) -> dict:
    """Print the check lines to stderr and the result line to stdout;
    `correct` is whether every check holds and nothing failed."""
    correct = bool(checks) and all(c.ok for c in checks) and failed == 0
    line = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line
