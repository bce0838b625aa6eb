"""95th percentile of every request's submit-to-answer in the traced
window: `predict_p95_ms` read per layer where the window spreads too widely
for an end-to-end bound (taper-serve; PERF.md, section 2)."""
import math


def read(rec):
    v = rec.get("predict_p95_ms")
    return None if v is None or math.isnan(v) else v
