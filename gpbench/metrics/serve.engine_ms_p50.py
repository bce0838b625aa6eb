"""Median host ms of a `PredictionEngine.predict` call in the window (the
program's `serve.predict_ms` histogram; under tracing each call ends in a
synchronize)."""
import math


def read(rec):
    v = rec.get("engine_ms_p50")
    return None if v is None or math.isnan(v) else v
