"""Query rows answered over the traced window: `predict_rows_per_s` read per
layer in the serving cells whose host-paced window spreads too widely for
an end-to-end bound (taper-serve; PERF.md, section 2)."""


def read(rec):
    if not rec.get("requests") or not rec.get("window_s"):
        return None
    return rec["requests"] * rec["rows"] / rec["window_s"]
