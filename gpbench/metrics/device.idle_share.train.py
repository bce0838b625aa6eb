"""Share of the traced window in which nothing ran on the card (the
profiler's CUDA activity, merged), in the training window."""


def read(rec):
    prof = rec.get("profile") or {}
    if not prof.get("busy_s") or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
