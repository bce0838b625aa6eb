"""A test's per-layer metric: the window's answered requests."""


def read(rec):
    return rec.get("requests")
