"""ms per optimizer step in the Eq. 2 backward: the engine's
`eq2_backward` phase spans (`measured_ms`), summed over the window and
divided by its steps."""


def read(rec):
    ms = [e["args"]["measured_ms"] for e in rec.get("spans") or []
          if e.get("name") == "eq2_backward" and "measured_ms" in e.get("args", {})]
    return sum(ms) / rec["steps"] if ms else None
