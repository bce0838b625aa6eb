"""ms per optimizer step in the mBCG solve: the engine's `cg_solve` phase
spans (`measured_ms`, each closed by a synchronize under tracing), summed
over the window and divided by its steps."""


def read(rec):
    ms = [e["args"]["measured_ms"] for e in rec.get("spans") or []
          if e.get("name") == "cg_solve" and "measured_ms" in e.get("args", {})]
    return sum(ms) / rec["steps"] if ms else None
