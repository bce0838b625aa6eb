"""mBCG iterations per optimizer step in the window: each step's loop
iterations (its most-iterated column; every iteration is one block MVM),
from the engine's telemetry (`cg_iters_per_rhs`), averaged over the
window's steps."""


def read(rec):
    tel = rec.get("telemetry") or []
    if not tel:
        return None
    return sum(max(t["cg_iters_per_rhs"]) for t in tel) / len(tel)
