"""ms per optimizer step in the DKL backbone: the program's `dkl_features`
and `dkl_backbone_backward` spans (each closed by a synchronize under
tracing; their `moe_dispatch` spans inside), summed over the traced window
from the program's span totals and divided by its steps. None where the
program keeps no such spans."""


def read(rec):
    ms = rec.get("span_ms") or {}
    parts = [ms[k] for k in ("dkl_features", "dkl_backbone_backward") if k in ms]
    return sum(parts) / rec["steps"] if parts else None
