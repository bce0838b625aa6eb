"""ms per optimizer step in the MoE layers' dispatch: the program's
`moe_dispatch` spans (each layer's routing, sort and gather, and its
combine, each closed by a synchronize under tracing; every forward of the
step, the features' and the backward's recomputed ones), over the traced
window's steps. None where the program keeps no such span."""


def read(rec):
    ms = (rec.get("span_ms") or {}).get("moe_dispatch")
    return ms / rec["steps"] if ms is not None else None
