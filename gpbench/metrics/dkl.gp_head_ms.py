"""ms per optimizer step in the DKL step's GP head: the program's
`dkl_gp_head` spans (the MLL's forward and its Eq. 2 backward up to the
feature gradient g_X, closed by a synchronize under tracing), over the
traced window's steps. None where the program keeps no such span."""


def read(rec):
    ms = (rec.get("span_ms") or {}).get("dkl_gp_head")
    return ms / rec["steps"] if ms is not None else None
