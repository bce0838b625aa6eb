"""The training step's share of the card's peak: the counted FLOPs of the
window's steps (the mBCG MVMs the program launched, a pivoted-Cholesky
preconditioner per cold or refresh step, one Eq. 2 backward per step; by
gpbench.counts) over the window's seconds and the dense TF32 peak."""
from gpbench import counts


def read(rec):
    tel = rec.get("telemetry") or []
    if not tel or not sum(rec["launches"].values()):
        return None
    sh, fac = rec["shape"], rec["factors"][0]
    n, d, t = sh["n"], sh["d"], sh["t"]
    mvms = sum(rec["launches"].values())
    builds = sum(1 for s in tel if s["mode"] != "warm")
    flops = (mvms * counts.mvm_flops(fac, n, n, d, t)
             + builds * counts.precond_flops(fac, n, d, rec["precond_rank"])
             + len(tel) * counts.backward_flops(fac, n, d, t, rec["leaves"]))
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_FLOPS)
