"""The DKL step's share of the card's peaks: each kind of counted FLOPs of
the traced window over its peak, summed, over the window's seconds. The
backbone's model FLOPs, one forward and one backward a step (a features
pass and a remat recompute that the program adds are not work here), by
gpbench.counts.granitemoehybrid: the dense products from the shapes, the
routed experts' from the program's `moe.routed_pairs_held` counter over the
forwards a step runs (it counts every forward), at the bf16 peak; the GP head's
MVMs as the program launched them, a preconditioner and an Eq. 2 backward a
step (gpbench.counts) at the TF32 peak. None where the program counts no
routed pairs or no MVM launch."""
from gpbench import counts
from gpbench.counts import granitemoehybrid as gmh


def read(rec):
    launches = sum(rec.get("launches", {}).values())
    if not rec.get("moe_pairs") or not launches:
        return None
    sh, fac, steps = rec["shape"], rec["factors"][0], rec["steps"]
    n, d, t = sh["n"], sh["d"], sh["t"]
    backbone = gmh.step_flops(rec["config"], rec["tokens"], rec["seq"],
                              rec["moe_pairs"] / rec["forwards"], steps)
    head = (launches * counts.mvm_flops(fac, n, n, d, t)
            + steps * counts.precond_flops(fac, n, d, rec["precond_rank"])
            + steps * counts.backward_flops(fac, n, d, t, rec["leaves"]))
    busy = backbone / gmh.PEAK_BF16 + head / gmh.PEAK_TF32
    return 100.0 * busy / rec["window_s"]
