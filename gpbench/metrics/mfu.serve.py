"""The request path's share of the card's peak: the counted prediction
FLOPs of the window's requests (the mean's and the variance's cross
products, over the pairs within the support radius for a tapered kernel,
and the LOVE solve; by gpbench.counts) over the window's seconds and the
dense TF32 peak."""
from gpbench import counts


def read(rec):
    if not rec.get("requests") or not sum(rec["launches"].values()):
        return None
    sh, fac, m, r = rec["shape"], rec["factors"][0], rec["rows"], rec["shape"]["r"]
    q = rec["requests"] * m
    pr = rec.get("pairs")
    if pr:
        cross = pr["pairs"] * (counts.entry_flops(fac, sh["d"], 1)
                               + counts.entry_flops(fac, sh["d"], r))
    else:
        cross = (counts.mvm_flops(fac, q, sh["n"], sh["d"], 1)
                 + counts.mvm_flops(fac, q, sh["n"], sh["d"], r))
    flops = cross + counts.love_flops(q, r)
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_FLOPS)
