"""Share of its roofline at which B4 (kmvm_sparse.cu) answered the
window's requests. Entries are the (query, training point) pairs within the
taper's support radius, what the mathematics needs, not what the plan's
tiles cover; bytes are each request's queries, the training points and
right-hand-side rows its queries need, and its results, once. Least time
of the window's totals (the mean's t = 1 and the variance's t = r) by
gpbench.counts, over the device time of kmvm_bs_kernel in the trace."""
from gpbench import counts


def read(rec):
    prof = rec.get("profile") or {}
    dev_s = sum(s for name, s in prof.get("kernel_s", {}).items()
                if "kmvm_bs_kernel" in name)
    pr = rec.get("pairs")
    if dev_s <= 0 or not pr or not rec.get("requests"):
        return None
    sh, fac = rec["shape"], rec["factors"][0]
    d, r = sh["d"], sh["r"]
    q = rec["requests"] * rec["rows"]
    flops = pr["pairs"] * (counts.entry_flops(fac, d, 1) + counts.entry_flops(fac, d, r))
    nbytes = counts.WORD * ((q + pr["needed"]) * d
                            + pr["needed"] * (1 + r) + q * (1 + r))
    return 100.0 * counts.least_s(flops, nbytes) / dev_s
