"""Share of their roofline at which the kmvm.cu kernels (B1-B3) ran the
window's training MVMs: the least time of the launches the program counted
(every training MVM is (n, n, d, 1 + probes); B2's fused CG step also
reads the row view and residual and writes its dots), counted by
gpbench.counts, over the device time of the kmvm.cu kernels in the
profiler's trace."""
from gpbench import counts

KERNELS = ("kmvm_kernel", "kmvm_acc_kernel", "kmvm_split_sum")


def read(rec):
    prof = rec.get("profile") or {}
    dev_s = sum(s for name, s in prof.get("kernel_s", {}).items()
                if any(k in name for k in KERNELS))
    if dev_s <= 0:
        return None
    sh, la, fac = rec["shape"], rec["launches"], rec["factors"][0]
    n, d, t = sh["n"], sh["d"], sh["t"]
    least = (la.get("kmvm", 0) * counts.mvm_least_s(fac, n, n, d, t)
             + la.get("kmvm_dots", 0) * counts.mvm_least_s(fac, n, n, d, t, dots=True)
             + la.get("kmvm_chunk", 0) * counts.mvm_least_s(fac, n, n, d, t))
    return 100.0 * least / dev_s
