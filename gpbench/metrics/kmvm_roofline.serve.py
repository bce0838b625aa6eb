"""Share of their roofline at which the kmvm.cu kernels (B1) answered the
window's requests: per request of `rows` query rows, the mean's K(Z, X) c
(t = 1) and the variance's K(Z, X) Q (t = r), least times by
gpbench.counts, over the device time of the kmvm.cu kernels in the
profiler's trace."""
from gpbench import counts

KERNELS = ("kmvm_kernel", "kmvm_acc_kernel", "kmvm_split_sum")


def read(rec):
    prof = rec.get("profile") or {}
    dev_s = sum(s for name, s in prof.get("kernel_s", {}).items()
                if any(k in name for k in KERNELS))
    if dev_s <= 0 or not rec.get("requests"):
        return None
    sh, fac, m = rec["shape"], rec["factors"][0], rec["rows"]
    least = rec["requests"] * (counts.mvm_least_s(fac, m, sh["n"], sh["d"], 1)
                               + counts.mvm_least_s(fac, m, sh["n"], sh["d"], sh["r"]))
    return 100.0 * least / dev_s
