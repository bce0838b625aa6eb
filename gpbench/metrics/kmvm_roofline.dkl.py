"""Share of their roofline at which the kmvm.cu kernels (B1-B3) ran the DKL
head's MVMs, at this cell's shape (n 4096, d 4096, 1 + probes columns): the
reading of `kmvm_roofline.train` (least time by gpbench.counts over the
kernels' device time in the trace) on this cell's records."""
from gpbench.harness import manifest


def read(rec):
    return manifest.load_reader("kmvm_roofline.train")(rec)
