"""A test's driver, a loop of its own: `requests` requests of the mix's
queries answered by the reference kernel's sums K(Z, X) y (no program), and
each sum checked against an entry-by-entry one."""

from gpbench import data
from gpbench.harness import manifest, program
from gpbench.harness.output import Check
from gpbench.harness.window import Outcome, now
from gpbench.reference import FP64

LIMITS = "serve"


def run(ctx):
    import math

    import torch

    cfg, tr = ctx.cfg, ctx.traffic
    draw = data.make(cfg, ctx.device)
    qrows = manifest.load_part("queries", tr["queries"], cfg["bench"]).rows
    kern = program.ref_kernel(cfg, program.raw_leaves(cfg))
    X, y = draw.X.double(), draw.y.double()
    setup_s = now() - ctx.t_start
    t0, gap = now(), 0.0
    for k in range(tr["requests"]):
        Z = torch.as_tensor(qrows(None, ctx.seed, 0, k, tr["rows"])).double()
        s = kern.block(Z, X, FP64) @ y
        for i in range(Z.shape[0]):
            one = sum(kern.h["scale"] * float(y[j])
                      * math.exp(-0.5 * (float(Z[i, 0] - X[j, 0]) / kern.h["ls"]) ** 2)
                      for j in range(X.shape[0]))
            gap = max(gap, abs(float(s[i]) - one))
    t1 = now()
    e2e = {"setup_s": setup_s, "tiny_rows_per_s": tr["requests"] * tr["rows"] / (t1 - t0)}
    checks = [Check(k, gap, v) for k, v in cfg["limits"][LIMITS].items()]
    return Outcome(tr["requests"], 0, e2e, {"requests": tr["requests"]}, checks, 0)


def controls(cap, full=True):
    return {}
