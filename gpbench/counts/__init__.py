"""The benchmark's yardstick for work: FLOPs, bytes and least times.

A frozen copy written for the benchmark (the arithmetic of the program's
`scripts/kernel_costs.py` and `chip_smoke.py` bounds, restated), so that a
change to the program cannot change how its work is counted.

FLOPs are the fp32 work of the algorithm: 2 per multiply-add of the
distance term (d per entry) and of every product with a right-hand side (t
per entry), plus a fixed count per entry for the kernel function's epilogue
(`EPILOGUE_OPS`). Bytes count each input once and each output once (4 bytes
a value). The least time of a piece of work is
max(FLOPs / PEAK_FLOPS, bytes / PEAK_BYTES): the H100 SXM data sheet's dense
TF32 rate, the highest rate at which the card multiplies fp32 operands, and
its HBM3 bandwidth. `mfu.*` use the same peak.
"""

from __future__ import annotations

PEAK_FLOPS = 495e12      # dense TF32, NVIDIA H100 SXM data sheet
PEAK_BYTES = 3.35e12     # HBM3, NVIDIA H100 SXM data sheet
WORD = 4                 # fp32

# epilogue operations per kernel entry, by factor kind: the distance's
# assembly |x|^2 + |z|^2 - 2<x, z> and its clamp (4, once per entry), then per
# factor its scale (1) and its shape (`_KIND_OPS`: each add, mul, max, sqrt and
# exp counts one), then per component its weight and the accumulation (2)
_DIST_OPS = 4
_KIND_OPS = {"rbf": 2, "matern12": 3, "matern32": 6, "matern52": 9, "rq": 5,
             "wendland2": 8, "wendland4": 12}
# the Eq. 2 backward's extra operations per entry and differentiated factor:
# the derivative of the shape in its lengthscale (matern32: a^2 / l e^-a
# from the kept exp, 3 operations) and its chain-rule factor (1)
_KIND_DERIV_OPS = {"rbf": 3, "matern12": 3, "matern32": 4, "matern52": 5,
                   "rq": 6, "wendland2": 6, "wendland4": 8}


def epilogue_ops(factors: tuple) -> int:
    """Epilogue operations per entry of one component, a product of factor
    kinds, e.g. ("matern32",) or ("matern32", "wendland2")."""
    return _DIST_OPS + 2 + sum(1 + _KIND_OPS[k] for k in factors)


def entry_flops(factors: tuple, d: int, t: int) -> int:
    """FLOPs per kernel entry of K(Z, X) @ V with t columns."""
    return 2 * d + epilogue_ops(factors) + 2 * t


def mvm_flops(factors, m: int, n: int, d: int, t: int,
              entries: int | None = None) -> float:
    """FLOPs of K(Z, X) @ V: m x n entries (or `entries`, the pairs the
    mathematics needs, for a compactly supported kernel)."""
    count = m * n if entries is None else entries
    return float(count) * entry_flops(factors, d, t)


def mvm_bytes(m: int, n: int, d: int, t: int, dots: bool = False) -> float:
    """Bytes of K(Z, X) @ V: Z and X, V in, the (m, t) result out. `dots`:
    the fused CG step (B2) also reads the iteration's row view and residual
    ((m, t) each) and writes its (4, t) dot block."""
    b = (m + n) * d + n * t + m * t
    if dots:
        b += 2 * m * t + 4 * t
    return float(b * WORD)


def least_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def mvm_least_s(factors, m: int, n: int, d: int, t: int,
                dots: bool = False, entries: int | None = None) -> float:
    return least_s(mvm_flops(factors, m, n, d, t, entries),
                   mvm_bytes(m, n, d, t, dots))


def precond_flops(factors, n: int, d: int, rank: int) -> float:
    """A rank-k pivoted Cholesky of K(X, X): k kernel rows and, at step i,
    the row update against the i earlier columns (2 i n) and the diagonal
    update (2 n)."""
    rows = rank * n * (2 * d + epilogue_ops(factors))
    updates = sum(2 * i * n + 2 * n for i in range(rank))
    return float(rows + updates)


def backward_flops(factors, n: int, d: int, t: int, leaves: int) -> float:
    """The Eq. 2 backward over the (t + 1) column pairs: every entry once,
    its epilogue and, per differentiated leaf (`leaves`), the derivative and
    the contraction a^T dK v (2 multiply-adds per column pair)."""
    deriv = sum(_KIND_DERIV_OPS[k] for k in factors)
    per_entry = (2 * d + epilogue_ops(factors)
                 + leaves * (deriv + 2 * 2 * (t + 1)))
    return float(n) * n * per_entry


def love_flops(m: int, r: int) -> float:
    """The LOVE variance's work past its cross product: a triangular solve
    pair against the (r, r) factor and the row sums, per query row."""
    return float(m) * (2 * r * r + 2 * r)
