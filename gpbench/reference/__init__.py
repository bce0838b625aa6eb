"""The plain reference that decides `correct`: exact-GP arithmetic in torch.

Written for the benchmark and independent of the program: it imports
neither `jax`, the JAX package nor anything of `repro_torch`, and it works
out every kernel matrix, product, log-determinant, gradient and
preconditioner again from the inputs the benchmark hands both sides (the
data, the raw hyperparameters). The checks follow the program's own state
where a replay cannot be held to it: training judges each recorded step
from the solutions, probes and factor it carried on, serving judges the
program's caches by their residual and the Lanczos relation and answers
queries again from them (`fit_posterior` here fits caches of its own, for
the control and the tests).

Precisions (`Prec`): `FP64`, the reference (float64 throughout); `TF32`,
the control: float32 state and accumulation, with the operands of the
kernel matrix's products (the distance's cross term, K @ V and dK @ V)
rounded to TF32 (10 mantissa bits, round to nearest) as the tensor
cores' single-pass TF32 mode rounds them. The program's kernels run those
products at 3xTF32, about fp32's accuracy, so the control is the step below
the precision the configurations state, the one a faster kernel would
take; the small dense algebra around them (the preconditioner's Woodbury
solve, Lanczos' reorthogonalization) stays IEEE fp32, as the program's.
`FP32` is IEEE fp32 throughout, what a sound fp32 program reads.

Kernel functions are files under `kernels/`, one each, found by the name a
configuration gives (`"reference_kernel"`): `matern32`, `matern32-wendland2`;
the noise variance softplus(raw_noise) + noise_floor sits on the diagonal,
with a constant mean. Hyperparameters come in raw (softplus)
form as a dict of floats, keyed by leaf name.
"""

from __future__ import annotations

import contextlib
import importlib.util
import math
import os
import re
from typing import NamedTuple

import torch

SQRT3 = math.sqrt(3.0)


class Prec(NamedTuple):
    dtype: torch.dtype
    tf32: bool          # the kernel matrix's products at TF32


FP64 = Prec(torch.float64, False)
FP32 = Prec(torch.float32, False)
TF32 = Prec(torch.float32, True)


def softplus(x: float) -> float:
    return math.log1p(math.exp(-abs(x))) + max(x, 0.0)


def sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 mantissa bits (nearest, ties away),
    kept in fp32 storage."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def _exact_matmul():
    """float32 matmuls in IEEE fp32: TF32, where wanted, is rounded in by
    hand, never left to the library."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return round_tf32(a) @ round_tf32(b)
    return a @ b


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


KERNELS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_KERNELS: dict = {}


def load_kernel(name: str, where: str | None = None):
    """The kernel function file <where>/<name>.py (`where`: this package's
    `kernels/`): `LEAVES`, the raw leaves K depends on besides the noise;
    `hyper(raw)`, its constrained values (a "radius" among them makes the
    kernel compactly supported); `value(r, h)`, K of the distances r;
    `derivs(r, h, raw)`, {leaf: dK / d raw leaf}; `prior_diag(h)`."""
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(where or KERNELS_DIR, f"{name}.py")
    if path not in _KERNELS:
        if not os.path.exists(path):
            raise ValueError(f"no reference kernel {name!r} in {where or KERNELS_DIR}")
        spec = importlib.util.spec_from_file_location(
            "gpbench_reference_kernel_" + re.sub(r"[^A-Za-z0-9_]", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _KERNELS[path] = mod
    return _KERNELS[path]


class Kernel:
    """k(x, z) of one configuration's kernel at raw hyperparameters `raw`
    (leaf name -> float), and its derivatives in the raw leaves; the kernel
    function is the file `name` under `where` (see `load_kernel`)."""

    def __init__(self, name: str, raw: dict, noise_floor: float, where: str | None = None):
        self.fn = load_kernel(name, where)
        self.spec = name
        self.raw = dict(raw)
        self.noise = softplus(raw["noise"]) + noise_floor
        self.mean = float(raw["mean"])
        self.h = self.fn.hyper(self.raw)
        self.radius = self.h.get("radius", math.inf)

    @property
    def leaves(self) -> tuple:
        """The raw leaves the kernel matrix depends on, besides the noise."""
        return tuple(self.fn.LEAVES)

    def distance(self, A, B, prec: Prec):
        an = torch.sum(A * A, 1, keepdim=True)
        bn = torch.sum(B * B, 1, keepdim=True).T
        d2 = torch.clamp(an + bn - 2.0 * mm(A, B.T, prec.tf32), min=0.0)
        return torch.sqrt(d2)

    def block(self, A, B, prec: Prec, r=None):
        r = self.distance(A, B, prec) if r is None else r
        return self.fn.value(r, self.h)

    def deriv_blocks(self, A, B, prec: Prec) -> dict:
        """{leaf: dK/d raw leaf} over the block (noise-free part)."""
        return self.fn.derivs(self.distance(A, B, prec), self.h, self.raw)

    def prior_diag(self) -> float:
        return self.fn.prior_diag(self.h)


# --------------------------------------------------------------------------
# the operator K_hat = K + noise I over the training inputs
# --------------------------------------------------------------------------


class Operator:
    """K_hat over X at one precision. Dense (the noise-free n x n K, built
    once; the noise is added to each product apart) when n <= dense_limit;
    otherwise by row blocks, which for a compactly supported kernel visit
    only the column tiles within the support radius of the row block (the
    points sorted by a Z-order of their own)."""

    def __init__(self, kern: Kernel, X, prec: Prec, *, dense_limit: int = 1 << 16,
                 block: int = 4096):
        self.kern, self.prec = kern, prec
        self.n = X.shape[0]
        self.block = block
        self.X = X.to(prec.dtype)
        self.K = None
        self.order = None
        if self.n <= dense_limit:
            self.K = self._dense()
        elif math.isfinite(kern.radius):
            self._tile(X)

    def _dense(self):
        n, dt = self.n, self.prec.dtype
        K = torch.empty((n, n), dtype=dt, device=self.X.device)
        with _exact_matmul():
            for i in range(0, n, self.block):
                Kb = self.kern.block(self.X[i:i + self.block], self.X, self.prec)
                # the products' operand, rounded once (noise is added apart)
                K[i:i + self.block] = round_tf32(Kb) if self.prec.tf32 else Kb
        return K

    def _tile(self, X, bits: int = 10, tile: int = 512):
        """Sort by a Z-order (Morton) key of the points' cells on a 2^bits
        grid per dimension, so that consecutive points lie close together;
        keep, per row block, the sorted indices of the column tiles whose
        bounding boxes lie within the support radius of the block's box."""
        Xd = X.to(torch.float64)
        lo, hi = Xd.min(0).values, Xd.max(0).values
        cell = torch.clamp(((Xd - lo) / torch.clamp(hi - lo, min=1e-12)
                            * (1 << bits)).long(), max=(1 << bits) - 1)
        d = cell.shape[1]
        key = torch.zeros(self.n, dtype=torch.long, device=X.device)
        for b in range(bits):
            for j in range(d):
                key |= ((cell[:, j] >> b) & 1) << (b * d + j)
        self.order = torch.argsort(key)
        self.Xs = self.X[self.order]
        Xs = Xd[self.order]
        starts = range(0, self.n, tile)
        tlo = torch.stack([Xs[i:i + tile].min(0).values for i in starts])
        thi = torch.stack([Xs[i:i + tile].max(0).values for i in starts])
        ar = torch.arange(tile, device=X.device)
        self.cols = []
        for i in range(0, self.n, self.block):
            blo, bhi = Xs[i:i + self.block].min(0).values, Xs[i:i + self.block].max(0).values
            gap = torch.clamp(tlo - bhi, min=0.0) + torch.clamp(blo - thi, min=0.0)
            tiles = torch.nonzero(torch.sum(gap * gap, 1) < self.kern.radius ** 2)[:, 0]
            idx = (tiles[:, None] * tile + ar[None, :]).reshape(-1)
            self.cols.append(idx[idx < self.n])

    def matvec(self, V):
        """K_hat @ V (V: (n, t) or (n,))."""
        squeeze = V.ndim == 1
        V = (V[:, None] if squeeze else V).to(self.prec.dtype)
        with _exact_matmul():
            if self.K is not None:
                out = self.K @ (round_tf32(V) if self.prec.tf32 else V)
                out = out + self.kern.noise * V
            elif self.order is not None:
                Vs = V[self.order]
                outs = torch.empty_like(Vs)
                for i, cols in zip(range(0, self.n, self.block), self.cols):
                    Kb = self.kern.block(self.Xs[i:i + self.block], self.Xs[cols], self.prec)
                    outs[i:i + self.block] = mm(Kb, Vs[cols], self.prec.tf32)
                out = torch.empty_like(outs)
                out[self.order] = outs
                out = out + self.kern.noise * V
            else:
                out = torch.cat([mm(self.kern.block(self.X[i:i + self.block], self.X,
                                                    self.prec), V, self.prec.tf32)
                                 for i in range(0, self.n, self.block)])
                out = out + self.kern.noise * V
        return out[:, 0] if squeeze else out

    def rows(self, idx):
        """Noise-free kernel rows K(X[idx], X)."""
        with _exact_matmul():
            return self.kern.block(self.X[idx], self.X, self.prec)

    def cross(self, Z, V, block: int = 2048):
        """K(Z, X) @ V, by blocks of query rows."""
        Z = Z.to(self.prec.dtype)
        V = V.to(self.prec.dtype)
        with _exact_matmul():
            return torch.cat([mm(self.kern.block(Z[i:i + block], self.X, self.prec),
                                 V, self.prec.tf32) for i in range(0, Z.shape[0], block)])

    def quad_form_grads(self, A, V) -> dict:
        """{leaf: sum_c a_c^T dK_hat/d raw leaf v_c} over the raw leaves of
        the kernel and the noise."""
        A = A.to(self.prec.dtype)
        V = V.to(self.prec.dtype)
        out = {k: 0.0 for k in self.kern.leaves}
        with _exact_matmul():
            for i in range(0, self.n, self.block // 2):
                Xi = self.X[i:i + self.block // 2]
                for leaf, dK in self.kern.deriv_blocks(Xi, self.X, self.prec).items():
                    out[leaf] += float(torch.sum(A[i:i + Xi.shape[0]]
                                                 * mm(dK, V, self.prec.tf32)))
        out["noise"] = float(torch.sum(A * V)) * sigmoid(self.kern.raw["noise"])
        return out


# --------------------------------------------------------------------------
# the preconditioner P = L L^T + noise I
# --------------------------------------------------------------------------


class Precond:
    """P = L L^T + s2 I applied by Woodbury with the (s2 + jitter) I + L^T L
    factor, as BBMM's pivoted-Cholesky preconditioner is."""

    def __init__(self, L, s2: float, prec: Prec, jitter: float = 1e-6):
        self.L = L.to(prec.dtype)
        self.s2, self.prec = s2, prec
        k = self.L.shape[1]
        eye = torch.eye(k, dtype=prec.dtype, device=L.device)
        with _exact_matmul():
            inner = (s2 + jitter) * eye + self.L.T @ self.L
        self.chol = torch.linalg.cholesky(inner)

    def solve(self, V):
        with _exact_matmul():
            inner = torch.cholesky_solve(self.L.T @ V, self.chol)
            return (V - self.L @ inner) / self.s2

    def logdet(self) -> float:
        n, k = self.L.shape
        return float((n - k) * math.log(self.s2)
                     + 2.0 * torch.sum(torch.log(torch.diagonal(self.chol))))


def pivoted_cholesky(op: Operator, rank: int):
    """Rank-k greedy pivoted Cholesky of the noise-free K(X, X)."""
    n = op.n
    diag = torch.full((n,), op.kern.prior_diag(), dtype=op.prec.dtype,
                      device=op.X.device)
    L = torch.zeros((rank, n), dtype=op.prec.dtype, device=op.X.device)
    for i in range(rank):
        p = int(torch.argmax(diag))
        row = op.rows([p])[0]
        with _exact_matmul():
            row = row - L[:, p] @ L
        piv = max(float(diag[p]), 1e-12)
        li = row / math.sqrt(piv)
        li[p] = math.sqrt(piv)
        L[i] = li
        diag = torch.clamp(diag - li * li, min=0.0)
        diag[p] = -math.inf
    return L.T


def precond_gap(op: Operator, L) -> float:
    """How far P's factor is from a partial pivoted Cholesky of K: each
    column's pivot is its largest entry, and on the pivot rows L L^T has to
    reproduce K exactly. The largest gap over those rows, over K's largest
    entry."""
    L = L.to(op.prec.dtype)
    piv = torch.argmax(L, 0)
    if torch.unique(piv).numel() != L.shape[1]:
        return math.inf
    K = op.rows(piv)
    with _exact_matmul():
        LLt = L[piv] @ L.T
    return float(torch.max(torch.abs(K - LLt)) / op.kern.prior_diag())


# --------------------------------------------------------------------------
# training: one BBMM step, followed step by step
# --------------------------------------------------------------------------


def _tridiag_logdet_e1(alphas, betas, active):
    """e1^T log(T) e1 per column from the CG coefficients (the Lanczos
    tridiagonal of the preconditioned system; frozen iterations are
    identity rows)."""
    m, t = alphas.shape
    out = []
    for c in range(t):
        k = int(active[:, c].sum())
        if k == 0:
            out.append(0.0)
            continue
        a, b = alphas[:k, c], betas[:k, c]
        prev_a = torch.cat([torch.ones_like(a[:1]), a[:-1]])
        prev_b = torch.cat([torch.zeros_like(b[:1]), b[:-1]])
        diag = 1.0 / a + prev_b / prev_a
        off = torch.sqrt(torch.clamp(b[:-1], min=0.0)) / a[:-1]
        T = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)
        ev, vec = torch.linalg.eigh(T.double())
        out.append(float(torch.sum(vec[0] ** 2 * torch.log(torch.clamp(ev, min=1e-10)))))
    return out


def pcg_fixed(op: Operator, B, P: Precond, iters, x0=None):
    """Preconditioned CG on every column of B, column c for exactly
    iters[c] iterations (the count its run applied); returns (U, alphas,
    betas, active, rz0, R) with R the residual by the recurrence."""
    dt = op.prec.dtype
    B = B.to(dt)
    iters = torch.as_tensor(list(iters), device=B.device)
    if x0 is None:
        U, R = torch.zeros_like(B), B.clone()
    else:
        U = x0.to(dt).clone()
        R = B - op.matvec(U)
    Z = P.solve(R)
    rz = torch.sum(R * Z, 0)
    rz0 = rz.clone()
    Pd = Z
    m = int(iters.max()) if iters.numel() else 0
    alphas = torch.zeros((m, B.shape[1]), dtype=dt, device=B.device)
    betas = torch.zeros_like(alphas)
    active = torch.zeros((m, B.shape[1]), dtype=torch.bool, device=B.device)
    for j in range(m):
        act = iters > j
        KP = op.matvec(Pd)
        alpha = torch.where(act, rz / torch.sum(Pd * KP, 0), torch.zeros_like(rz))
        U = U + alpha * Pd
        R = R - alpha * KP
        Z = P.solve(R)
        rz_new = torch.sum(R * Z, 0)
        beta = torch.where(act, rz_new / rz, torch.zeros_like(rz))
        Pd = torch.where(act, Z + beta * Pd, Pd)
        rz = torch.where(act, rz_new, rz)
        alphas[j], betas[j], active[j] = alpha, beta, act
    return U, alphas, betas, active, rz0, R


class StepOut(NamedTuple):
    loss: float
    grads: dict      # leaf -> d loss / d raw leaf
    solutions: torch.Tensor
    logdet: float
    rel: list        # per column ||r|| / ||b||, r by the CG recurrence


def eq2_grads(op: Operator, P: Precond, solutions, probes) -> dict:
    """The gradient of the per-datum negative log marginal likelihood in
    every raw leaf by Eq. 2, from the solves [K^-1 (y - mu), K^-1 z_1..z_t]
    and P^-1 z: the data-fit term -u_y^T dK u_y and the Hutchinson trace
    term mean_i u_i^T dK P^-1 z_i, contracted in one pass."""
    n, dt = op.n, op.prec.dtype
    U = solutions.to(dt)
    u_y, t = U[:, 0], U.shape[1] - 1
    A = torch.cat([-u_y[:, None], U[:, 1:] / t], 1)
    V = torch.cat([u_y[:, None], P.solve(probes.to(dt))], 1)
    grads = {k: 0.5 * v / n for k, v in op.quad_form_grads(A, V).items()}
    grads["mean"] = -float(torch.sum(u_y)) / n
    return grads


def bbmm_step(op: Operator, y, P: Precond, probes, iters, *, x0=None,
              logdet_carry: float | None = None) -> StepOut:
    """One step of the BBMM objective: the mBCG solve of K_hat^{-1} [y - mu,
    z_1..z_t] (column c for iters[c] iterations, from x0), the SLQ
    log-determinant (or `logdet_carry`, which a warm step carries from its
    last refresh), the per-datum negative log marginal likelihood, and its
    gradient by Eq. 2 in every raw leaf."""
    n = op.n
    dt = op.prec.dtype
    yc = y.to(dt) - op.kern.mean
    Z = probes.to(dt)
    t = Z.shape[1]
    B = torch.cat([yc[:, None], Z], 1)
    U, alphas, betas, active, rz0, R = pcg_fixed(op, B, P, iters, x0)
    if logdet_carry is None:
        e1 = _tridiag_logdet_e1(alphas[:, 1:], betas[:, 1:], active[:, 1:])
        logdet = P.logdet() + sum(float(rz0[1 + i]) * e1[i] for i in range(t)) / t
    else:
        logdet = logdet_carry
    quad = float(torch.dot(yc, U[:, 0]))
    loss = 0.5 * (quad + logdet + n * math.log(2.0 * math.pi)) / n
    rel = (torch.linalg.norm(R, dim=0) / torch.linalg.norm(B, dim=0)).tolist()
    return StepOut(loss, eq2_grads(op, P, U, Z), U, logdet, rel)


def exact_logdet(op: Operator) -> float:
    """log det K_hat by a Cholesky factorization of the dense operator's
    matrix, in place: the operator's K is spent."""
    K = op.K
    K.diagonal().add_(op.kern.noise)
    torch.linalg.cholesky(K, out=K)
    out = 2.0 * float(torch.sum(torch.log(torch.diagonal(K))))
    op.K = None
    return out


def adam(raw: dict, grads: dict, state: dict, lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8):
    """One Adam step on a dict of float leaves; state: {"step", "m", "v"}."""
    step = state.get("step", 0) + 1
    m = {k: b1 * state.get("m", {}).get(k, 0.0) + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * state.get("v", {}).get(k, 0.0) + (1 - b2) * g * g for k, g in grads.items()}
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    new = {k: raw[k] - lr * (m[k] / c1) / (math.sqrt(v[k] / c2) + eps) for k in raw}
    return new, {"step": step, "m": m, "v": v}


# --------------------------------------------------------------------------
# serving: the posterior caches and the answers
# --------------------------------------------------------------------------


def fit_posterior(op: Operator, y, v0, *, precond_rank: int, lanczos_rank: int,
                  tol: float, max_iters: int, min_iters: int = 10):
    """The one-time precomputation: a PCG mean solve of K_hat c = y - mu to
    relative residual `tol`, and rank-r Lanczos with full
    reorthogonalization from v0. Returns (c, Q, T, rel): the mean cache, the
    Lanczos basis and tridiagonal, and the solve's relative residual as its
    recurrence measures it."""
    dt = op.prec.dtype
    yc = (y.to(dt) - op.kern.mean)[:, None]
    P = Precond(pivoted_cholesky(op, precond_rank), op.kern.noise, op.prec)
    U, R = torch.zeros_like(yc), yc.clone()
    Zr = P.solve(R)
    rz = float(torch.sum(R * Zr))
    bn = float(torch.linalg.norm(yc))
    Pd = Zr
    for j in range(max_iters):
        if j >= min_iters and float(torch.linalg.norm(R)) / bn <= tol:
            break
        KP = op.matvec(Pd)
        alpha = rz / float(torch.sum(Pd * KP))
        U = U + alpha * Pd
        R = R - alpha * KP
        Zr = P.solve(R)
        rz_new = float(torch.sum(R * Zr))
        Pd = Zr + (rz_new / rz) * Pd
        rz = rz_new
    r = lanczos_rank
    Q = torch.zeros((r, op.n), dtype=dt, device=yc.device)
    Q[0] = v0.to(dt) / torch.linalg.norm(v0.to(dt))
    al = torch.zeros(r, dtype=dt, device=yc.device)
    be = torch.zeros(r, dtype=dt, device=yc.device)
    for j in range(r):
        w = op.matvec(Q[j])
        al[j] = torch.dot(Q[j], w)
        w = w - al[j] * Q[j]
        with _exact_matmul():
            w = w - Q.T @ (Q @ w)
            w = w - Q.T @ (Q @ w)
        nb = torch.linalg.norm(w)
        if j + 1 < r:
            Q[j + 1] = w / nb
            be[j] = nb
    T = torch.diag(al) + torch.diag(be[:-1], 1) + torch.diag(be[:-1], -1)
    return U[:, 0], Q.T, T, float(torch.linalg.norm(R)) / bn


def tridiag_of(T_chol):
    """The Lanczos tridiagonal T from the Cholesky factor of T + 1e-6 I
    that a fit hands on."""
    r = T_chol.shape[0]
    return T_chol @ T_chol.T - 1e-6 * torch.eye(r, dtype=T_chol.dtype, device=T_chol.device)


def fit_checks(op: Operator, y, c, Q, T, v0, claimed: float, tol: float) -> dict:
    """Judges the fit's caches from one pass K_hat @ [c, Q] at the
    operator's precision: `mean_residual`, ||K_hat c - (y - mu)|| / ||y -
    mu||; `lanczos_gap`, the largest of the Lanczos relation's residual
    (K_hat Q - Q T off its last column, over |T|'s largest entry), Q's loss
    of orthonormality and its first column's distance from v0 / |v0| (over
    that vector's largest entry); `residual_gap`, how far the residual the
    fit claims lies from the true one, over the tolerance."""
    dt = op.prec.dtype
    c, Q, T = c.to(dt), Q.to(dt), T.to(dt)
    r = Q.shape[1]
    KV = op.matvec(torch.cat([c[:, None], Q], 1))
    yc = y.to(dt) - op.kern.mean
    resid = float(torch.linalg.norm(KV[:, 0] - yc) / torch.linalg.norm(yc))
    rel = (KV[:, 1:] - Q @ T)[:, :r - 1]
    relation = float(torch.max(torch.abs(rel)) / torch.max(torch.abs(T)))
    orth = float(torch.max(torch.abs(Q.T @ Q - torch.eye(r, dtype=dt, device=Q.device))))
    v = v0.to(dt) / torch.linalg.norm(v0.to(dt))
    start = float(torch.max(torch.abs(Q[:, 0] - v)) / torch.max(torch.abs(v)))
    return {"mean_residual": resid, "residual_gap": abs(resid - claimed) / tol,
            "lanczos_gap": max(relation, orth, start)}


def served(op: Operator, Zq, c, Q, T_chol, include_noise: bool = True):
    """(mean, var) at the query rows Zq from the caches: mu + K(Zq, X) c and
    the LOVE variance k** - |L^-1 Q^T k|^2 (+ noise)."""
    dt = op.prec.dtype
    KV = op.cross(Zq, torch.cat([c.to(dt)[:, None], Q.to(dt)], 1))
    mean = op.kern.mean + KV[:, 0]
    proj = KV[:, 1:]
    sol = torch.cholesky_solve(proj.T, T_chol.to(dt))
    var = torch.clamp(op.kern.prior_diag() - torch.sum(proj * sol.T, 1), min=1e-10)
    if include_noise:
        var = var + op.kern.noise
    return mean, var
