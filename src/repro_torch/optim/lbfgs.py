"""L-BFGS with two-loop recursion and a backtracking Armijo line search,
the reference's `repro.optim.lbfgs` on torch autograd.

Used for the paper's GP pretraining ("10 steps of L-BFGS"). The params tree
is flattened into one float64 vector on the host; the loss and its gradient
come from torch autograd through `loss_fn` (the Eq. 2 backward for the
exact MLL). A host loop over a handful of scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels_math import params_leaves, params_unflatten


def _ravel(params):
    leaves = params_leaves(params)
    shapes = [tuple(a.shape) for a in leaves]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]

    def unravel(vec):
        out, off = [], 0
        for a, s, sz in zip(leaves, shapes, sizes):
            out.append(torch.as_tensor(vec[off:off + sz].reshape(s),
                                       device=a.device).to(a.dtype))
            off += sz
        return params_unflatten(params, out)

    flat = np.concatenate([a.detach().cpu().numpy().reshape(-1).astype(np.float64)
                           for a in leaves])
    return flat, unravel


def lbfgs_minimize(loss_fn, params0, *, max_steps: int = 10, history: int = 10,
                   max_ls: int = 20, c1: float = 1e-4, init_step: float = 1.0,
                   verbose: bool = False):
    """Minimize loss_fn(params) -> scalar tensor (differentiable w.r.t. the
    params leaves). Returns (params, trace of losses)."""
    x, unravel = _ravel(params0)

    def vg(vec):
        p = unravel(vec)
        leaves = [a.detach().requires_grad_(True) for a in params_leaves(p)]
        loss = loss_fn(params_unflatten(p, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = np.concatenate([
            (np.zeros(a.numel()) if gi is None
             else gi.detach().cpu().numpy().reshape(-1)).astype(np.float64)
            for a, gi in zip(leaves, grads)])
        return float(loss.detach()), g

    f, g = vg(x)
    s_hist, y_hist, rho_hist = [], [], []
    trace = [f]
    for it in range(max_steps):
        q = g
        alphas = []
        for s, y, rho in zip(reversed(s_hist), reversed(y_hist),
                             reversed(rho_hist)):
            a = rho * np.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if y_hist:
            gamma = np.dot(s_hist[-1], y_hist[-1]) / max(
                np.dot(y_hist[-1], y_hist[-1]), 1e-12)
        else:
            gamma = 1.0
        r = gamma * q
        for (s, y, rho), a in zip(zip(s_hist, y_hist, rho_hist),
                                  reversed(alphas)):
            b = rho * np.dot(y, r)
            r = r + s * (a - b)
        d = -r

        gtd = float(np.dot(g, d))
        if gtd >= 0:  # not a descent direction; reset to steepest descent
            d = -g
            gtd = float(np.dot(g, d))
            s_hist, y_hist, rho_hist = [], [], []

        t = init_step if y_hist else min(
            1.0, 1.0 / max(float(np.linalg.norm(g)), 1e-12))
        ok = False
        for _ in range(max_ls):
            f_new, g_new = vg(x + t * d)
            if np.isfinite(f_new) and f_new <= f + c1 * t * gtd:
                ok = True
                break
            t *= 0.5
        if not ok:
            break
        x_new = x + t * d
        s_vec = x_new - x
        y_vec = g_new - g
        sy = float(np.dot(s_vec, y_vec))
        if sy > 1e-10:
            s_hist.append(s_vec)
            y_hist.append(y_vec)
            rho_hist.append(1.0 / sy)
            if len(s_hist) > history:
                s_hist.pop(0)
                y_hist.pop(0)
                rho_hist.pop(0)
        x, f, g = x_new, f_new, g_new
        trace.append(f)
        if verbose:
            print(f"  lbfgs step {it}: loss={f:.6f} t={t:.3g}")
        if float(np.linalg.norm(g)) < 1e-8:
            break
    return unravel(x), trace
