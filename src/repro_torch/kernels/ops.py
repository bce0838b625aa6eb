"""Public wrappers around the fused kernel-MVM kernels.

Handles everything the raw kernels do not: planning a KernelSpec into
fused passes, lengthscale/weight application, the dtype policy, and a
`block_fn` adapter so `repro_torch.core.partitioned.kmvm_rect` can route
its per-partition slab MVMs through the kernel. `kgrad_grads` is the Eq. 2
backward of a one-pass plan: one launch of the gradient kernel
(`kernels.kgrad`) and the chain rule to the raw leaves.

Planning (`mvm_plan`), as in `repro.kernels.ops`:

* ONE fused pass carrying every component whose factors are all stationary
  with a shared-scalar lengthscale; the inputs are pre-scaled by the first
  such component's lengthscale, every other component enters through its
  ratio q = (l_ref / l_c)^2 on the same d2 tile;
* one fused pass per component with an ARD lengthscale;
* `linear` components as two thin matmuls w (Xi/s) ((Xj/s)^T V);
* a dense-slab fallback for anything else (linear x stationary products,
  multi-factor ARD products).

Padding and dtype policy on this card: nothing is padded — the kernels mask
ragged m, n and d themselves, and t and d keep their sizes (the TPU rule of
8/16 sublanes x 128 lanes does not apply). Operands are cast to the compute
dtype (fp32 by default, so fp64 operands run as fp32, as on the reference's
fused backend; bf16 when asked), all kernel math is fp32, and the result
returns in V.dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kernels_math import (
    canonicalize_kernel,
    leaf_matrix,
    normalize_components,
    params_leaves,
    params_unflatten,
    softplus,
)

from . import kgrad
from .kmvm import kmvm_fused, kmvm_fused_chunk, kmvm_fused_dots


class _FusedPass(NamedTuple):
    components: tuple        # static tuple of factor-kind tuples
    lengthscale: torch.Tensor  # () or (d,) reference pre-scaling
    base_weight: object      # V pre-multiplier (first component's weight)
    scalars: list            # flat per-component scalars (kmvm.scalar_layout)


class MVMPlan(NamedTuple):
    """How a spec executes on the fused backend (returned by `mvm_plan`)."""

    passes: tuple            # _FusedPass fused passes
    linear_terms: tuple      # (weight, LinearParams) thin-matmul terms
    fallback_terms: tuple    # kernels_math.Term dense-slab terms

    @property
    def num_fused_passes(self) -> int:
        return len(self.passes)

    @property
    def num_fallback_terms(self) -> int:
        return len(self.fallback_terms)


def _is_scalar_stationary(factors) -> bool:
    return all(kind != "linear" and p.raw_lengthscale.ndim == 0
               for kind, p in factors)


def _pass_scalars(terms, l_ref, w0) -> list:
    scal = []
    for t in terms:
        scal.append(t.weight / w0)
        for kind, p in t.factors:
            ls = softplus(p.raw_lengthscale)
            # an ARD factor is planned only as a single-factor pass whose
            # pre-scaling IS this lengthscale, so its ratio is exactly 1
            scal.append(1.0 if ls.ndim else torch.square(l_ref / ls))
            if kind == "rq":
                scal.append(softplus(p.raw_alpha))
    return scal


def mvm_plan(kernel, params) -> MVMPlan:
    """Plan the fused execution of `kernel` under `params`."""
    spec, kp = canonicalize_kernel(kernel, params)
    terms = normalize_components(spec, kp)

    fused, ard, linear, fallback = [], [], [], []
    for t in terms:
        kinds = tuple(kind for kind, _ in t.factors)
        if _is_scalar_stationary(t.factors):
            fused.append(t)
        elif kinds == ("linear",):
            linear.append((t.weight, t.factors[0][1]))
        elif len(t.factors) == 1 and kinds[0] != "linear":
            ard.append(t)
        else:
            fallback.append(t)

    passes = []
    if fused:
        l_ref = softplus(fused[0].factors[0][1].raw_lengthscale)
        w0 = fused[0].weight
        passes.append(_FusedPass(
            components=tuple(tuple(k for k, _ in t.factors) for t in fused),
            lengthscale=l_ref, base_weight=w0,
            scalars=_pass_scalars(fused, l_ref, w0)))
    for t in ard:
        l_ref = softplus(t.factors[0][1].raw_lengthscale)
        passes.append(_FusedPass(
            components=(tuple(k for k, _ in t.factors),),
            lengthscale=l_ref, base_weight=t.weight,
            scalars=_pass_scalars([t], l_ref, t.weight)))
    return MVMPlan(passes=tuple(passes), linear_terms=tuple(linear),
                   fallback_terms=tuple(fallback))


def _compute_dtype(compute_dtype: str | None) -> torch.dtype:
    return torch.float32 if compute_dtype is None else getattr(torch, compute_dtype)


def _pass_scalar_vector(ppass: _FusedPass, device) -> torch.Tensor:
    """The fp32 scalar vector of one pass (kernel math is fp32)."""
    return torch.stack([torch.as_tensor(s, device=device).to(torch.float32)
                        for s in ppass.scalars])


def _prescale(ppass: _FusedPass, X, cdt):
    return (X / ppass.lengthscale).to(cdt).contiguous()


def _scale_rhs(ppass: _FusedPass, V, cdt):
    return (ppass.base_weight * V.to(torch.float32)).to(cdt).contiguous()


def _run_pass(ppass: _FusedPass, Xi, Xj, V, cdt, split_tiles):
    """One fused launch; returns the (m, t) fp32 contribution."""
    return kmvm_fused(ppass.components, _prescale(ppass, Xi, cdt),
                      _prescale(ppass, Xj, cdt), _scale_rhs(ppass, V, cdt),
                      _pass_scalar_vector(ppass, Xi.device), split_tiles)


def _mixed_dot(A, B, cdt):
    """A @ B on cdt operands with fp32 accumulation (a bf16 x bf16 product
    is exact in fp32, so upcasting the rounded operands is the same)."""
    return A.to(cdt).to(torch.float32) @ B.to(cdt).to(torch.float32)


def kmvm_block(kernel, Xi, Xj, V, params, *, compute_dtype=None,
               split_tiles: int | None = None) -> torch.Tensor:
    """K(Xi, Xj) @ V via the fused plan; arbitrary shapes and dtypes.

    Semantics identical to `repro_torch.kernels.ref.kmvm_ref` (no noise
    term). `compute_dtype` is the operand dtype of the kernel's products:
    None/"float32" is the exact path, "bfloat16" halves operand traffic.
    Tile sizes are the kernel's own (no `bm`/`bn`, no interpret mode);
    `split_tiles` is the column split of every fused launch (None = the
    kernels' default; `kernels.autotune` picks it for the operator).
    """
    cdt = _compute_dtype(compute_dtype)
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]

    plan = mvm_plan(kernel, params)
    acc = None
    for ppass in plan.passes:
        out = _run_pass(ppass, Xi, Xj, V, cdt, split_tiles)
        acc = out if acc is None else acc + out
    for w, p in plan.linear_terms:
        s = softplus(p.raw_scale)
        proj = _mixed_dot((Xj / s).T, V.to(torch.float32), cdt)   # (d, t)
        out = w * _mixed_dot(Xi / s, proj, cdt)
        acc = out if acc is None else acc + out
    for term in plan.fallback_terms:
        K = None
        for kind, p in term.factors:
            Kf = leaf_matrix(kind, p, Xi.to(torch.float32), Xj.to(torch.float32))
            K = Kf if K is None else K * Kf
        out = term.weight * _mixed_dot(K, V.to(torch.float32), cdt)
        acc = out if acc is None else acc + out

    out = acc.to(V.dtype)
    return out[:, 0] if squeeze else out


def kmvm_block_acc(kernel, Xi, Xj, V, params, acc, *, compute_dtype=None,
                   row_block: int = 1024) -> torch.Tensor:
    """acc += K(Xi, Xj) @ V in place (acc (m, t) fp32); returns acc.

    The chunk step of the distributed engine's ring contraction on the fused
    backend: one `kmvm_fused_chunk` launch per fused pass into the same acc,
    with `kmvm_block`'s prescaling and dtype policy. `linear` terms add their
    thin matmuls; dense-fallback terms add their slabs `row_block` rows at a
    time, so no (m, n) slab is live.
    """
    cdt = _compute_dtype(compute_dtype)
    if V.ndim == 1:
        V = V[:, None]
    plan = mvm_plan(kernel, params)
    for ppass in plan.passes:
        kmvm_fused_chunk(ppass.components, _prescale(ppass, Xi, cdt),
                         _prescale(ppass, Xj, cdt), _scale_rhs(ppass, V, cdt),
                         _pass_scalar_vector(ppass, Xi.device), acc)
    for w, p in plan.linear_terms:
        s = softplus(p.raw_scale)
        proj = _mixed_dot((Xj / s).T, V.to(torch.float32), cdt)   # (d, t)
        acc += (w * _mixed_dot(Xi / s, proj, cdt)).to(torch.float32)
    if plan.fallback_terms:
        xj32 = Xj.to(torch.float32)
        v32 = V.to(torch.float32)
        for i in range(0, Xi.shape[0], row_block):
            xb = Xi[i:i + row_block].to(torch.float32)
            for term in plan.fallback_terms:
                K = None
                for kind, p in term.factors:
                    Kf = leaf_matrix(kind, p, xb, xj32)
                    K = Kf if K is None else K * Kf
                acc[i:i + row_block] += (term.weight * _mixed_dot(K, v32, cdt)
                                         ).to(torch.float32)
    return acc


def fused_pass_or_none(kernel, params) -> _FusedPass | None:
    """The single fused pass covering the WHOLE spec, or None when the spec
    needs anything else — the gate for the one-launch fused-CG step."""
    mp = mvm_plan(kernel, params)
    if len(mp.passes) == 1 and not mp.linear_terms and not mp.fallback_terms:
        return mp.passes[0]
    return None


def kgrad_pass_or_none(kernel, params, d: int) -> _FusedPass | None:
    """The fused pass whose quadratic-form gradient B5 computes, or None:
    the spec plans to one pass with a shared scalar lengthscale and nothing
    else, within the kernel's components, factors and features."""
    ppass = fused_pass_or_none(kernel, params)
    if (ppass is None or ppass.lengthscale.ndim != 0 or d > kgrad.MAX_FEATURES
            or not kgrad.takes(ppass.components)):
        return None
    return ppass


def kgrad_grads(kernel, X, A, V, params):
    """The gradient tree (shaped like params) of q = sum_j a_j^T K(X, X) v_j,
    no noise term, by one B5 launch (`kgrad_fused`; its plain version on a
    CPU tensor, in X's dtype): the kernel's sums in the pass's base weight,
    lengthscale and scalars go to the raw leaves by `torch.autograd.grad`
    over `mvm_plan`'s scalar graph (softplus, ratios, weights; nothing
    n-sized). None where `kgrad_pass_or_none` finds no pass."""
    leaves = [a.detach().requires_grad_(True) for a in params_leaves(params)]
    with torch.enable_grad():  # also inside an autograd backward
        ppass = kgrad_pass_or_none(kernel, params_unflatten(params, leaves),
                                   X.shape[1])
        if ppass is None:
            return None
        cdt = X.dtype if X.device.type == "cpu" else torch.float32
        ls = ppass.lengthscale
        scalars = torch.stack([torch.as_tensor(s, device=X.device).to(cdt)
                               for s in ppass.scalars]).detach()
        sums = kgrad.kgrad_fused(ppass.components,
                                 (X / ls.detach()).to(cdt).contiguous(),
                                 A.to(cdt).contiguous(), V.to(cdt).contiguous(),
                                 scalars)
        w0 = ppass.base_weight
        w0v = w0.detach() if isinstance(w0, torch.Tensor) else w0
        # the chain rule as the gradient of one scalar, sum_k out_k g_k with
        # the kernel's g_k held fixed (as grad_outputs, tensors would import
        # sympy at the first call: ~4 s)
        terms = [out * g.to(out.dtype).reshape(out.shape)
                 for out, g in ((w0, sums[0]),
                                (ls, -2.0 * w0v * sums[1] / ls.detach()),
                                *zip(ppass.scalars, w0v * sums[2:]))
                 if isinstance(out, torch.Tensor) and out.requires_grad]
        g = torch.autograd.grad(sum(terms), leaves, allow_unused=True) \
            if terms else [None] * len(leaves)
    return params_unflatten(params, [torch.zeros_like(a) if gi is None else gi
                                     for a, gi in zip(leaves, g)])


def kmvm_fused_matmat(kernel, X, V, R, params, *, compute_dtype=None,
                      split_tiles: int | None = None):
    """K(X, X) @ V plus the CG dot block, in ONE kernel launch.

    Returns (KV (n, t) fp32, dots (4, t) fp32) with dots rows
    [<Kv, v>, <r, v>, <r, r>, <v, v>] per column. No noise term: the caller
    adds sigma^2 V to KV and sigma^2 <v, v> to dots[0]. Raises ValueError
    unless the spec plans to a single fused pass. KV is `kmvm_block`'s bit
    for bit at the same `split_tiles`.
    """
    cdt = _compute_dtype(compute_dtype)
    ppass = fused_pass_or_none(kernel, params)
    if ppass is None:
        raise ValueError(
            f"kmvm_fused_matmat needs a single-fused-pass plan; "
            f"{kernel!r} plans to {mvm_plan(kernel, params)}")
    Xs = _prescale(ppass, X, cdt)
    # the row views enter UNSCALED and fp32
    return kmvm_fused_dots(
        ppass.components, Xs, Xs, _scale_rhs(ppass, V, cdt),
        V.to(torch.float32).contiguous(), R.to(torch.float32).contiguous(),
        _pass_scalar_vector(ppass, X.device), split_tiles)


def pallas_block_fn(kernel, *, compute_dtype=None):
    """Adapter for `partitioned.kmvm_rect(..., block_fn=...)`: per-partition
    slab MVMs go through the fused kernel instead of the dense slab. (The
    name keeps the reference's, as the backend key "pallas" does.)"""

    def fn(Xb, X, V, params):
        return kmvm_block(kernel, Xb, X, V, params, compute_dtype=compute_dtype)

    return fn
