"""The Eq. 2 backward's kernel (B5) and its plain PyTorch version.

    kgrad_fused(components, X, A, V, scalars) -> (2 + L,) fp32
        [S0, S1, dq/ds_0 .. dq/ds_L-1] of q = sum_ij W_ij k(d2_ij),
        W = A V^T, k = sum_c w_c prod_f phi_cf(q_cf d2), over one fused pass

X arrives pre-scaled by the pass's reference lengthscale (d2 = |x_i - x_j|^2
/ l^2) and the scalars in `kmvm.scalar_layout` order, as the MVM kernels
take them; A and V are the (n, t) column pairs of the quadratic form. S0 =
sum W k is the gradient in the pass's base weight, S1 = sum W d2 dk/dd2
gives the one in the lengthscale (-(2 / l) S1), and dq/ds the ones in the
pass's scalars; `ops.kgrad_grads` carries them to the raw leaves. The
kernel (`csrc/kgrad.cu`, see the note at its top) walks the (n, n) tiles
once and sums in fp64; no slab, W or dK/dtheta reaches device memory. It
replaces no TPU kernel: the reference differentiates the same contraction
with XLA's autodiff over row slabs (`repro.core.partitioned.
quad_form_partials`).

The rows and columns are the same points, so both versions take d2 = 0
exactly for a point against itself (the norm expansion's rounding there
moves matern12's phi by ~3e-4 in fp32).

A CPU tensor goes to the plain version (`kgrad_plain`: the same sums slab
by slab, without autograd, in X's dtype or fp32), a CUDA tensor to the
kernel, or an exception; nothing falls back. `launches` counts the
kernel's launches (`reset_launches` zeroes it). It is kept apart from `kmvm.launch_counts`, whose every
key counts as a forward MVM.
"""

from __future__ import annotations

import threading

import torch

from . import build
from .kmvm import _PLAIN_ROWS, _column_split, _spec_array, scalar_layout

MAX_FEATURES = 16    # d of one feature stage of the kernel
MAX_COMPONENTS = 2   # the kernel's largest spec class: 2 components
MAX_FACTORS = 2      # of 2 factors each

_count_lock = threading.Lock()
launches = 0


def _count() -> None:
    global launches
    with _count_lock:
        launches += 1


def reset_launches() -> None:
    """Set `launches` to 0."""
    global launches
    with _count_lock:
        launches = 0


def takes(components) -> bool:
    """Whether the kernel's spec classes hold `components`."""
    return (len(components) <= MAX_COMPONENTS
            and all(len(kinds) <= MAX_FACTORS for kinds in components))


def _factor_grad(kind, q, alpha, d2, r):
    """(phi, psi = u phi'(u), d phi / d alpha or None) of one factor at u =
    q d2, with the kernel's expressions (r = sqrt(d2))."""
    if kind == "rbf":
        u = q * d2
        phi = torch.exp(-0.5 * u)
        return phi, -0.5 * u * phi, None
    if kind == "rq":
        u = q * d2
        z = u / (2.0 * alpha)
        lg = torch.log1p(z)
        iz = 1.0 / (1.0 + z)
        phi = torch.exp(-alpha * lg)
        return phi, -0.5 * u * phi * iz, phi * (z * iz - lg)
    rr = torch.sqrt(q) * r
    if kind == "matern12":
        phi = torch.exp(-rr)
        return phi, -0.5 * rr * phi, None
    if kind == "matern32":
        a = 1.7320508075688772 * rr
        ea = torch.exp(-a)
        return (1.0 + a) * ea, -0.5 * (a * a) * ea, None
    if kind == "matern52":
        a = 2.23606797749979 * rr
        ea = torch.exp(-a)
        return (1.0 + a + (a * a) / 3.0) * ea, -((a * a) / 6.0) * (1.0 + a) * ea, None
    b = torch.clamp(1.0 - rr, min=0.0)
    b2 = b * b
    if kind == "wendland2":
        return b2 * b2 * (4.0 * rr + 1.0), -10.0 * (rr * rr) * (b2 * b), None
    if kind == "wendland4":
        b3 = b2 * b
        return (b3 * b3 * ((35.0 * rr * rr + 18.0 * rr + 3.0) / 3.0),
                -(28.0 / 3.0) * (rr * rr) * (b3 * b2) * (5.0 * rr + 1.0), None)
    raise ValueError(f"no fused kernel for kind {kind!r}")


def _slab_sums(components, scalars, d2, W, raw) -> None:
    """raw[slot] += the slot's sum over one slab (see `kgrad_fused`): per
    component sum W T_c, per factor sum W psi others, per rq factor sum W
    dphi/dalpha others."""
    r = torch.sqrt(d2)
    s = 0
    for kinds in components:
        ws = s
        s += 1
        phis, terms = [], []
        for kind in kinds:
            alpha = scalars[s + 1] if kind == "rq" else None
            phi, psi, dal = _factor_grad(kind, scalars[s], alpha, d2, r)
            phis.append(phi)
            terms.append((s, psi, dal))
            s += 2 if kind == "rq" else 1
        T = W
        for phi in phis:
            T = T * phi
        raw[ws] += torch.sum(T).double()
        for f, (slot, psi, dal) in enumerate(terms):
            others = W
            for g, phi in enumerate(phis):
                if g != f:
                    others = others * phi
            raw[slot] += torch.sum(others * psi).double()
            if dal is not None:
                raw[slot + 1] += torch.sum(others * dal).double()


def _outputs(components, scalars, raw) -> torch.Tensor:
    """[S0, S1, dq/ds...] from the slot sums, in fp64 (`kgrad_reduce`)."""
    sc = scalars.double()
    out = torch.zeros(2 + sc.shape[0], dtype=torch.float64, device=raw.device)
    s = 0
    for kinds in components:
        w = sc[s]
        out[0] += w * raw[s]
        out[2 + s] = raw[s]
        s += 1
        for kind in kinds:
            out[1] += w * raw[s]
            out[2 + s] = w * raw[s] / sc[s]
            s += 1
            if kind == "rq":
                out[2 + s] = w * raw[s]
                s += 1
    return out


def kgrad_plain(components, X, A, V, scalars) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (2 + L,) in X's dtype (at least
    fp32), the slot sums taken slab by slab (`_PLAIN_ROWS` rows) and added
    in fp64, so no (n, n) array is ever live."""
    dt = torch.promote_types(X.dtype, torch.float32)
    x, a, v = X.to(dt), A.to(dt), V.to(dt)
    sc = scalars.to(dt)
    nx = torch.sum(x * x, dim=1)
    raw = torch.zeros(sc.shape[0], dtype=torch.float64, device=X.device)
    for i0 in range(0, x.shape[0], _PLAIN_ROWS):
        xi = x[i0:i0 + _PLAIN_ROWS]
        d2 = torch.clamp(nx[i0:i0 + _PLAIN_ROWS, None] + nx[None, :]
                         - 2.0 * (xi @ x.T), min=0.0)
        rows = torch.arange(xi.shape[0], device=X.device)
        d2[rows, rows + i0] = 0.0   # a point against itself, as the kernel
        _slab_sums(components, sc, d2, a[i0:i0 + _PLAIN_ROWS] @ v.T, raw)
    return _outputs(components, sc, raw).to(dt)


def kgrad_fused(components, X, A, V, scalars) -> torch.Tensor:
    """[S0, S1, dq/ds_0 .. dq/ds_L-1] (fp32 on the card) of one fused pass.

    X (n, d) pre-scaled, A and V (n, t), scalars (L,) in `scalar_layout`
    order: contiguous fp32 CUDA tensors on one device (a CPU tensor gets
    the plain version). d <= MAX_FEATURES, at most MAX_COMPONENTS
    components of MAX_FACTORS factors; any n, t >= 1. The columns are
    split as B1's (`kmvm._column_split`).
    """
    if X.device.type == "cpu":
        return kgrad_plain(components, X, A, V, scalars)
    for name, a in (("X", X), ("A", A), ("V", V), ("scalars", scalars)):
        if a.device != X.device:
            raise ValueError(f"{name} is on {a.device}, X on {X.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = X.shape
    t = A.shape[1]
    if A.shape != (n, t) or V.shape != (n, t) or n == 0 or t == 0:
        raise ValueError(f"shapes: X {tuple(X.shape)}, A {tuple(A.shape)}, "
                         f"V {tuple(V.shape)}")
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"the kernel takes 1..{MAX_FEATURES} features, got {d}")
    if not takes(components):
        raise ValueError(f"the kernel takes {MAX_COMPONENTS} components of "
                         f"{MAX_FACTORS} factors at most, got {components}")
    L = scalar_layout(components)
    if scalars.shape != (L,):
        raise ValueError(f"scalars {tuple(scalars.shape)} do not match {components}")
    spec = _spec_array(components)
    nsplit, per = _column_split(n, n, 1)
    part = torch.empty((nsplit * -(-n // 64), L), dtype=torch.float64,
                       device=X.device)
    out = torch.empty(2 + L, dtype=torch.float32, device=X.device)
    lib = build.library()
    code = lib.kgrad_fwd(
        X.data_ptr(), A.data_ptr(), V.data_ptr(), scalars.data_ptr(), spec, L,
        part.data_ptr(), out.data_ptr(), n, d, t, nsplit, per,
        torch.cuda.current_stream(X.device).cuda_stream)
    if code != 0:
        msg = lib.kgrad_error_string(code).decode()
        raise RuntimeError(f"kgrad launch failed: CUDA error {code} ({msg})")
    _count()
    return out
