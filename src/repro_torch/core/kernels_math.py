"""Kernel algebra and GP hyperparameters, on torch tensors.

The counterpart of `repro.core.kernels_math`, cut to what serving needs.
Two parameterizations coexist, as in the reference:

* **Legacy** — ``(kind: str, GPParams)``: one stationary kernel with a
  (shared or ARD) lengthscale, an outputscale, noise and a constant mean,
  all softplus-constrained.
* **Composable** — a static, hashable :class:`KernelSpec` tree (leaves
  ``rbf`` / ``matern12`` / ``matern32`` / ``matern52`` / ``rq`` /
  ``linear`` / ``wendland2`` / ``wendland4``; combinators :class:`Sum`,
  :class:`Product`, :class:`Scale`) paired with a :class:`KernelParams`
  NamedTuple of per-node raw hyperparameters.

``canonicalize_kernel`` maps both onto one (spec, KernelParams) form, and
specs can be written as expressions (``"0.5*rbf + matern32"``,
:func:`parse_kernel`). `spec_to_json` writes exactly what the reference
writes, so artifacts of either package carry the same spec.
"""

from __future__ import annotations

import math
import re
from typing import Any, NamedTuple

import torch

KERNEL_KINDS = ("rbf", "matern12", "matern32", "matern52")
TAPER_KINDS = ("wendland2", "wendland4")
STATIONARY_KINDS = KERNEL_KINDS + ("rq",) + TAPER_KINDS
LEAF_KINDS = STATIONARY_KINDS + ("linear",)

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)

DEFAULT_LENGTHSCALE = 0.693
DEFAULT_OUTPUTSCALE = 0.693
DEFAULT_ALPHA = 2.0


class GPParams(NamedTuple):
    """Raw (unconstrained) hyperparameters of ONE stationary kernel (legacy).

    raw_lengthscale: () for a shared lengthscale or (d,) for ARD.
    raw_outputscale, raw_noise: (); raw_mean: () constant prior mean.
    """

    raw_lengthscale: torch.Tensor
    raw_outputscale: torch.Tensor
    raw_noise: torch.Tensor
    raw_mean: torch.Tensor


# ---------------------------------------------------------------------------
# KernelSpec — the static, hashable structure tree
# ---------------------------------------------------------------------------


class Leaf(NamedTuple):
    """A primitive kernel. Unit amplitude — wrap in Scale for a learned one."""

    kind: str


class Scale(NamedTuple):
    """softplus-constrained learned amplitude times the inner kernel; `init`
    is the constrained outputscale `init_kernel_params` starts from."""

    inner: Any
    init: float = DEFAULT_OUTPUTSCALE


class Sum(NamedTuple):
    terms: tuple


class Product(NamedTuple):
    factors: tuple


KernelSpec = Leaf | Scale | Sum | Product


def validate_spec(spec) -> None:
    if isinstance(spec, Leaf):
        if spec.kind not in LEAF_KINDS:
            raise ValueError(
                f"unknown kernel kind {spec.kind!r} (expected one of {LEAF_KINDS})")
        return
    if isinstance(spec, Scale):
        if not spec.init > 0.0:
            raise ValueError(f"Scale.init must be > 0, got {spec.init}")
        return validate_spec(spec.inner)
    if isinstance(spec, (Sum, Product)):
        kids = spec.terms if isinstance(spec, Sum) else spec.factors
        if not kids:
            raise ValueError(f"{type(spec).__name__} needs >= 1 child")
        for k in kids:
            validate_spec(k)
        return
    raise TypeError(f"not a KernelSpec node: {spec!r}")


def spec_param_nodes(spec) -> tuple:
    """Param-bearing spec nodes in PREORDER — the order KernelParams.nodes
    follows (Sum/Product carry no hyperparameters)."""
    if isinstance(spec, Leaf):
        return (spec,)
    if isinstance(spec, Scale):
        return (spec,) + spec_param_nodes(spec.inner)
    kids = spec.terms if isinstance(spec, Sum) else spec.factors
    out: tuple = ()
    for k in kids:
        out = out + spec_param_nodes(k)
    return out


def spec_expr(spec) -> str:
    """Expression form; `parse_kernel(spec_expr(s)) == s`."""
    if isinstance(spec, Leaf):
        return spec.kind
    if isinstance(spec, Scale):
        inner = spec_expr(spec.inner)
        if isinstance(spec.inner, (Sum, Product, Scale)):
            inner = f"({inner})"
        return f"{spec.init!r}*{inner}"
    if isinstance(spec, Sum):
        return " + ".join(
            f"({spec_expr(t)})" if isinstance(t, Sum) else spec_expr(t)
            for t in spec.terms)
    parts = []
    for f in spec.factors:
        e = spec_expr(f)
        parts.append(f"({e})" if isinstance(f, (Sum, Scale, Product)) else e)
    return "*".join(parts)


def spec_to_json(spec) -> dict:
    """JSON-able structural form (artifact manifests, configs on disk)."""
    if isinstance(spec, Leaf):
        return {"op": "leaf", "kind": spec.kind}
    if isinstance(spec, Scale):
        return {"op": "scale", "init": float(spec.init),
                "inner": spec_to_json(spec.inner)}
    if isinstance(spec, Sum):
        return {"op": "sum", "terms": [spec_to_json(t) for t in spec.terms]}
    return {"op": "product", "factors": [spec_to_json(f) for f in spec.factors]}


def spec_from_json(obj: dict):
    op = obj["op"]
    if op == "leaf":
        return Leaf(obj["kind"])
    if op == "scale":
        return Scale(spec_from_json(obj["inner"]), float(obj["init"]))
    if op == "sum":
        return Sum(tuple(spec_from_json(t) for t in obj["terms"]))
    if op == "product":
        return Product(tuple(spec_from_json(f) for f in obj["factors"]))
    raise ValueError(f"unknown spec op {op!r}")


# ---------------------------------------------------------------------------
# expression parser: "0.5*rbf + matern32*linear + scale(rq)"
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"\s*(?:(\d+\.?\d*(?:[eE][+-]?\d+)?)|([A-Za-z_]\w*)|([+*()]))")


def _tokenize(expr: str) -> list:
    out, pos = [], 0
    while pos < len(expr):
        m = _TOKEN.match(expr, pos)
        if m is None:
            raise ValueError(f"cannot parse kernel expression at: {expr[pos:]!r}")
        num, name, punct = m.groups()
        if num is not None:
            out.append(("num", float(num)))
        elif name is not None:
            out.append(("name", name))
        else:
            out.append((punct, punct))
        pos = m.end()
    out.append(("end", None))
    return out


class _Parser:
    def __init__(self, expr: str):
        self.expr = expr
        self.toks = _tokenize(expr)
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind):
        t = self.next()
        if t[0] != kind:
            raise ValueError(
                f"kernel expression {self.expr!r}: expected {kind!r}, got {t[1]!r}")
        return t

    def parse(self):
        spec = self.sum()
        self.expect("end")
        return spec

    def sum(self):
        terms = [self.term()]
        while self.peek()[0] == "+":
            self.next()
            terms.append(self.term())
        return terms[0] if len(terms) == 1 else Sum(tuple(terms))

    def term(self):
        weight, factors = None, []
        while True:
            kind, val = self.peek()
            if kind == "num":
                self.next()
                if val <= 0.0:
                    raise ValueError(
                        f"kernel expression {self.expr!r}: weights must be > 0 "
                        f"(Scale is softplus-constrained), got {val}")
                weight = val if weight is None else weight * val
            elif kind == "name":
                self.next()
                if val == "scale":
                    self.expect("(")
                    inner = self.sum()
                    self.expect(")")
                    factors.append(Scale(inner))
                elif val in LEAF_KINDS:
                    factors.append(Leaf(val))
                else:
                    raise ValueError(
                        f"kernel expression {self.expr!r}: unknown name {val!r} "
                        f"(leaves: {LEAF_KINDS}, combinator: scale(...))")
            elif kind == "(":
                self.next()
                factors.append(self.sum())
                self.expect(")")
            else:
                break
            if self.peek()[0] != "*":
                break
            self.next()
        if not factors:
            raise ValueError(
                f"kernel expression {self.expr!r}: a term needs >= 1 kernel factor")
        body = factors[0] if len(factors) == 1 else Product(tuple(factors))
        return body if weight is None else Scale(body, weight)


def parse_kernel(expr: str):
    """Expression -> KernelSpec: sums of products of leaves / ``scale(...)``
    / parenthesized sub-expressions; a positive number becomes a `Scale`."""
    spec = _Parser(expr.strip()).parse()
    validate_spec(spec)
    return spec


def as_spec(kernel) -> KernelSpec:
    """str | KernelSpec -> KernelSpec (plain kind strings parse to a Leaf)."""
    if isinstance(kernel, str):
        return parse_kernel(kernel)
    validate_spec(kernel)
    return kernel


# ---------------------------------------------------------------------------
# KernelParams — per-node raw hyperparameters
# ---------------------------------------------------------------------------


class StationaryParams(NamedTuple):
    raw_lengthscale: torch.Tensor    # () shared or (d,) ARD


class RQParams(NamedTuple):
    raw_lengthscale: torch.Tensor
    raw_alpha: torch.Tensor          # () softplus-constrained mixture alpha


class LinearParams(NamedTuple):
    raw_scale: torch.Tensor          # () or (d,): k = <x/s, z/s>


class ScaleParams(NamedTuple):
    raw_outputscale: torch.Tensor


class KernelParams(NamedTuple):
    """Raw hyperparameters for a KernelSpec: one entry of ``nodes`` per
    param-bearing spec node in preorder, plus noise and the constant mean."""

    nodes: tuple
    raw_noise: torch.Tensor
    raw_mean: torch.Tensor


def params_map(fn, params):
    """Apply `fn` to every tensor leaf of a params NamedTuple tree."""
    if isinstance(params, tuple):
        kids = [params_map(fn, p) for p in params]
        return type(params)(*kids) if hasattr(params, "_fields") else tuple(kids)
    return fn(params)


def params_leaves(params) -> list:
    """The tensor leaves of a params NamedTuple tree, in field order (the
    order the reference's pytree flattening gives)."""
    if isinstance(params, tuple):
        return [leaf for p in params for leaf in params_leaves(p)]
    return [params]


def params_unflatten(template, leaves):
    """A tree shaped like `template` with `leaves` (in `params_leaves`
    order) in place of its leaves."""
    it = iter(leaves)
    out = params_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def params_map2(fn, a, b):
    """fn over the leaves of two trees of the same structure."""
    return params_unflatten(a, [fn(x, y) for x, y in
                                zip(params_leaves(a), params_leaves(b))])


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: float) -> float:
    # numerically-stable inverse of softplus for initialisation
    return y + math.log(-math.expm1(-y))


def _full(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


def init_params(
    ard_dims: int | None = None,
    lengthscale: float = DEFAULT_LENGTHSCALE,
    outputscale: float = DEFAULT_OUTPUTSCALE,
    noise: float = 0.1,
    mean: float = 0.0,
    dtype=torch.float32,
    device=None,
) -> GPParams:
    """(Legacy) GPParams whose constrained values equal the floats."""
    ls_shape = () if ard_dims is None else (ard_dims,)
    return GPParams(
        raw_lengthscale=_full(ls_shape, inv_softplus(lengthscale), dtype, device),
        raw_outputscale=_full((), inv_softplus(outputscale), dtype, device),
        raw_noise=_full((), inv_softplus(noise), dtype, device),
        raw_mean=_full((), mean, dtype, device),
    )


def _init_node(node, ard_dims, lengthscale_init, alpha_init, radius_init,
               dtype, device):
    ls_shape = () if ard_dims is None else (ard_dims,)
    raw_ls = _full(ls_shape, inv_softplus(lengthscale_init), dtype, device)
    if isinstance(node, Scale):
        return ScaleParams(_full((), inv_softplus(node.init), dtype, device))
    if node.kind == "rq":
        return RQParams(raw_ls, _full((), inv_softplus(alpha_init), dtype, device))
    if node.kind == "linear":
        return LinearParams(raw_ls)
    if node.kind in TAPER_KINDS:
        # the support radius is always a scalar, even under ARD
        r0 = lengthscale_init if radius_init is None else radius_init
        return StationaryParams(_full((), inv_softplus(r0), dtype, device))
    return StationaryParams(raw_ls)


def init_kernel_params(
    spec,
    ard_dims: int | None = None,
    lengthscale: float = DEFAULT_LENGTHSCALE,
    alpha: float = DEFAULT_ALPHA,
    radius: float | None = None,
    noise: float = 0.1,
    mean: float = 0.0,
    dtype=torch.float32,
    device=None,
) -> KernelParams:
    """KernelParams matching `spec`, constrained values at the given floats
    (Scale nodes start at their spec-recorded `init`)."""
    spec = as_spec(spec)
    nodes = tuple(
        _init_node(n, ard_dims, lengthscale, alpha, radius, dtype, device)
        for n in spec_param_nodes(spec))
    return KernelParams(
        nodes=nodes,
        raw_noise=_full((), inv_softplus(noise), dtype, device),
        raw_mean=_full((), mean, dtype, device),
    )


def init_params_for(
    kernel,
    ard_dims: int | None = None,
    lengthscale: float = DEFAULT_LENGTHSCALE,
    noise: float = 0.1,
    mean: float = 0.0,
    dtype=torch.float32,
    device=None,
) -> GPParams | KernelParams:
    """The legacy-vs-algebra init dispatch: a plain stationary kind string
    keeps the flat GPParams, any spec tree or expression gets KernelParams."""
    if isinstance(kernel, str) and kernel in KERNEL_KINDS:
        return init_params(ard_dims=ard_dims, lengthscale=lengthscale,
                           noise=noise, mean=mean, dtype=dtype, device=device)
    return init_kernel_params(as_spec(kernel), ard_dims=ard_dims,
                              lengthscale=lengthscale, noise=noise,
                              mean=mean, dtype=dtype, device=device)


def params_skeleton(spec) -> KernelParams:
    """Zero-leaf KernelParams with `spec`'s structure (load templates)."""
    z = torch.zeros(())
    nodes = []
    for n in spec_param_nodes(spec):
        if isinstance(n, Scale):
            nodes.append(ScaleParams(z))
        elif n.kind == "rq":
            nodes.append(RQParams(z, z))
        elif n.kind == "linear":
            nodes.append(LinearParams(z))
        else:
            nodes.append(StationaryParams(z))
    return KernelParams(nodes=tuple(nodes), raw_noise=z, raw_mean=z)


def canonicalize_kernel(kernel, params) -> tuple:
    """(kernel, GPParams | KernelParams) -> (spec, KernelParams): a GPParams
    becomes ``Scale(Leaf(kind))`` reusing the same raw tensors."""
    if isinstance(params, GPParams):
        if isinstance(kernel, Leaf):
            kind = kernel.kind
        elif isinstance(kernel, Scale) and isinstance(kernel.inner, Leaf):
            kind = kernel.inner.kind
        elif isinstance(kernel, str) and "(" not in kernel and "*" not in kernel \
                and "+" not in kernel:
            kind = kernel.strip()
        else:
            raise ValueError(
                f"GPParams parameterizes a single stationary kernel; got "
                f"kernel={kernel!r}. Composite specs need KernelParams "
                f"(init_kernel_params).")
        if kind not in KERNEL_KINDS:
            raise ValueError(
                f"unknown kernel kind: {kind!r} (expected one of {KERNEL_KINDS}; "
                f"'rq'/'linear' leaves need KernelParams)")
        spec = Scale(Leaf(kind))
        kp = KernelParams(
            nodes=(ScaleParams(params.raw_outputscale),
                   StationaryParams(params.raw_lengthscale)),
            raw_noise=params.raw_noise, raw_mean=params.raw_mean)
        return spec, kp
    if not isinstance(params, KernelParams):
        raise TypeError(f"expected GPParams or KernelParams, got {type(params)}")
    spec = as_spec(kernel)
    expected = len(spec_param_nodes(spec))
    if len(params.nodes) != expected:
        raise ValueError(
            f"KernelParams has {len(params.nodes)} node entries but spec "
            f"{spec_expr(spec)!r} has {expected} param-bearing nodes")
    return spec, params


def lengthscale(params: GPParams):
    return softplus(params.raw_lengthscale)


def outputscale(params: GPParams):
    return softplus(params.raw_outputscale)


def noise_variance(params, noise_floor: float = 1e-4):
    """sigma^2 with a floor; works on GPParams and KernelParams alike."""
    return softplus(params.raw_noise) + noise_floor


def constant_mean(params):
    return params.raw_mean


# ---------------------------------------------------------------------------
# distances and kernel shapes
# ---------------------------------------------------------------------------


def sq_dist(X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances by the |x|^2 + |y|^2 - 2<x,y> expansion,
    clamped at 0 (the same arithmetic the fused kernel does)."""
    n1_sq = torch.sum(X1 * X1, dim=-1, keepdim=True)
    n2_sq = torch.sum(X2 * X2, dim=-1, keepdim=True).T
    d2 = n1_sq + n2_sq - 2.0 * (X1 @ X2.T)
    return torch.clamp(d2, min=0.0)


def safe_dist(d2: torch.Tensor) -> torch.Tensor:
    """sqrt with a well-defined (zero) gradient at d2 == 0."""
    positive = d2 > 0
    safe = torch.where(positive, d2, torch.ones_like(d2))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(d2))


def _k_matern32(r):
    a = _SQRT3 * r
    return (1.0 + a) * torch.exp(-a)


def _k_matern52(r):
    a = _SQRT5 * r
    return (1.0 + a + (a * a) / 3.0) * torch.exp(-a)


def _k_wendland2(r):
    """(1 - r)_+^4 (4r + 1): exactly 0 at r >= 1."""
    b = torch.clamp(1.0 - r, min=0.0)
    b2 = b * b
    return b2 * b2 * (4.0 * r + 1.0)


def _k_wendland4(r):
    """(1 - r)_+^6 (35 r^2 + 18 r + 3) / 3."""
    b = torch.clamp(1.0 - r, min=0.0)
    b3 = b * b * b
    return b3 * b3 * ((35.0 * r * r + 18.0 * r + 3.0) / 3.0)


def rq_from_sqdist(d2, alpha):
    """Rational quadratic (1 + d2 / 2a)^-a via a stable exp(log1p) form."""
    return torch.exp(-alpha * torch.log1p(d2 / (2.0 * alpha)))


def kernel_from_sqdist(kind: str, d2: torch.Tensor, alpha=None) -> torch.Tensor:
    """Unit-outputscale kernel values from squared scaled distances;
    `alpha` is only read (and required) by "rq"."""
    if kind == "rbf":
        return torch.exp(-0.5 * d2)
    if kind == "rq":
        if alpha is None:
            raise ValueError("kind='rq' needs its alpha parameter")
        return rq_from_sqdist(d2, alpha)
    r = safe_dist(d2)
    if kind == "matern12":
        return torch.exp(-r)
    if kind == "matern32":
        return _k_matern32(r)
    if kind == "matern52":
        return _k_matern52(r)
    if kind == "wendland2":
        return _k_wendland2(r)
    if kind == "wendland4":
        return _k_wendland4(r)
    raise ValueError(
        f"unknown kernel kind: {kind!r} (expected one of {STATIONARY_KINDS})")


# ---------------------------------------------------------------------------
# spec evaluation — dense matrices and diagonals
# ---------------------------------------------------------------------------


def leaf_matrix(kind: str, p, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """Dense (n1, n2) matrix of ONE leaf under its node params (unit scale)."""
    if kind == "linear":
        s = softplus(p.raw_scale)
        return (X1 / s) @ (X2 / s).T
    ls = softplus(p.raw_lengthscale)
    d2 = sq_dist(X1 / ls, X2 / ls)
    if kind == "rq":
        return rq_from_sqdist(d2, softplus(p.raw_alpha))
    return kernel_from_sqdist(kind, d2)


def _node_matrix(spec, nodes, i, X1, X2):
    if isinstance(spec, Leaf):
        return leaf_matrix(spec.kind, nodes[i], X1, X2), i + 1
    if isinstance(spec, Scale):
        s = softplus(nodes[i].raw_outputscale)
        K, j = _node_matrix(spec.inner, nodes, i + 1, X1, X2)
        return s * K, j
    if isinstance(spec, Sum):
        acc = None
        for t in spec.terms:
            K, i = _node_matrix(t, nodes, i, X1, X2)
            acc = K if acc is None else acc + K
        return acc, i
    acc = None
    for f in spec.factors:
        K, i = _node_matrix(f, nodes, i, X1, X2)
        acc = K if acc is None else acc * K
    return acc, i


def kernel_matrix(kernel, X1: torch.Tensor, X2: torch.Tensor, params) -> torch.Tensor:
    """Dense (n1, n2) kernel matrix K_{X1 X2}; no noise term."""
    spec, kp = canonicalize_kernel(kernel, params)
    K, _ = _node_matrix(spec, kp.nodes, 0, X1, X2)
    return K


def _leaf_diag(kind, p, X):
    if kind == "linear":
        Xs = X / softplus(p.raw_scale)
        return torch.sum(Xs * Xs, dim=-1)
    # constant 1 diag in the PARAMS dtype (at least fp32)
    dt = torch.promote_types(p.raw_lengthscale.dtype, torch.float32)
    return torch.ones(X.shape[:-1], dtype=dt, device=X.device)


def _node_diag(spec, nodes, i, X):
    if isinstance(spec, Leaf):
        return _leaf_diag(spec.kind, nodes[i], X), i + 1
    if isinstance(spec, Scale):
        s = softplus(nodes[i].raw_outputscale)
        d, j = _node_diag(spec.inner, nodes, i + 1, X)
        return d * s, j
    if isinstance(spec, Sum):
        acc = None
        for t in spec.terms:
            d, i = _node_diag(t, nodes, i, X)
            acc = d if acc is None else acc + d
        return acc, i
    acc = None
    for f in spec.factors:
        d, i = _node_diag(f, nodes, i, X)
        acc = d if acc is None else acc * d
    return acc, i


def kernel_diag(kernel, X: torch.Tensor, params) -> torch.Tensor:
    """diag(K_XX); dtype follows the PARAMS (>= fp32), not X."""
    spec, kp = canonicalize_kernel(kernel, params)
    d, _ = _node_diag(spec, kp.nodes, 0, X)
    return d


def dense_khat(kernel, X: torch.Tensor, params, noise_floor: float = 1e-4) -> torch.Tensor:
    """Dense K_hat = K_XX + sigma^2 I. Oracle path only: O(n^2)."""
    K = kernel_matrix(kernel, X, X, params)
    s2 = noise_variance(params, noise_floor)
    return K + s2 * torch.eye(X.shape[0], dtype=K.dtype, device=K.device)


# ---------------------------------------------------------------------------
# normalization: spec -> weighted sum of primitive products
# ---------------------------------------------------------------------------


class Term(NamedTuple):
    """One component of the sum-of-products normal form: `weight` (product
    of the Scale amplitudes on its path) times `factors` ((kind, params))."""

    weight: Any
    factors: tuple


def _normalize(spec, nodes, i):
    if isinstance(spec, Leaf):
        return [Term(1.0, ((spec.kind, nodes[i]),))], i + 1
    if isinstance(spec, Scale):
        s = softplus(nodes[i].raw_outputscale)
        terms, j = _normalize(spec.inner, nodes, i + 1)
        return [Term(s * t.weight, t.factors) for t in terms], j
    if isinstance(spec, Sum):
        out = []
        for t in spec.terms:
            ts, i = _normalize(t, nodes, i)
            out.extend(ts)
        return out, i
    expanded = [Term(1.0, ())]
    for f in spec.factors:
        ts, i = _normalize(f, nodes, i)
        expanded = [Term(a.weight * b.weight, a.factors + b.factors)
                    for a in expanded for b in ts]
    return expanded, i


def normalize_components(spec, kparams: KernelParams) -> tuple:
    """Distribute the spec into a flat weighted sum of primitive products —
    the form the fused-pass plan (`repro_torch.kernels.ops`) consumes."""
    terms, used = _normalize(spec, kparams.nodes, 0)
    if used != len(kparams.nodes):
        raise ValueError(f"spec used {used} of {len(kparams.nodes)} nodes")
    return tuple(terms)


def num_components(kernel) -> int:
    """Number of additive components the spec normalizes to (static)."""
    spec = as_spec(kernel) if isinstance(kernel, str) else kernel
    if isinstance(spec, Leaf):
        return 1
    if isinstance(spec, Scale):
        return num_components(spec.inner)
    if isinstance(spec, Sum):
        return sum(num_components(t) for t in spec.terms)
    out = 1
    for f in spec.factors:
        out *= num_components(f)
    return out
