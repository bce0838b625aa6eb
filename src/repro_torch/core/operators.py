"""KernelOperator — the single MVM access point of the solver and the caches.

The counterpart of `repro.core.operators`. A ``KernelOperator`` binds an
``OperatorConfig`` (kernel, backend, blocking, noise and dtype policy) to
training inputs ``X`` and hyperparameters ``params`` on one device, and
exposes:

    matvec(V)            K_hat @ V        (n, t) -> (n, t); the hot path
    diag()               diag(K_hat)      (n,)
    cross_matvec(Z, V)   K(Z, X) @ V      rectangular MVM for prediction
    quad_form_grads(A,V) (g_params, g_X) of sum_j a_j^T K_hat v_j — the
                         bounded-memory backward surface of the MLL
    routed_quad_form_grads(A,V)  the same and how it contracted:
                         "autograd" (the blockwise autograd loop) or
                         "fused" (one kernel)
    kernel_rows(Z)       K(Z, X)          dense rows (test oracle RHS)
    prior_diag(Z)        diag(K(Z, Z))
    noise()              sigma^2
    preconditioner(k)    rank-k pivoted-Cholesky preconditioner of K_hat
    supports_fused_step  whether fused_matvec_dots is one kernel launch
    fused_matvec_dots    (K_hat V, [<K_hat v, v>, <r, v>, <r, r>, <v, v>])

Registry (`make_operator` selects by `OperatorConfig.backend`):

    dense         materialize K_hat once; O(n^2) memory — the oracle
    partitioned   row-block slabs — the paper's O(n)-memory path
    pallas        the Hopper fused-kernel backend: every MVM is the CUDA
                  kernel of `repro_torch.kernels.kmvm` (the slab never
                  reaches device memory), a CG iteration is one launch of
                  its fused-CG variant, and the Eq. 2 backward of a
                  shared-lengthscale spec is one launch of
                  `repro_torch.kernels.kgrad` when no X gradient is asked
                  for. The key keeps the reference's name so that reference
                  configs and artifacts load as they are.
    blocksparse   distance-pruned MVMs for compactly-supported specs: the
                  block-sparse CUDA kernel over a `repro_torch.sparse`
                  plan (registered lazily, as in the reference)

    sharded       K_hat over a `torch.distributed` mesh
                  (`repro_torch.core.distributed`, registered lazily): rows
                  and columns sharded per `OperatorConfig.geom`, composing
                  an inner backend for the local tiles

``compute_dtype="bfloat16"`` runs the large products on bf16 operands with
fp32 accumulation; the elementwise kernel math, the noise diagonal and all
solver state stay fp32 (or fp64). `matvec`/`cross_matvec` return the
operand dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..device import resolve_device
from . import partitioned
from .kernels_math import (
    canonicalize_kernel,
    kernel_diag,
    kernel_from_sqdist,
    kernel_matrix,
    noise_variance,
    normalize_components,
    params_leaves,
    params_map,
    params_map2,
    params_unflatten,
    softplus,
)
from .pivchol import make_preconditioner


class OperatorConfig(NamedTuple):
    """Static kernel-operator configuration, with the reference's field names
    so that a reference-written manifest's `operator_config` constructs it.

    kernel:        a legacy stationary kind (with GPParams) or a KernelSpec
                   tree / expression like "0.5*rbf + matern32".
    backend:       registry key — "dense" | "partitioned" | "pallas".
    row_block:     rows per partition slab (partitioned; pallas cross_matvec).
    add_noise:     whether matvec applies K_hat (True) or plain K (False).
    noise_floor:   sigma^2 floor (see kernels_math.noise_variance).
    compute_dtype: None = the exact path; "bfloat16" = bf16 operands with
                   fp32 accumulation in the large products.
    fused_cg:      the fused-CG step (None = wherever supported, False off).
    plan:          `repro_torch.sparse.SparsePlan` of the blocksparse
                   backend; None lets the operator build one.
    geom:          the `DistGeometry` of the sharded backend (None elsewhere).
    inner_backend: the sharded backend's per-tile backend ("partitioned",
                   "pallas" or "blocksparse").
    autotune:      pick the fused kernels' column split (`tiles_per_split`)
                   for the pallas backend's (n, n) launches with
                   `repro_torch.kernels.autotune` instead of the static
                   default (the reference tunes its Pallas tiles there).
    interpret:     the reference's TPU interpret flag; accepted so that its
                   configs load, no effect on this card.
    """

    kernel: str = "matern32"
    backend: str = "partitioned"
    row_block: int = 1024
    add_noise: bool = True
    noise_floor: float = 1e-4
    compute_dtype: str | None = None
    interpret: bool | None = None
    geom: object | None = None
    inner_backend: str = "partitioned"
    plan: object | None = None
    autotune: bool = False
    fused_cg: bool | None = None


_REGISTRY: dict[str, type] = {}


def register_operator(name: str) -> Callable[[type], type]:
    """Class decorator: register a KernelOperator backend under `name`."""

    def deco(cls: type) -> type:
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_lazy_registered() -> None:
    if "blocksparse" not in _REGISTRY:
        # repro_torch.sparse registers BlockSparseOperator on import
        from repro_torch.sparse import blocksparse  # noqa: F401
    if "sharded" not in _REGISTRY:
        from repro_torch.core import distributed  # noqa: F401


def operator_backends() -> tuple[str, ...]:
    """Registered backend names (triggers the lazy registration)."""
    _ensure_lazy_registered()
    return tuple(sorted(_REGISTRY))


def _resolve_backend(name: str) -> type:
    if name not in _REGISTRY:
        _ensure_lazy_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown operator backend {name!r} "
            f"(registered: {operator_backends()})") from None


def make_operator(config: OperatorConfig, X, params, *,
                  device=None) -> "KernelOperator":
    """The single factory every consumer goes through. X and params move to
    `device` (None = the card; raises when there is none)."""
    if (config.geom is not None) != (config.backend == "sharded"):
        raise ValueError("OperatorConfig.geom goes with backend='sharded' "
                         "and only with it")
    dev = resolve_device(device)
    cls = _resolve_backend(config.backend)
    X = torch.as_tensor(X, device=dev)
    params = params_map(lambda a: torch.as_tensor(a, device=dev), params)
    return cls(config, X, params)


def slab_block_fn_for(backend: str, config: OperatorConfig, operand_dtype):
    """The per-slab MVM override of `backend` (registry-resolved, so a new
    slab backend composes with the sharded operator at once)."""
    return _resolve_backend(backend).slab_block_fn(config, operand_dtype)


def slab_acc_fn_for(backend: str, config: OperatorConfig, operand_dtype):
    """The chunk-accumulate step of `backend`, or None where it has none
    (see `KernelOperator.slab_acc_fn`)."""
    return _resolve_backend(backend).slab_acc_fn(config, operand_dtype)


def _compute_dtype_of(config: OperatorConfig, operand_dtype) -> torch.dtype | None:
    """The matmul dtype; None means 'exact path, no casting' (only valid
    when the operands are already full precision in that dtype)."""
    if config.compute_dtype is None:
        return None
    cdt = getattr(torch, config.compute_dtype)
    if cdt == operand_dtype and cdt.itemsize >= 4:
        return None
    return cdt


def mixed_block_fn(kernel, compute_dtype) -> Callable:
    """Per-slab K(Xb, X) @ V with reduced-precision products, for any spec:
    every large product runs on `compute_dtype` operands with fp32
    accumulation; norms, phi(d2), weights and the component sum stay fp32;
    the result returns in V.dtype. Each stationary factor pays its own
    distance product here (the shared-d2 evaluation is the fused kernel's)."""
    def rounded(A):
        return A.to(compute_dtype).to(torch.float32)

    def factor_tile(kind, p, Xb, X):
        if kind == "linear":
            s = softplus(p.raw_scale)
            return rounded(Xb / s) @ rounded(X / s).T
        ls = softplus(p.raw_lengthscale)
        Xb_c = rounded(Xb / ls)
        X_c = rounded(X / ls)
        g = Xb_c @ X_c.T
        ni = torch.sum(Xb_c * Xb_c, -1, keepdim=True)
        nj = torch.sum(X_c * X_c, -1, keepdim=True).T
        d2 = torch.clamp(ni + nj - 2.0 * g, min=0.0)
        if kind == "rq":
            return kernel_from_sqdist("rq", d2, softplus(p.raw_alpha))
        return kernel_from_sqdist(kind, d2)

    def fn(Xb, X, V, params):
        spec, kp = canonicalize_kernel(kernel, params)
        K = None
        for term in normalize_components(spec, kp):
            tile = None
            for kind, p in term.factors:
                f = factor_tile(kind, p, Xb, X)
                tile = f if tile is None else tile * f
            tile = torch.as_tensor(term.weight).to(torch.float32) * tile
            K = tile if K is None else K + tile
        return (rounded(K) @ rounded(V)).to(V.dtype)

    return fn


class KernelOperator:
    """Base class: binds (config, X, params); see the module docstring.
    Subclasses implement `matvec`."""

    # the backend the MLL's Eq. 2 backward contracts through: the base-class
    # blockwise partials serve dense and partitioned; pallas and blocksparse
    # have their own
    grad_backend = "partitioned"
    # per-row validity mask of the operator's local vector layout: None
    # except on padded sharded geometries, where the MLL forward multiplies
    # it into the centered targets
    local_mask = None

    def __init__(self, config: OperatorConfig, X: torch.Tensor, params):
        self.config = config
        self.X = X
        self.params = params

    @property
    def shape(self) -> tuple[int, int]:
        n = self.X.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def kernel(self):
        """The kernel spec the operator was configured with."""
        return self.config.kernel

    def matvec(self, V: torch.Tensor) -> torch.Tensor:
        """K_hat @ V (or K @ V when config.add_noise is False)."""
        raise NotImplementedError

    def diag(self) -> torch.Tensor:
        d = kernel_diag(self.config.kernel, self.X, self.params)
        if self.config.add_noise:
            d = d + noise_variance(self.params, self.config.noise_floor)
        return d

    def _add_noise(self, out, V):
        if self.config.add_noise:
            out = out + noise_variance(self.params, self.config.noise_floor) * V
        return out

    # -- prediction-time surface -------------------------------------------

    def cross_matvec(self, Z: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """K(Z, X) @ V — rectangular, never any noise term."""
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        out = partitioned.kmvm_rect(
            self.config.kernel, Z, self.X, V, self.params,
            row_block=self.config.row_block, block_fn=self._block_fn())
        return out[:, 0] if squeeze else out

    def kernel_rows(self, Z: torch.Tensor) -> torch.Tensor:
        """Dense K(Z, X) rows — O(|Z| n)."""
        return kernel_matrix(self.config.kernel, Z, self.X, self.params)

    def prior_diag(self, Z: torch.Tensor) -> torch.Tensor:
        return kernel_diag(self.config.kernel, Z, self.params)

    def noise(self) -> torch.Tensor:
        return noise_variance(self.params, self.config.noise_floor)

    def quad_form_grads(self, A: torch.Tensor, V: torch.Tensor,
                        need_x: bool = True):
        """(g_params, g_X) of q = sum_j a_j^T K_hat v_j, bounded memory: the
        kernel part by `partitioned.quad_form_partials` (one slab and its
        autograd residuals live at a time, half-size row blocks), the
        sigma^2 sum(A o V) diagonal by autograd on the noise leaf. need_x
        False lets a backend leave g_X out (None); this loop computes it
        either way."""
        if A.ndim == 1:
            A = A[:, None]
        if V.ndim == 1:
            V = V[:, None]
        gp, g_rows, g_cols = partitioned.quad_form_partials(
            self.config.kernel, self.X, self.X, A, V, self.params,
            row_block=max(self.config.row_block // 2, 64))
        return self._add_noise_grad(gp, A, V), g_rows + g_cols

    def routed_quad_form_grads(self, A: torch.Tensor, V: torch.Tensor,
                               need_x: bool = True):
        """(g_params, g_X, route): `quad_form_grads` and how it contracted,
        here always "autograd"."""
        return (*self.quad_form_grads(A, V, need_x), "autograd")

    def _add_noise_grad(self, gp, A, V):
        """gp + d/dparams [sigma^2(params) sum(A o V)]."""
        dot_av = torch.sum(A * V).detach()
        leaves = [a.detach().requires_grad_(True) for a in params_leaves(self.params)]
        with torch.enable_grad():  # also inside an autograd backward
            s2 = noise_variance(params_unflatten(self.params, leaves),
                                self.config.noise_floor) * dot_av
            g = torch.autograd.grad(s2, leaves, allow_unused=True)
        g = [torch.zeros_like(a) if gi is None else gi for a, gi in zip(leaves, g)]
        return params_map2(torch.add, gp, params_unflatten(self.params, g))

    # -- solver hooks -------------------------------------------------------

    def preconditioner(self, rank: int, reuse=None):
        """Rank-k pivoted-Cholesky preconditioner of K_hat (`reuse`: return
        a previous one as-is)."""
        return make_preconditioner(
            self.config.kernel, self.X, self.params, rank,
            self.config.noise_floor, reuse=reuse)

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum partial reductions over row shards (identity on one device)."""
        return x

    @property
    def supports_fused_step(self) -> bool:
        """Whether `fused_matvec_dots` is genuinely one launch."""
        return False

    def fused_matvec_dots(self, V: torch.Tensor, R: torch.Tensor):
        """(K_hat @ V, dots) with dots (4, t) = per-column
        [<K_hat v, v>, <r, v>, <r, r>, <v, v>]: here the plain matvec
        followed by reductions, shared by every backend without fusion."""
        out = self.matvec(V)
        dots = torch.stack([
            torch.sum(out * V, 0), torch.sum(R * V, 0),
            torch.sum(R * R, 0), torch.sum(V * V, 0)])
        return out, dots

    # -- internals ----------------------------------------------------------

    @classmethod
    def slab_block_fn(cls, config: OperatorConfig, operand_dtype) -> Callable | None:
        """Per-slab MVM override for a partitioned outer loop; None = the
        dense slab path."""
        cdt = _compute_dtype_of(config, operand_dtype)
        if cdt is None:
            return None
        return mixed_block_fn(config.kernel, cdt)

    @classmethod
    def slab_acc_fn(cls, config: OperatorConfig, operand_dtype) -> Callable | None:
        """acc_fn(Xi, Xj, V, params, acc) -> acc adding K(Xi, Xj) @ V into
        an fp32 accumulator in place — the distributed ring's chunk step —
        for backends with a kernel that carries it; None = the chunk result
        is added to the partial by the caller."""
        return None

    def _block_fn(self) -> Callable | None:
        return type(self).slab_block_fn(self.config, self.dtype)


@register_operator("dense")
class DenseOperator(KernelOperator):
    """Reference backend: materializes K_hat once — O(n^2) memory."""

    def __init__(self, config: OperatorConfig, X, params):
        super().__init__(config, X, params)
        self._K_cached: torch.Tensor | None = None

    def _khat(self) -> torch.Tensor:
        """K_hat, built on first matvec (prediction paths never pay it)."""
        if self._K_cached is None:
            K = kernel_matrix(self.config.kernel, self.X, self.X, self.params)
            if self.config.add_noise:
                K = K + noise_variance(self.params, self.config.noise_floor) \
                    * torch.eye(self.X.shape[0], dtype=K.dtype, device=K.device)
            self._K_cached = K
        return self._K_cached

    def matvec(self, V):
        K = self._khat()
        cdt = _compute_dtype_of(self.config, self.dtype)
        if cdt is None:
            return K @ V
        return (K.to(cdt).to(torch.float32) @ V.to(cdt).to(torch.float32)).to(V.dtype)


@register_operator("partitioned")
class PartitionedOperator(KernelOperator):
    """The paper's O(n)-memory path: row-block slabs
    (`repro_torch.core.partitioned.kmvm`)."""

    def matvec(self, V):
        return partitioned.kmvm(
            self.config.kernel, self.X, V, self.params,
            row_block=self.config.row_block,
            add_noise=self.config.add_noise,
            noise_floor=self.config.noise_floor,
            block_fn=self._block_fn())


@register_operator("pallas")
class PallasFusedOperator(PartitionedOperator):
    """The Hopper fused-kernel backend (the key keeps the reference's name).

    matvec is one launch of the fused kernel per fused pass over the whole
    (n, n) matrix — a single launch for any shared-lengthscale spec — so
    the kernel slab lives tile by tile in shared memory and never reaches
    device memory. Specs with dense-fallback terms keep the slab loop, which
    bounds the fallback's transient memory. With a single-fused-pass plan,
    `fused_matvec_dots` returns the MVM and the CG dot block from ONE launch
    (`kmvm_fused_matmat`), so a CG iteration is one kernel launch plus the
    O(nk) preconditioner apply. With `config.autotune` both take the column
    split `repro_torch.kernels.autotune` picked for (n, d, t); cross launches
    (serving) keep the static split. The Eq. 2 backward is one launch of
    its own kernel where `routed_quad_form_grads` can take it. On a CPU
    tensor the kernels run their plain PyTorch versions.
    """

    grad_backend = "pallas"

    @classmethod
    def slab_block_fn(cls, config: OperatorConfig, operand_dtype) -> Callable:
        del operand_dtype  # the wrapper handles the dtype policy itself
        from repro_torch.kernels.ops import pallas_block_fn

        return pallas_block_fn(config.kernel, compute_dtype=config.compute_dtype)

    @classmethod
    def slab_acc_fn(cls, config: OperatorConfig, operand_dtype) -> Callable:
        """One chunk-accumulate launch per fused pass (`kmvm_block_acc`)."""
        del operand_dtype
        from repro_torch.kernels.ops import kmvm_block_acc

        def fn(Xi, Xj, V, params, acc):
            return kmvm_block_acc(config.kernel, Xi, Xj, V, params, acc,
                                  compute_dtype=config.compute_dtype,
                                  row_block=config.row_block)

        return fn

    def _tiles(self, t: int) -> int | None:
        """`tiles_per_split` of an (n, n) x (n, t) launch: autotuned when
        asked (B1 and B2 get the same split for the same t, which keeps
        B2's out equal to B1's), else None, the kernels' default."""
        if not self.config.autotune:
            return None
        from repro_torch.kernels.autotune import tiles_for_spec

        n, d = self.X.shape
        return tiles_for_spec(self.config.kernel, self.params, n, n, d, t,
                              device=self.X.device,
                              compute_dtype=self.config.compute_dtype)

    def matvec(self, V):
        from repro_torch.kernels.ops import kmvm_block, mvm_plan

        if mvm_plan(self.config.kernel, self.params).fallback_terms:
            return super().matvec(V)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        out = kmvm_block(self.config.kernel, self.X, self.X, V, self.params,
                         compute_dtype=self.config.compute_dtype,
                         split_tiles=self._tiles(V.shape[1]))
        out = self._add_noise(out, V)
        return out[:, 0] if squeeze else out

    def routed_quad_form_grads(self, A, V, need_x: bool = True):
        """On the fused route the kernel's parameter gradients
        (`kernels.ops.kgrad_grads`, one launch) with the noise term, no g_X
        (None) and "fused": where no X gradient is wanted, X is not float64
        on the card (the kernel computes in fp32) and the spec plans to one
        shared-lengthscale pass the kernel takes. Else the base class's
        loop and "autograd" (ARD, linear and fallback terms, X gradients,
        float64 on the card)."""
        from repro_torch.kernels.ops import kgrad_grads

        if A.ndim == 1:
            A = A[:, None]
        if V.ndim == 1:
            V = V[:, None]
        gp = None
        if not need_x and not (self.X.is_cuda and self.X.dtype == torch.float64):
            gp = kgrad_grads(self.config.kernel, self.X, A.detach(),
                             V.detach(), self.params)
        if gp is None:
            return (*super().quad_form_grads(A, V, need_x), "autograd")
        return self._add_noise_grad(gp, A, V), None, "fused"

    def quad_form_grads(self, A, V, need_x: bool = True):
        """`routed_quad_form_grads` without the route."""
        return self.routed_quad_form_grads(A, V, need_x)[:2]

    @property
    def supports_fused_step(self) -> bool:
        if self.config.fused_cg is False:
            return False
        from repro_torch.kernels.ops import fused_pass_or_none

        return fused_pass_or_none(self.config.kernel, self.params) is not None

    def fused_matvec_dots(self, V, R):
        from repro_torch.kernels.ops import fused_pass_or_none, kmvm_fused_matmat

        if fused_pass_or_none(self.config.kernel, self.params) is None:
            return super().fused_matvec_dots(V, R)
        out, dots = kmvm_fused_matmat(
            self.config.kernel, self.X, V, R, self.params,
            compute_dtype=self.config.compute_dtype,
            split_tiles=self._tiles(V.shape[1]))
        out = out.to(V.dtype)
        if self.config.add_noise:
            sigma2 = noise_variance(self.params, self.config.noise_floor)
            out = out + sigma2 * V
            # <K_hat v, v> = <K v, v> + sigma^2 <v, v>
            dots = dots.clone()
            dots[0] += sigma2.to(dots.dtype) * dots[3]
        return out, dots


def backward_backend_for(backend: str) -> str:
    """The backend the MLL backward contracts Eq. 2 through (see
    `KernelOperator.grad_backend`)."""
    return _resolve_backend(backend).grad_backend
