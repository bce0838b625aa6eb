"""repro_torch.core — exact GPs via BBMM + partitioned / distributed kernel
MVMs, with the reference's public names (see the package docstring for the
layering): kernel algebra, operators, preconditioner, PCG, SLQ, the BBMM
marginal likelihood, ExactGP, the prediction caches, the paper's SGPR /
SVGP baselines and the deep-kernel-learning head. The distributed engine
is `repro_torch.core.distributed`."""

from .gp import ExactGP, ExactGPConfig, gaussian_nll, rmse
from .kernels_math import (
    GPParams,
    KERNEL_KINDS,
    KernelParams,
    LEAF_KINDS,
    Leaf,
    Product,
    STATIONARY_KINDS,
    Scale,
    Sum,
    TAPER_KINDS,
    as_spec,
    canonicalize_kernel,
    dense_khat,
    init_kernel_params,
    init_params,
    init_params_for,
    kernel_diag,
    kernel_matrix,
    lengthscale,
    noise_variance,
    normalize_components,
    num_components,
    outputscale,
    parse_kernel,
    params_skeleton,
    spec_expr,
    spec_from_json,
    spec_to_json,
)
from .mll import (
    MLLConfig, dense_mll, exact_mll, operator_mll_backward,
    operator_mll_forward,
)
from .operators import (
    DenseOperator,
    KernelOperator,
    OperatorConfig,
    PallasFusedOperator,
    PartitionedOperator,
    make_operator,
    operator_backends,
    register_operator,
)
from .partitioned import kmvm, map_row_chunks, quad_form
from .pcg import PCGResult, SolveState, pcg
from .pivchol import Preconditioner, make_preconditioner, pivoted_cholesky
from .predcache import (
    PredictionCache,
    build_prediction_cache,
    build_variance_cache,
    lanczos,
    predict_mean,
    predict_var_cached,
    predict_var_exact,
)
from .slq import exact_logdet, slq_logdet, slq_logdet_correction
from .sgpr import (
    SGPRParams, init_sgpr_params, sgpr_elbo, sgpr_loss, sgpr_precompute,
    sgpr_predict,
)
from .svgp import (
    SVGPParams, init_svgp_params, svgp_elbo, svgp_loss, svgp_predict,
)
from .dkl import DKLModel, make_mlp_dkl

__all__ = [
    "DenseOperator", "ExactGP", "ExactGPConfig", "GPParams", "KERNEL_KINDS",
    "KernelParams", "LEAF_KINDS", "Leaf", "Product", "STATIONARY_KINDS",
    "Scale", "Sum", "TAPER_KINDS", "as_spec", "canonicalize_kernel",
    "init_kernel_params", "init_params_for",
    "normalize_components", "num_components", "parse_kernel",
    "params_skeleton", "spec_expr", "spec_from_json", "spec_to_json",
    "KernelOperator", "MLLConfig", "OperatorConfig", "PCGResult",
    "PallasFusedOperator", "PartitionedOperator", "PredictionCache",
    "Preconditioner",
    "build_prediction_cache", "build_variance_cache", "dense_khat",
    "dense_mll", "exact_logdet",
    "exact_mll", "gaussian_nll", "init_params", "kernel_diag",
    "kernel_matrix", "kmvm", "lanczos", "lengthscale", "make_operator",
    "make_preconditioner", "map_row_chunks",
    "noise_variance", "operator_backends", "operator_mll_backward",
    "operator_mll_forward",
    "outputscale", "pcg", "pivoted_cholesky", "SolveState",
    "predict_mean", "predict_var_cached", "predict_var_exact", "quad_form",
    "register_operator", "rmse", "slq_logdet", "slq_logdet_correction",
    "SGPRParams", "init_sgpr_params", "sgpr_elbo", "sgpr_loss",
    "sgpr_precompute", "sgpr_predict",
    "SVGPParams", "init_svgp_params", "svgp_elbo", "svgp_loss", "svgp_predict",
    "DKLModel", "make_mlp_dkl",
]
