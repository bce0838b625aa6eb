"""repro_torch.core — kernel algebra, operators, preconditioner, PCG, SLQ,
the BBMM marginal likelihood, ExactGP, the distributed engine, the
prediction caches (see the package docstring) and the paper's SGPR / SVGP
baselines (`sgpr`, `svgp`)."""

from .sgpr import (
    SGPRParams, init_sgpr_params, sgpr_elbo, sgpr_loss, sgpr_precompute,
    sgpr_predict,
)
from .svgp import (
    SVGPParams, init_svgp_params, svgp_elbo, svgp_loss, svgp_predict,
)

__all__ = [
    "SGPRParams", "init_sgpr_params", "sgpr_elbo", "sgpr_loss",
    "sgpr_precompute", "sgpr_predict",
    "SVGPParams", "init_svgp_params", "svgp_elbo", "svgp_loss", "svgp_predict",
]
