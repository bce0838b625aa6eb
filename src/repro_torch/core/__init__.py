"""repro_torch.core — kernel algebra, operators, preconditioner, PCG, SLQ,
the BBMM marginal likelihood, ExactGP, the distributed engine and the
prediction caches (see the package docstring)."""
