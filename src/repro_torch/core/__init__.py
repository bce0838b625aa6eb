"""repro_torch.core — kernel algebra, operators, preconditioner, PCG and
the prediction caches of the serving path (see the package docstring)."""
