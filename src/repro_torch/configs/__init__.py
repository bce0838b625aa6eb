"""One config module per assigned architecture (+ the paper's GP workload).

The port's own copy of `repro.configs`, value for value. Each module exposes
CONFIG (ArchConfig for LM archs; GPWorkloadConfig for gp-exact-1m).
`repro_torch.models.registry.get_arch` resolves --arch ids here.
"""
