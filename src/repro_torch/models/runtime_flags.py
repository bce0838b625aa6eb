"""Trace-time behaviour flags, kept as API counterparts.

The counterpart of `repro.models.runtime_flags`. The reference needs them
because XLA's `cost_analysis` counts a while-loop body once: the dry run
unrolls inner loops (`REPRO_DRYRUN_UNROLL=1`) and compiles the depth loop
at unroll 1 and 2 (`REPRO_LAYER_UNROLL`). Eager PyTorch runs every layer
and every loop iteration, and a counter sees each of them, so there is
nothing for these flags to correct: the functions read the same
environment variables and return what the reference's do, and nothing in
the port changes its behaviour on them.

`materialize` is the identity, gradient included. The reference pins an
activation as an XLA fusion / scheduling boundary with
`optimization_barrier`; eager PyTorch materializes every intermediate, so
the barrier has no meaning here.
"""

from __future__ import annotations

import os


def unroll_enabled() -> bool:
    return os.environ.get("REPRO_DRYRUN_UNROLL", "0") == "1"


def materialize(x):
    """Identity (value and gradient); see the module docstring."""
    return x


def scan_unroll():
    """The reference's inner-loop unroll setting: True under the dry-run
    flag, else 1."""
    return True if unroll_enabled() else 1


def layer_scan_unroll() -> int:
    """The reference's depth-loop unroll setting (`REPRO_LAYER_UNROLL`)."""
    return int(os.environ.get("REPRO_LAYER_UNROLL", "1"))


def loop_map(f, xs):
    """`lax.map` over the leading axis of a tensor or a tuple of tensors:
    a Python loop whose outputs are stacked."""
    import torch

    leaves = xs if isinstance(xs, (tuple, list)) else (xs,)
    n = leaves[0].shape[0]
    outs = [f(type(xs)(a[i] for a in xs) if isinstance(xs, (tuple, list))
              else xs[i]) for i in range(n)]
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(torch.stack(ys) for ys in zip(*outs))
    return torch.stack(outs)
