"""The benchmark's data, made on the device from seeds.

A frozen copy written for the benchmark, so a change to the program cannot
change its inputs. Each data maker is a file of its own, `data/<maker>.py`
with a `make(..., device)` that returns a `Draw`, found by the name a
configuration gives under `"data": {"maker": ...}`:

* `houseelectric`: the analogue of the UCI HouseElectric set that the
  program's `repro_torch.data.synthetic` draws;
* `spatial`: the clustered 2-D sensor field of `examples/spatial_gp.py`.

A configuration fixes the draw (`data_seed`); the run's `--seed` permutes
the training rows and draws the queries, so every seed does the same work
on the same set in another order.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Draw(NamedTuple):
    X: torch.Tensor        # (n, d) training inputs, fp32
    y: torch.Tensor        # (n,) training targets, fp32
    pool: torch.Tensor     # (m, d) the query distribution's points, fp32


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def make(cfg: dict, device) -> Draw:
    """The configuration's draw: `cfg["data"]` names the maker, a file
    under the configuration's benchmark folder (`cfg["bench"]`), and its
    arguments besides the device."""
    from gpbench.harness.manifest import load_part

    spec = dict(cfg["data"])
    maker = load_part("data", spec.pop("maker"), cfg.get("bench", BENCH))
    return maker.make(**spec, device=device)


def permuted(draw: Draw, seed: int) -> Draw:
    """The draw with its training rows in the order `seed` gives."""
    g = generator(seed, "cpu")
    perm = torch.randperm(draw.X.shape[0], generator=g).to(draw.X.device)
    return draw._replace(X=draw.X[perm].contiguous(), y=draw.y[perm].contiguous())
