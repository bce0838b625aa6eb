"""Query generator `pool_rows`: request k of a client is `rows` points
drawn with replacement from the host copy of the configuration's query pool
(numpy), as a client holds its request; the seed, the client and k fix it."""

from __future__ import annotations

import numpy as np


def rows(pool, seed: int, client: int, k: int, rows: int):
    rng = np.random.default_rng([int(seed) % (2 ** 63), client, k])
    return pool[rng.integers(0, pool.shape[0], size=rows)]
