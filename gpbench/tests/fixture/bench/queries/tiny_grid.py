"""A test's query generator: `rows` evenly spaced points, shifted by k."""

import numpy as np


def rows(pool, seed, client, k, rows):
    return (np.linspace(0.0, 1.0, rows, dtype=np.float32) + 0.01 * k)[:, None]
