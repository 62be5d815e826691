"""Small numpy helpers shared by the port (copies from stardist_tpu/utils.py)."""
from __future__ import annotations

import numpy as np


def _is_power_of_2(i):
    assert i > 0
    e = np.log2(i)
    return e == int(e)


def _normalize_grid(grid, n):
    try:
        grid = tuple(grid)
        if not (len(grid) == n and all(map(np.isscalar, grid)) and all(map(_is_power_of_2, grid))):
            raise TypeError()
        return tuple(int(g) for g in grid)
    except (TypeError, AssertionError):
        raise ValueError(
            f"grid = {grid} must be a list/tuple of length {n} with values that are power of 2"
        )
