"""Small helpers shared by the port (the numpy ones copied from
stardist_tpu/utils.py)."""
from __future__ import annotations

import numpy as np
import torch


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


def as_tensor_on(x, device):
    """A tensor as it is (on its own device); anything else as a numpy array
    moved to ``device``. A numpy input is not run on the CPU unless the
    caller asks for ``device="cpu"``: with no card, ``"cuda"`` raises."""
    if isinstance(x, torch.Tensor):
        return x
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for a numpy input: pass device='cpu' "
                           "to run on the CPU")
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)
