"""Small helpers shared by the port (the numpy ones copied from
stardist_tpu/utils.py)."""
from __future__ import annotations

import warnings
from collections import namedtuple

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt, find_objects

from .matching import _check_label_array


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


def grid_divisible_patch_size(patch_size, grid, warn=True):
    patch_size, grid = tuple(patch_size), tuple(grid)
    assert len(patch_size) == len(grid)
    rounded = tuple(int(np.ceil(p / g) * g) for p, g in zip(patch_size, grid))
    if rounded != patch_size and warn:
        warnings.warn(
            f"increasing patch_size from {patch_size} to {rounded}, "
            f"since it was not evenly divisible by grid {grid}"
        )
    return rounded


Region = namedtuple("Region", ("label", "slice", "bbox", "centroid", "area"))


def regions(lbl):
    """Minimal regionprops: per-label slice, bbox, centroid, area; bbox as
    (min_0, ..., min_n, max_0, ..., max_n) with exclusive max."""
    _check_label_array(lbl, "lbl")
    out = []
    for i, sl in enumerate(find_objects(lbl), 1):
        if sl is None:
            continue
        mask = lbl[sl] == i
        idx = np.nonzero(mask)
        centroid = tuple(float(np.mean(ii)) + s.start for ii, s in zip(idx, sl))
        bbox = tuple(s.start for s in sl) + tuple(s.stop for s in sl)
        out.append(Region(label=i, slice=sl, bbox=bbox, centroid=centroid, area=int(len(idx[0]))))
    return out


def edt_prob(lbl_img, anisotropy=None):
    """Per-object normalized Euclidean distance transform (scipy): for every
    pixel of object ``l`` the distance to the nearest pixel not labeled
    ``l``, over the object's largest; background 0. Each object is
    processed in its bounding box grown by one pixel on interior sides."""
    constant_img = lbl_img.min() == lbl_img.max() and lbl_img.flat[0] > 0
    if constant_img:
        lbl_img = np.pad(lbl_img, ((1, 1),) * lbl_img.ndim, mode="constant")
        warnings.warn("EDT of constant label image is ill-defined. (Assuming background around it.)")
    prob = np.zeros(lbl_img.shape, np.float32)
    for i, sl in enumerate(find_objects(lbl_img), 1):
        if sl is None:
            continue
        interior = [(s.start > 0, s.stop < sz) for s, sz in zip(sl, lbl_img.shape)]
        grown = tuple(
            slice(s.start - int(w[0]), s.stop + int(w[1])) for s, w in zip(sl, interior)
        )
        shrink = tuple(slice(int(w[0]), -1 if w[1] else None) for w in interior)
        grown_mask = lbl_img[grown] == i
        mask = grown_mask[shrink]
        edt = distance_transform_edt(grown_mask, sampling=anisotropy)[shrink][mask]
        prob[sl][mask] = edt / (np.max(edt) + 1e-10)
    if constant_img:
        prob = prob[(slice(1, -1),) * lbl_img.ndim].copy()
    return prob


def clear_border(lbl):
    """Remove the objects that touch the image border (for shape-completion
    training)."""
    border = np.zeros(lbl.shape, bool)
    for ax in range(lbl.ndim):
        sl0 = [slice(None)] * lbl.ndim
        sl1 = [slice(None)] * lbl.ndim
        sl0[ax] = 0
        sl1[ax] = -1
        border[tuple(sl0)] = True
        border[tuple(sl1)] = True
    touching = np.unique(lbl[border & (lbl > 0)])
    out = lbl.copy()
    if len(touching):
        out[np.isin(out, touching)] = 0
    return out
