"""Random patch sampling for training (a copy of stardist_tpu/sample_patches.py)."""
from __future__ import annotations

import numpy as np


def sample_patches(datas, patch_size, n_samples, valid_inds=None, verbose=False):
    """Sample coupled random patches from multiple same-shaped arrays.

    ``valid_inds`` is a tuple of per-axis center-index arrays; if None, all
    centers that fit a full patch are eligible.
    """
    if len(patch_size) != datas[0].ndim:
        raise ValueError("patch_size dimensionality mismatch")
    if not all(a.shape == datas[0].shape for a in datas):
        raise ValueError(
            "all input shapes must be the same: %s" % (" / ".join(str(a.shape) for a in datas))
        )
    if not all(0 < s <= d for s, d in zip(patch_size, datas[0].shape)):
        raise ValueError(
            "patch_size %s negative or larger than data shape %s along some dimensions"
            % (str(patch_size), str(datas[0].shape))
        )

    if valid_inds is None:
        valid_inds = tuple(
            s.ravel()
            for s in np.meshgrid(
                *tuple(np.arange(p // 2, s - p + p // 2 + 1) for s, p in zip(datas[0].shape, patch_size)),
                indexing="ij",
            )
        )

    n_valid = len(valid_inds[0])
    if n_valid == 0:
        raise ValueError("no regions to sample from!")

    idx = np.random.choice(n_valid, n_samples, replace=(n_valid < n_samples))
    rand_inds = [v[idx] for v in valid_inds]
    res = [
        np.stack([
            data[tuple(slice(r - (p // 2), r + p - (p // 2)) for r, p in zip(centers, patch_size))]
            for centers in zip(*rand_inds)
        ])
        for data in datas
    ]
    return res


def get_valid_inds(img, patch_size, patch_filter=None):
    """All center indices where a full patch fits (and patch_filter holds)."""
    if len(patch_size) != img.ndim:
        raise ValueError("patch_size dimensionality mismatch")
    if not all(0 < s <= d for s, d in zip(patch_size, img.shape)):
        raise ValueError(
            "patch_size %s negative or larger than image shape %s along some dimensions"
            % (str(patch_size), str(img.shape))
        )

    border_slices = tuple(slice(p // 2, s - p + p // 2 + 1) for p, s in zip(patch_size, img.shape))
    if patch_filter is None:
        valid_inds = tuple(
            np.arange(sl.start, sl.stop).astype(np.uint32) for sl in border_slices
        )
        valid_inds = tuple(s.ravel() for s in np.meshgrid(*valid_inds, indexing="ij"))
    else:
        patch_mask = patch_filter(img, patch_size)
        valid_inds = np.where(patch_mask[border_slices])
        valid_inds = tuple((v + sl.start).astype(np.uint32) for sl, v in zip(border_slices, valid_inds))
    return valid_inds
