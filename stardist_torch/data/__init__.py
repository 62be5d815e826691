"""Bundled test images (a copy of stardist_tpu/data/__init__.py; reference
stardist/data/__init__.py:7-39).

The reference ships small tiff/jpg assets: the DSB2018 fluorescence nuclei
sample (Caicedo et al., Nature Methods 16.12), an H&E patch from the Cancer
Imaging Archive, and a synthetic 3D nuclei volume. These are loaded from the
first available image directory (the ``STARDIST_TORCH_DATA_DIR`` env var,
read at each call, or the package-local ``images/`` dir); when no assets
are found, deterministic procedurally-generated equivalents are returned
instead (blob-shaped nuclei with smoothed intensities and noise, plus an
H&E-like RGB rendering; the JAX package's, bit for bit) so the API works
in asset-free installs.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from scipy.ndimage import gaussian_filter


def _image_dirs():
    return [os.environ.get("STARDIST_TORCH_DATA_DIR"),
            str(Path(__file__).resolve().parent / "images")]


def _find_asset(name):
    for d in _image_dirs():
        if d and (Path(d) / name).is_file():
            return Path(d) / name
    return None


def _imread(path):
    import imageio
    arr = np.asarray(imageio.imread(path))
    return arr


def _volread(path):
    import imageio
    return np.asarray(imageio.volread(path))


def _nuclei_labels(shape, n, r_range, rng, ndim):
    lbl = np.zeros(shape, np.uint16)
    grids = np.mgrid[tuple(slice(0, s) for s in shape)]
    k = 0
    for _ in range(n):
        r = rng.uniform(*r_range)
        center = [rng.uniform(r, s - r) for s in shape]
        ar = rng.uniform(0.75, 1.3, size=ndim)
        ar /= np.prod(ar) ** (1 / ndim)
        d2 = sum(((g - c) / a) ** 2 for g, c, a in zip(grids, center, ar))
        mask = d2 < r ** 2
        if mask.any() and (lbl[mask] > 0).mean() > 0.1:
            continue
        k += 1
        lbl[mask & (lbl == 0)] = k
    return lbl


def test_image_nuclei_2d(return_mask=False):
    """DSB2018 fluorescence nuclei sample + mask (reference img2d/mask2d.tif);
    synthetic fallback when assets are unavailable."""
    img_p, mask_p = _find_asset("img2d.tif"), _find_asset("mask2d.tif")
    if img_p is not None and mask_p is not None:
        img, lbl = _imread(img_p), _imread(mask_p)
    else:
        rng = np.random.RandomState(42)
        lbl = _nuclei_labels((256, 256), 80, (7, 14), rng, 2)
        img = np.zeros(lbl.shape, np.float32)
        for l in range(1, lbl.max() + 1):
            img[lbl == l] = rng.uniform(0.5, 1.0)
        img = gaussian_filter(img, 1.5)
        img += 0.03 * rng.normal(size=img.shape)
        img = np.clip(img * 400 + 100, 0, 65535).astype(np.uint16)
    if return_mask:
        return img, lbl
    return img


def test_image_he_2d():
    """H&E stained RGB example (reference histo.jpg, Cancer Imaging Archive);
    synthetic fallback when assets are unavailable."""
    p = _find_asset("histo.jpg")
    if p is not None:
        return _imread(p)
    rng = np.random.RandomState(0)
    lbl = _nuclei_labels((256, 256), 60, (6, 12), rng, 2)
    tissue = gaussian_filter(rng.uniform(0.6, 1.0, lbl.shape), 8)
    img = np.stack([
        0.9 * tissue - 0.55 * (lbl > 0),
        0.6 * tissue - 0.45 * (lbl > 0),
        0.8 * tissue - 0.25 * (lbl > 0),
    ], axis=-1)
    img = gaussian_filter(img, (1, 1, 0))
    img += 0.02 * rng.normal(size=img.shape)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def test_image_nuclei_3d(return_mask=False):
    """Synthetic 3D nuclei volume + mask (reference img3d/mask3d.tif);
    procedural fallback when assets are unavailable."""
    img_p, mask_p = _find_asset("img3d.tif"), _find_asset("mask3d.tif")
    if img_p is not None and mask_p is not None:
        img, lbl = _volread(img_p), _volread(mask_p)
    else:
        rng = np.random.RandomState(42)
        lbl = _nuclei_labels((48, 128, 128), 60, (5, 9), rng, 3)
        img = np.zeros(lbl.shape, np.float32)
        for l in range(1, lbl.max() + 1):
            img[lbl == l] = rng.uniform(0.5, 1.0)
        img = gaussian_filter(img, 1.0)
        img += 0.03 * rng.normal(size=img.shape)
        img = np.clip(img * 400 + 100, 0, 65535).astype(np.uint16)
    if return_mask:
        return img, lbl
    return img
