"""Frozen copies: the traffic generators, the bound arithmetic and the host
sync count of ``chip_smoke.py`` at commit e8d70aa (``synthetic_nuclei``,
``synthetic_nuclei_3d``, ``PEAK_*``, ``bound``, ``conv_bound``,
``host_syncs``), unchanged but for the imports, so that the yardstick does
not move with the program. Beside them the benchmark's own generator of
anisotropic volumes, ``synthetic_nuclei_3d_aniso``.
"""
from __future__ import annotations

import os
import warnings

import numpy as np

# one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): bf16 tensor
# cores, f32 outside them, HBM3
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def synthetic_nuclei(shape, seed, r_range=(7, 14), density=6e-4):
    """The benchmark's synthetic nuclei field (bench.py::_synthetic_nuclei)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    lbl = np.zeros(shape, np.int32)
    n = int(density * np.prod(shape[:2]))
    yy, xx = np.mgrid[: 64, : 64]
    k = 0
    for _ in range(n):
        r = rng.uniform(*r_range)
        cy = rng.uniform(r, shape[0] - r)
        cx = rng.uniform(r, shape[1] - r)
        y0, x0 = int(cy) - 32, int(cx) - 32
        if y0 < 0 or x0 < 0 or y0 + 64 > shape[0] or x0 + 64 > shape[1]:
            continue
        mask = ((yy - (cy - y0)) ** 2 + (xx - (cx - x0)) ** 2) < r ** 2
        region = lbl[y0:y0 + 64, x0:x0 + 64]
        if (region[mask] > 0).any():
            continue
        k += 1
        region[mask] = k
    img = (lbl > 0).astype(np.float32)
    img = gaussian_filter(img, 1.5)
    img += 0.05 * rng.normal(size=shape).astype(np.float32)
    return img.astype(np.float32), lbl


def synthetic_nuclei_3d(shape, seed, r_range=(4, 7), density=2.5e-4):
    """The benchmark's synthetic 3D nuclei field (bench.py::_synthetic_nuclei_3d)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    lbl = np.zeros(shape, np.int32)
    n = int(density * np.prod(shape))
    k = 0
    zz, yy, xx = np.mgrid[:24, :24, :24]
    for _ in range(n):
        r = rng.uniform(*r_range)
        c = [rng.uniform(r, s - r) for s in shape]
        z0, y0, x0 = (int(v) - 12 for v in c)
        if min(z0, y0, x0) < 0 or z0 + 24 > shape[0] or y0 + 24 > shape[1] or x0 + 24 > shape[2]:
            continue
        mask = ((zz - (c[0] - z0)) ** 2 + (yy - (c[1] - y0)) ** 2
                + (xx - (c[2] - x0)) ** 2) < r ** 2
        region = lbl[z0:z0 + 24, y0:y0 + 24, x0:x0 + 24]
        if (region[mask] > 0).any():
            continue
        k += 1
        region[mask] = k
    img = (lbl > 0).astype(np.float32)
    img = gaussian_filter(img, 1.0)
    img += 0.05 * rng.normal(size=shape).astype(np.float32)
    return img.astype(np.float32), lbl


def synthetic_nuclei_3d_aniso(shape, seed, r_range=(4, 7), density=2.5e-4,
                              anisotropy=(2, 1, 1)):
    """Synthetic 3D nuclei on an anisotropic grid: ``synthetic_nuclei_3d``'s
    recipe with each nucleus an ellipsoid of semi-axes r / a_i voxels along
    axis i (a sphere of radius r where axis i is sampled a_i times more
    coarsely), drawn in a window of 2 * (ceil(r_max / a_i) + 1) voxels an
    axis, non-overlapping; the same blur and noise. (img, lbl)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    lbl = np.zeros(shape, np.int32)
    n = int(density * np.prod(shape))
    a = np.asarray(anisotropy, np.float64)
    half = [int(np.ceil(r_range[1] / ai)) + 1 for ai in a]
    axes = np.ogrid[tuple(slice(0, 2 * h) for h in half)]
    k = 0
    for _ in range(n):
        r = rng.uniform(*r_range)
        semi = r / a
        c = [rng.uniform(si, s - si) for si, s in zip(semi, shape)]
        lo = [int(v) - h for v, h in zip(c, half)]
        if min(lo) < 0 or any(o + 2 * h > s for o, h, s in zip(lo, half, shape)):
            continue
        mask = sum(((ax - (v - o)) / si) ** 2 for ax, v, o, si in zip(axes, c, lo, semi)) < 1
        region = lbl[tuple(slice(o, o + 2 * h) for o, h in zip(lo, half))]
        if (region[mask] > 0).any():
            continue
        k += 1
        region[mask] = k
    img = (lbl > 0).astype(np.float32)
    img = gaussian_filter(img, 1.0)
    img += 0.05 * rng.normal(size=shape).astype(np.float32)
    return img.astype(np.float32), lbl


def bound(ops, nbytes, peak):
    """The least time (ms) the card could take for work of ``ops``
    operations at ``peak`` per second and ``nbytes`` moved at the HBM rate:
    (ms, "operations" or "bytes", whichever sets it)."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_bound(shape, Cout):
    """Bound of one SAME 3x3 (3x3x3) conv on channels-last bf16 ``shape``
    (*sp, C) -> Cout: 2 * taps * C * Cout FLOPs per output pixel on the
    bf16 tensor cores; input, output and weights in bf16 (bias f32), each
    moved once."""
    *sp, C = shape
    npix, taps = int(np.prod(sp)), 3 ** len(sp)
    return bound(2 * taps * C * Cout * npix,
                 2 * npix * (C + Cout) + 2 * taps * C * Cout + 4 * Cout, PEAK_BF16)


def host_syncs(fn):
    """The host syncs of one call of fn(), as torch's sync debug mode flags
    them: (count, the distinct places in the Python source that made them).
    Only the flags count, not the mode's own warning that it is a
    prototype, which a process shows once."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(sites), sorted(set(sites))
