"""3D star distances: the ray march over a batch of label volumes
(counterpart of ``stardist_tpu/ops/stardist3d.py``).

For every grid-th voxel of a label volume and each ray direction ``d`` of a
``Rays`` object, march ``t = 1, 2, ...`` to the voxel at the offset
``o = round(t * d)`` (float32, half to even) until its label differs from
the start voxel's; the distance is that of the rounded endpoint,
``sqrt(oz^2 + oy^2 + ox^2)`` (no overshoot correction, unlike 2D), capped at
``max_dist``. The reference marches by shifting the padded volume once per
ray and step (``dynamic_slice``, which clamps each offset component to the
padding ``P = max_dist + 1``); here each step is one gather at precomputed
flat offsets, clamped the same way, into a volume padded with a -1
sentinel. Background voxels (label <= 0) give 0. A ray still alive after
the reference's step cap ``ceil(1.75 * P) + 2`` reports ``max_dist``.

As in 2D (:mod:`.stardist2d`), the number of steps can come from the caller:
:func:`march_steps` of the batch's largest object bounds the steps any ray
lives, so the march on the card makes no host sync; without it the march
reads back whether any ray is still alive after each gather.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import find_objects

from .stardist2d import _upload

_MAX_DIST_CAP_3D = 160   # default cap for large volumes
_BUDGET = 1 << 24        # gather indices of one march chunk
_MAX_CHUNK = 8           # steps of one gather


def _default_max_dist(shape):
    return min(int(math.ceil(math.sqrt(sum(s * s for s in shape)))) + 2, _MAX_DIST_CAP_3D)


def _dirs(rays):
    return np.asarray(rays.vertices, np.float32)


def march_steps(lbl, rays):
    """Steps after which every ray of the march over ``lbl`` (numpy labels,
    ``(D, H, W)`` or ``(B, D, H, W)``) has ended: a ray is alive at step t
    only while |round(t * d_k)| < E along its largest direction component
    d_k (at least 1 / sqrt(3) for unit rays), E the largest bounding-box
    side of a positive label."""
    lbl = np.asarray(lbl)
    extent = 0
    for y in lbl.reshape((-1,) + lbl.shape[-3:]):
        for sl in find_objects(np.maximum(y, 0).astype(np.int32, copy=False)):
            if sl is not None:
                extent = max(extent, *(s.stop - s.start for s in sl))
    dmin = float(np.abs(_dirs(rays)).max(axis=1).min())
    return int(math.ceil((extent + 0.5) / dmin * (1 + 1e-6))) + 2


def _tables(dirs, n_steps, P):
    """Per step t = 1..n_steps and ray: the offsets (n_steps, R, 3) int64 as
    the reference reads them (each component clamped to [-P, P]) and the
    distances (n_steps, R) float32 of the unclamped rounded endpoints."""
    t = np.arange(1, n_steps + 1, dtype=np.float32)[:, None, None]
    o = np.round(t * dirs[None])                                      # float32
    d = np.sqrt(o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1] + o[..., 2] * o[..., 2])
    return np.clip(o.astype(np.int64), -P, P), d.astype(np.float32)


def star_dist3d(lbl, rays, grid=(1, 1, 1), max_dist=None, n_steps=None):
    """Star distances of integer labels ``lbl`` (B, D, H, W) or (D, H, W),
    on their device, along the unit vectors of ``rays`` -> float32 (B, Do,
    Ho, Wo, R) or (Do, Ho, Wo, R), Do = (D - 1) // gz + 1. ``max_dist`` caps
    the distances (default: the volume diagonal, at most 160 voxels);
    ``n_steps`` is a bound on the steps any ray lives (:func:`march_steps`),
    else the march checks for live rays after each gather."""
    single = lbl.dim() == 3
    if single:
        lbl = lbl[None]
    B, D, H, W = lbl.shape
    gz, gy, gx = (int(g) for g in grid)
    dev = lbl.device
    dirs = _dirs(rays)
    R = len(dirs)
    if max_dist is None:
        max_dist = _default_max_dist((D, H, W))
    P = int(max_dist) + 1
    max_steps = int(math.ceil(1.75 * P)) + 2          # the reference's step cap
    T = max_steps if n_steps is None else max(1, min(int(n_steps), max_steps))
    off3, dtab = _tables(dirs, T, P)
    pad = max(1, int(np.abs(off3).max()))
    lbl = lbl.to(torch.int32)
    flat = F.pad(lbl, (pad,) * 6, value=-1).reshape(-1)
    Dp, Hp, Wp = D + 2 * pad, H + 2 * pad, W + 2 * pad
    off = (off3[..., 0] * Hp + off3[..., 1]) * Wp + off3[..., 2]
    off = _upload(off.astype(np.int64), dev)[:, None, :]               # (T, 1, R)
    vals = lbl[:, ::gz, ::gy, ::gx]
    Do, Ho, Wo = vals.shape[1:]
    vals = vals.reshape(-1, 1)
    zs = torch.arange(Do, device=dev, dtype=torch.int64) * gz + pad
    ys = torch.arange(Ho, device=dev, dtype=torch.int64) * gy + pad
    xs = torch.arange(Wo, device=dev, dtype=torch.int64) * gx + pad
    start = (torch.arange(B, device=dev, dtype=torch.int64)[:, None, None, None] * (Dp * Hp * Wp)
             + (zs[:, None, None] * Hp + ys[:, None]) * Wp + xs).reshape(-1, 1)   # (N, 1)
    N = start.shape[0]
    fg = vals > 0
    alive = fg.expand(N, R).clone()
    count = torch.zeros(N, R, dtype=torch.int64, device=dev)           # steps survived
    span = max(1, min(_MAX_CHUNK, _BUDGET // max(1, N * R)))
    block = max(1, _BUDGET // (R * span))                              # start voxels per gather
    for t0 in range(0, T, span):
        for n0 in range(0, N, block):
            sl = slice(n0, n0 + block)
            same = flat[start[sl] + off[t0:t0 + span]] == vals[sl]     # (s, n, R)
            a, c = alive[sl], count[sl]
            for step in same:
                c += a.logical_and_(step)
        if n_steps is None and not bool(alive.any()):
            break
    # a ray that ended at step t = count + 1 has the distance of that step's
    # endpoint; one still alive at the step cap reports the cap
    cap = float(max_dist)
    dtab = _upload(dtab, dev)
    ended = dtab.view(-1)[(count.clamp_max(T - 1) * R
                           + torch.arange(R, device=dev))]
    dist = torch.where(fg & ~alive, ended, torch.zeros((), device=dev))
    dist = torch.where(alive, torch.full((), cap, device=dev), dist).clamp_max(cap)
    dist = dist.reshape(B, Do, Ho, Wo, R)
    return dist[0] if single else dist


def star_dist3d_numpy(lbl, rays, grid=(1, 1, 1)):
    """Pure-NumPy oracle with the same semantics (a copy of the reference's)."""
    lbl = np.asarray(lbl)
    D, H, W = lbl.shape
    gz, gy, gx = grid
    vals = lbl[::gz, ::gy, ::gx]
    Do, Ho, Wo = vals.shape
    dirs = np.asarray(rays.vertices, np.float32)
    R = len(dirs)
    dst = np.zeros((Do, Ho, Wo, R), np.float32)
    for i in range(Do):
        for j in range(Ho):
            for k in range(Wo):
                v = vals[i, j, k]
                if v == 0:
                    continue
                for n in range(R):
                    t = 0
                    while True:
                        t += 1
                        tf = np.float32(t)
                        oz, oy, ox = np.round(tf * dirs[n])
                        ii = i * gz + int(oz)
                        jj = j * gy + int(oy)
                        kk = k * gx + int(ox)
                        if (ii < 0 or ii >= D or jj < 0 or jj >= H
                                or kk < 0 or kk >= W or lbl[ii, jj, kk] != v):
                            dst[i, j, k, n] = np.sqrt(oz * oz + oy * oy + ox * ox)
                            break
    return dst
