"""2D star distances: the ray march over a batch of label images
(counterpart of ``stardist_tpu/ops/stardist2d.py``).

For every grid-th pixel of a label image and each of ``n_rays`` equiangular
directions, march ``t = 1, 2, ...`` to the pixel at the offset
``(round(t * dr), round(t * dc))`` (half to even) until its label differs
from the start pixel's; the distance is ``t - 1 + 0.5 / max(|dr|, |dc|)``,
capped at ``max_dist``. The reference marches by shifting the whole image
once per ray and step (a TPU has no gather); here each step is one gather
at precomputed flat offsets into an image padded with a -1 sentinel, and
several steps go into one gather. Background pixels (label <= 0) give 0.

The number of steps can come from the caller: no ray lives longer than
:func:`march_steps` of the largest object's bounding box, which the
training data's host thread computes for each batch, so the march on the
card needs no host sync. Without it the march reads back whether any ray is
still alive after each gather. Extra steps change nothing: a ray that has
ended stays ended.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import find_objects

_MAX_DIST_CAP = 800      # default cap for very large images
_BUDGET = 1 << 24        # gather indices of one march chunk
_MAX_CHUNK = 8           # steps of one gather


def _ray_dirs(n_rays):
    """Unit direction (row, col) per ray, float32: row ~ sin(phi), col ~ cos(phi)."""
    phis = (2 * np.pi / n_rays) * np.arange(n_rays)
    return np.stack([np.sin(phis), np.cos(phis)], axis=-1).astype(np.float32)


def _default_max_dist(shape):
    return min(int(math.ceil(math.hypot(*shape))) + 2, _MAX_DIST_CAP)


def march_steps(lbl):
    """Steps after which every ray of the march over ``lbl`` (numpy labels,
    ``(H, W)`` or ``(B, H, W)``) has ended: a ray is alive at step t only
    while |round(t * d)| < E along its larger direction component (at least
    cos(pi / 4)), E the largest bounding-box side of a positive label."""
    lbl = np.asarray(lbl)
    extent = 0
    for y in lbl.reshape((-1,) + lbl.shape[-2:]):
        for sl in find_objects(np.maximum(y, 0).astype(np.int32, copy=False)):
            if sl is not None:
                extent = max(extent, sl[0].stop - sl[0].start, sl[1].stop - sl[1].start)
    return int(math.ceil(1.4143 * extent)) + 2


def _upload(a, dev):
    """A small numpy table on ``dev``, copied without a host sync."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _offsets(n_rays, n_steps, row_stride):
    """Flat offsets (n_rays, n_steps) int32 of steps 1..n_steps in an image
    of ``row_stride`` columns; the rounding as the reference's (float32
    t * d, half to even)."""
    t = np.arange(1, n_steps + 1, dtype=np.float32)[None, :]
    dirs = _ray_dirs(n_rays)
    orow = np.round(t * dirs[:, :1]).astype(np.int64)
    ocol = np.round(t * dirs[:, 1:]).astype(np.int64)
    return (orow * row_stride + ocol).astype(np.int32)


def star_dist2d(lbl, n_rays=32, grid=(1, 1), max_dist=None, n_steps=None):
    """Star distances of integer labels ``lbl`` (B, H, W) or (H, W), on
    their device -> float32 (B, Ho, Wo, R) or (Ho, Wo, R), Ho = (H - 1) //
    gy + 1. ``max_dist`` caps the distances (default: the image diagonal,
    at most 800 px); ``n_steps`` is a bound on the steps any ray lives
    (:func:`march_steps`), else the march checks for live rays after each
    gather."""
    single = lbl.dim() == 2
    if single:
        lbl = lbl[None]
    B, H, W = lbl.shape
    gy, gx = (int(g) for g in grid)
    dev = lbl.device
    if max_dist is None:
        max_dist = _default_max_dist((H, W))
    max_steps = int(math.ceil(1.45 * (max_dist + 1))) + 2   # the reference's step cap
    T = max_steps if n_steps is None else max(1, min(int(n_steps), max_steps))
    pad = T + 1          # an offset component grows by at most 1 per step
    lbl = lbl.to(torch.int32)
    flat = F.pad(lbl, (pad, pad, pad, pad), value=-1).reshape(-1)
    Hp, Wp = H + 2 * pad, W + 2 * pad
    vals = lbl[:, ::gy, ::gx]
    Ho, Wo = vals.shape[1:]
    vals = vals.reshape(-1, 1)
    rows = torch.arange(Ho, device=dev, dtype=torch.int32) * gy + pad
    cols = torch.arange(Wo, device=dev, dtype=torch.int32) * gx + pad
    start = (torch.arange(B, device=dev, dtype=torch.int32)[:, None, None] * (Hp * Wp)
             + rows[:, None] * Wp + cols).reshape(-1, 1)             # (N, 1)
    N = start.shape[0]
    off = _upload(_offsets(n_rays, T, Wp).T.copy(), dev)[:, None, :]  # (T, 1, R)

    dirs = _ray_dirs(n_rays)
    t_corr = _upload(0.5 / np.maximum(np.abs(dirs[:, 0]), np.abs(dirs[:, 1])), dev)
    fg = vals > 0
    alive = fg.expand(N, n_rays).clone()
    count = torch.zeros(N, n_rays, dtype=torch.int32, device=dev)     # steps survived
    span = max(1, min(_MAX_CHUNK, _BUDGET // max(1, N * n_rays)))
    block = max(1, _BUDGET // (n_rays * span))                         # start pixels per gather
    for t0 in range(0, T, span):
        for n0 in range(0, N, block):
            sl = slice(n0, n0 + block)
            same = flat[start[sl] + off[t0:t0 + span]] == vals[sl]     # (s, n, R)
            a, c = alive[sl], count[sl]
            for step in same:
                c += a.logical_and_(step)
        if n_steps is None and not bool(alive.any()):
            break
    # a ray that ended at step t = count + 1: t - 1 + t_corr; one still alive
    # at the step cap reports the cap
    cap = float(max_dist)
    dist = torch.where(fg & ~alive, count.float() + t_corr, torch.zeros((), device=dev))
    dist = torch.where(alive, torch.full((), cap, device=dev), dist).clamp_max(cap)
    dist = dist.reshape(B, Ho, Wo, n_rays)
    return dist[0] if single else dist


def star_dist2d_numpy(lbl, n_rays=32, grid=(1, 1)):
    """Pure-NumPy oracle with the same semantics (a copy of the reference's)."""
    lbl = np.asarray(lbl)
    H, W = lbl.shape
    gy, gx = grid
    vals = lbl[::gy, ::gx]
    Ho, Wo = vals.shape
    dirs = _ray_dirs(n_rays)
    t_corr = 0.5 / np.maximum(np.abs(dirs[:, 0]), np.abs(dirs[:, 1]))
    dst = np.zeros((Ho, Wo, n_rays), np.float32)
    for i in range(Ho):
        for j in range(Wo):
            v = vals[i, j]
            if v == 0:
                continue
            for k in range(n_rays):
                t = 0
                while True:
                    t += 1
                    tf = np.float32(t)
                    ii = i * gy + int(np.round(tf * dirs[k, 0]))
                    jj = j * gx + int(np.round(tf * dirs[k, 1]))
                    if ii < 0 or ii >= H or jj < 0 or jj >= W or lbl[ii, jj] != v:
                        dst[i, j, k] = tf - 1.0 + t_corr[k]
                        break
    return dst
