"""Star-convex polygon geometry (counterpart of ``stardist_tpu/ops/polygon.py``).

A star polygon is a centre (row, col) and R radial distances along the rays
phi_k = 2*pi*k/R; vertex k is centre + d_k * (sin phi_k, cos phi_k).

Floating-point contract with the reference (which XLA compiles): the ray
directions are the f32 rays' sines and cosines rounded once from f64 (what
XLA's f32 sin/cos give for R <= 32), and a vertex is the single rounding of
``centre + d * dir`` (XLA contracts it into one fused multiply-add), which
float64 arithmetic reproduces here on any device.
"""
from __future__ import annotations

import numpy as np
import torch


def ray_dirs(R, device=None):
    """(R, 2) f32 unit vectors (sin phi_k, cos phi_k) of the f32 ray angles."""
    phis = (np.arange(R, dtype=np.float32) * np.float32(2 * np.pi / R)).astype(np.float64)
    dirs = np.stack([np.sin(phis), np.cos(phis)], axis=-1).astype(np.float32)
    return torch.from_numpy(dirs).to(device)


def polygon_vertices(dist, points):
    """dist (..., R), points (..., 2) -> (..., R, 2) f32 vertices."""
    dirs = ray_dirs(dist.shape[-1], dist.device).double()
    v = points.double()[..., None, :] + dist.double()[..., None] * dirs
    return v.float()


def polygon_areas(dist):
    """Exact area of equiangular star polygons: 0.5*sin(2pi/R)*sum_k d_k*d_{k+1}."""
    R = dist.shape[-1]
    s = float(np.float32(np.sin(np.float32(2 * np.pi / R))))
    return 0.5 * s * torch.sum(dist * torch.roll(dist, -1, dims=-1), dim=-1)


def polygon_bboxes(dist, points):
    """Axis-aligned bounding boxes (lo, hi), each (..., 2)."""
    v = polygon_vertices(dist, points)
    return v.amin(dim=-2), v.amax(dim=-2)


def points_in_polygons(dist, points, query):
    """Point-in-star-polygon test with the atan2 wedge rule of the reference.

    dist (..., R), points (..., 2), query (..., S, 2) -> (..., S) bool."""
    R = dist.shape[-1]
    dphi = float(np.float32(2 * np.pi / R))
    u = query - points[..., None, :]
    ur = u[..., 0]
    uc = u[..., 1]
    theta = torch.remainder(torch.atan2(ur, uc), float(np.float32(2 * np.pi)))
    k = torch.clamp(torch.floor(theta / dphi).to(torch.int64), 0, R - 1)

    angles = np.arange(R) * (2 * np.pi / R)
    trig = torch.from_numpy(np.stack([
        np.sin(angles), np.cos(angles),
        np.sin(angles + 2 * np.pi / R), np.cos(angles + 2 * np.pi / R)
    ]).astype(np.float32)).to(dist.device)
    d0 = dist
    d1 = torch.roll(dist, -1, dims=-1)
    V = torch.stack([d0 * trig[0], d0 * trig[1], d1 * trig[2], d1 * trig[3]], dim=-1)
    idx = k[..., None].expand(k.shape + (4,))
    picked = torch.gather(V.expand(k.shape[:-1] + V.shape[-2:]), -2, idx)
    v0r, v0c = picked[..., 0], picked[..., 1]
    er = picked[..., 2] - v0r
    ec = picked[..., 3] - v0c
    cross_p = er * (uc - v0c) - ec * (ur - v0r)
    cross_c = ec * v0r - er * v0c
    return cross_p * cross_c >= 0
