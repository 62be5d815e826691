"""Star-convex polygons, plain PyTorch in float64.

A polygon is a centre (row, col) and R distances along the equiangular
rays phi_k = 2 pi k / R, direction (sin phi_k, cos phi_k). A point is
inside when it lies on the centre's side of the edge between the two rays
around its own angle (upstream StarDist's polygons). The NMS overlap of two
polygons is their common area over the smaller one's; the common area is
counted on the S x S cell midpoints of their boxes' intersection (upstream
StarDist's ``samples``).
"""
from __future__ import annotations

import math

import torch

SAMPLES = 16


def _trig(R, device):
    phi = torch.arange(R, dtype=torch.float64, device=device) * (2 * math.pi / R)
    return torch.sin(phi), torch.cos(phi)


def vertices(dist, points):
    """dist (N, R), points (N, 2) -> (N, R, 2) float64."""
    s, c = _trig(dist.shape[-1], dist.device)
    d = dist.double()
    return points.double()[:, None, :] + torch.stack([d * s, d * c], dim=-1)


def boxes(dist, points):
    v = vertices(dist, points)
    return v.amin(dim=1), v.amax(dim=1)


def areas(dist):
    d = dist.double()
    return 0.5 * math.sin(2 * math.pi / d.shape[-1]) * torch.sum(d * torch.roll(d, -1, -1), -1)


def inside(dist, points, q, rnd=None):
    """dist (P, R), points (P, 2), q (P, M, 2) -> (P, M) bool; ``rnd``, where
    given, rounds the distances and the offsets from the centres first."""
    R = dist.shape[-1]
    d = dist.double()
    u = q.double() - points.double()[:, None, :]
    if rnd is not None:
        d, u = rnd(d).double(), rnd(u).double()
    theta = torch.remainder(torch.atan2(u[..., 0], u[..., 1]), 2 * math.pi)
    k = torch.clamp(torch.floor(theta / (2 * math.pi / R)).long(), 0, R - 1)
    k1 = (k + 1) % R
    s, c = _trig(R, dist.device)
    d0, d1 = torch.gather(d, 1, k), torch.gather(d, 1, k1)
    v0r, v0c, v1r, v1c = d0 * s[k], d0 * c[k], d1 * s[k1], d1 * c[k1]
    er, ec = v1r - v0r, v1c - v0c
    side_q = er * (u[..., 1] - v0c) - ec * (u[..., 0] - v0r)
    side_o = ec * v0r - er * v0c
    return side_q * side_o >= 0


class Polygons:
    """The candidates of one image, sorted by descending score."""

    block = 256     # candidates a step of the greedy: the exact test is cheap, few steps

    def __init__(self, dist, points, thresh, samples=SAMPLES):
        self.thresh = float(thresh)
        self.dist = dist.double()
        self.points = points.double()
        self.lo, self.hi = boxes(self.dist, self.points)
        self.area = areas(self.dist)
        a = (torch.arange(samples, dtype=torch.float64, device=dist.device) + 0.5) / samples
        self.grid = torch.stack(torch.broadcast_tensors(a[:, None], a[None, :]), -1).reshape(-1, 2)

    def bounds(self, i, j):
        """No bounds: every pair is undecided."""
        return (torch.zeros(i.numel(), dtype=torch.bool, device=i.device),
                torch.ones(i.numel(), dtype=torch.bool, device=i.device))

    def exact(self, i, j, step=4096):
        thresh = self.thresh
        out = []
        for c in range(0, i.numel(), step):
            ii, jj = i[c:c + step], j[c:c + step]
            plo = torch.maximum(self.lo[ii], self.lo[jj])
            ext = torch.clamp_min(torch.minimum(self.hi[ii], self.hi[jj]) - plo, 0)
            q = plo[:, None, :] + self.grid[None] * ext[:, None, :]
            both = (inside(self.dist[ii], self.points[ii], q)
                    & inside(self.dist[jj], self.points[jj], q))
            common = both.double().mean(dim=1) * ext[:, 0] * ext[:, 1]
            out.append(common > thresh * torch.minimum(self.area[ii], self.area[jj]))
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool, device=i.device)


def raster(dist, points, prob, shape, chunk=256, rnd=None):
    """Label image (H, W) int64 on the device of the polygons: polygon n
    (in the given order) is drawn as n + 1; where polygons overlap, the
    higher prob wins, and of equal probs the later one. ``rnd`` as in
    :func:`inside`."""
    H, W = shape
    dev = dist.device
    img = torch.zeros(H * W, dtype=torch.int64, device=dev)
    N = dist.shape[0]
    if N == 0:
        return img.view(H, W)
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[torch.sort(prob, stable=True).indices] = torch.arange(1, N + 1, device=dev)
    key = (rank << 32) | torch.arange(1, N + 1, device=dev)
    win = 2 * int(math.ceil(float(dist.max()))) + 3
    ar = torch.arange(win, device=dev) - win // 2
    centre = torch.round(points.double()).long()
    for c in range(0, N, chunk):
        sl = slice(c, c + chunk)
        rr = centre[sl, 0:1] + ar                                  # (n, win)
        cc = centre[sl, 1:2] + ar
        q = torch.stack(torch.broadcast_tensors(rr[:, :, None], cc[:, None, :]), -1)
        q = q.reshape(rr.shape[0], -1, 2)
        ok = inside(dist[sl], points[sl], q, rnd)
        ok &= (q[..., 0] >= 0) & (q[..., 0] < H) & (q[..., 1] >= 0) & (q[..., 1] < W)
        flat = q[..., 0] * W + q[..., 1]
        img.scatter_reduce_(0, flat[ok], key[sl, None].expand_as(flat)[ok], reduce="amax")
    return (img & 0xFFFFFFFF).view(H, W)
