"""Star-convex polyhedra, plain PyTorch in float64.

A polyhedron is a centre (z, y, x), R distances along unit rays and the
rays' triangulation: the golden-spiral rays of upstream StarDist
(stardist/rays3d.py, ``Rays_GoldenSpiral``) with faces from their convex
hull, worked out here from the ray count and the anisotropy alone. It is
the union of the tetrahedra (centre, A, B, C) over the faces. A point is
inside when its barycentric coordinates in some face's tetrahedron are
all >= -1e-7 and sum to <= 1 + 1e-7. The NMS overlap of two polyhedra is
their common volume over the smaller one's: the common points counted on
an integer lattice in their boxes' intersection, at most S points per
axis with the stride max(ceil(n / S), 1), times the stride's volume
(upstream StarDist's 3D NMS). Sphere bounds decide the pairs far from
the threshold.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.spatial import ConvexHull

SAMPLES = 12
EPS = 1e-7


def golden_spiral(n, anisotropy=None):
    """Unit ray directions (n, 3) (z, y, x) and faces (F, 3). With an
    ``anisotropy`` (z, y, x), upstream's ``Rays_GoldenSpiral(n,
    anisotropy)``: the spiral divided by it, the faces of that warped set's
    hull, then each direction normalized."""
    g = (3.0 - np.sqrt(5.0)) * np.pi
    phi = g * np.arange(n)
    z = np.linspace(-1, 1, n)
    rho = np.sqrt(1.0 - z ** 2)
    verts = np.stack([z, rho * np.sin(phi), rho * np.cos(phi)]).T
    if anisotropy is not None:
        verts = verts / np.asarray(anisotropy, np.float64)
    faces = ConvexHull(verts).simplices
    return verts / np.linalg.norm(verts, axis=-1, keepdims=True), faces


def _tri(dist, dirs, faces):
    return (dist.double()[..., None] * dirs)[:, faces]             # (N, F, 3, 3): rows A, B, C


def volumes(dist, dirs, faces):
    return torch.abs(torch.linalg.det(_tri(dist, dirs, faces))).sum(-1) / 6


def inverses(dist, dirs, faces):
    """Per face the inverse of [A B C] (vertices as columns), and whether
    the face is not degenerate."""
    m = _tri(dist, dirs, faces).transpose(-1, -2)
    det = torch.linalg.det(m)
    ok = torch.abs(det) > 1e-12
    m = torch.where(ok[..., None, None], m, torch.eye(3, dtype=m.dtype, device=m.device))
    return torch.linalg.inv(m), ok


def inside(inv, ok, u, face_block=16):
    """inv (P, F, 3, 3), ok (P, F), offsets from the centres u (P, M, 3) ->
    (P, M) bool."""
    res = torch.zeros(u.shape[:-1], dtype=torch.bool, device=u.device)
    for f in range(0, inv.shape[1], face_block):
        b = torch.einsum("pfij,pmj->pmfi", inv[:, f:f + face_block], u)
        hit = (b >= -EPS).all(-1) & (b.sum(-1) <= 1 + EPS) & ok[:, None, f:f + face_block]
        res |= hit.any(-1)
    return res


def inside_indexed(inv, ok, idx, u, face_block=8):
    """Offsets u (K, 3), each tested against polyhedron ``idx[k]`` of inv
    (N, F, 3, 3), ok (N, F) -> (K,) bool."""
    res = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
    for f in range(0, inv.shape[1], face_block):
        b = torch.einsum("kfij,kj->kfi", inv[idx, f:f + face_block], u)
        hit = (b >= -EPS).all(-1) & (b.sum(-1) <= 1 + EPS) & ok[idx, f:f + face_block]
        res |= hit.any(-1)
    return res


def _lens(r1, r2, d):
    """Volume of the intersection of two balls of radii r1, r2 at distance d."""
    small = (4 / 3) * math.pi * torch.minimum(r1, r2) ** 3
    ds = torch.clamp_min(d, 1e-12)
    part = (math.pi * torch.clamp_min(r1 + r2 - d, 0) ** 2
            * (d * d + 2 * d * (r1 + r2) - 3 * (r1 - r2) ** 2) / (12 * ds))
    return torch.where(d >= r1 + r2, torch.zeros_like(d),
                       torch.where(d <= torch.abs(r1 - r2), small, part))


class Polyhedra:
    """The candidates of one volume, sorted by descending score."""

    block = 16      # candidates a step of the greedy: the exact test costs, few pairs

    def __init__(self, dist, points, dirs, faces, thresh, samples=SAMPLES):
        self.thresh = float(thresh)
        self.dist = dist.double()
        self.points = points.double()
        self.dirs = torch.as_tensor(dirs, dtype=torch.float64, device=dist.device)
        self.faces = torch.as_tensor(faces, dtype=torch.int64, device=dist.device)
        v = self.points[:, None, :] + self.dist[..., None] * self.dirs
        self.lo, self.hi = v.amin(1), v.amax(1)
        self.vol = volumes(self.dist, self.dirs, self.faces)
        self.inv, self.ok = inverses(self.dist, self.dirs, self.faces)
        tri = _tri(self.dist, self.dirs, self.faces)
        n = torch.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :], dim=-1)
        plane = torch.abs((n * tri[..., 0, :]).sum(-1)) / torch.clamp_min(n.norm(dim=-1), 1e-12)
        self.r_in = plane.amin(-1)
        self.r_out = self.dist.amax(-1)
        self.samples = samples

    def _lattice(self, i, j):
        S = self.samples
        plo = torch.ceil(torch.maximum(self.lo[i], self.lo[j]))
        phi = torch.floor(torch.minimum(self.hi[i], self.hi[j]))
        stride = torch.clamp_min(torch.ceil(torch.clamp_min(phi - plo + 1, 0) / S), 1)
        ar = torch.arange(S, dtype=torch.float64, device=plo.device)
        pos = plo[:, :, None] + stride[:, :, None] * ar                 # (P, 3, S)
        use = pos <= phi[:, :, None]
        q = torch.stack(torch.broadcast_tensors(
            pos[:, 0, :, None, None], pos[:, 1, None, :, None], pos[:, 2, None, None, :]), -1)
        q = q.reshape(len(i), -1, 3)
        m = (use[:, 0, :, None, None] & use[:, 1, None, :, None]
             & use[:, 2, None, None, :]).reshape(len(i), -1)
        pair, k = torch.nonzero(m, as_tuple=True)
        q = q[pair, k]
        sel = inside_indexed(self.inv, self.ok, i[pair], q - self.points[i[pair]])
        pair, q = pair[sel], q[sel]
        sel = inside_indexed(self.inv, self.ok, j[pair], q - self.points[j[pair]])
        count = torch.bincount(pair[sel], minlength=len(i)).double()
        return count * stride.prod(-1)

    def bounds(self, i, j):
        """(suppresses, undecided) from the inscribed and the outer balls."""
        denom = torch.minimum(self.vol[i], self.vol[j]) + 1e-10
        d = (self.points[i] - self.points[j]).norm(dim=-1)
        ext = torch.clamp_min(torch.minimum(self.hi[i], self.hi[j])
                              - torch.maximum(self.lo[i], self.lo[j]), 0)
        ub = torch.minimum(_lens(self.r_out[i], self.r_out[j], d), ext.prod(-1)) / denom
        sup = _lens(self.r_in[i], self.r_in[j], d) / denom > self.thresh
        return sup, ~sup & (ub > self.thresh)

    def exact(self, i, j, step=256):
        out = [self._lattice(i[c:c + step], j[c:c + step])
               / (torch.minimum(self.vol[i[c:c + step]], self.vol[j[c:c + step]]) + 1e-10)
               > self.thresh for c in range(0, i.numel(), step)]
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool, device=i.device)


def raster(dist, points, prob, shape, dirs, faces, chunk=8, rnd=None):
    """Label volume (Z, Y, X) int64: polyhedron n (in the given order) is
    drawn as n + 1; where polyhedra overlap, the higher prob wins, and of
    equal probs the later one. ``rnd``, where given, rounds the distances
    and the offsets from the centres first."""
    Z, Y, X = shape
    dev = dist.device
    img = torch.zeros(Z * Y * X, dtype=torch.int64, device=dev)
    N = dist.shape[0]
    if N == 0:
        return img.view(Z, Y, X)
    dirs = torch.as_tensor(dirs, dtype=torch.float64, device=dev)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    inv, ok = inverses(dist if rnd is None else rnd(dist.double()), dirs, faces)
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[torch.sort(prob, stable=True).indices] = torch.arange(1, N + 1, device=dev)
    key = (rank << 32) | torch.arange(1, N + 1, device=dev)
    win = 2 * int(math.ceil(float(dist.max()))) + 3
    ar = torch.arange(win, device=dev) - win // 2
    off = torch.stack(torch.broadcast_tensors(ar[:, None, None], ar[None, :, None],
                                              ar[None, None, :]), -1).reshape(-1, 3)
    centre = torch.round(points.double()).long()
    for c in range(0, N, chunk):
        sl = slice(c, c + chunk)
        q = centre[sl, None, :] + off                                # (n, win^3, 3)
        u = q.double() - points[sl, None].double()
        hit = inside(inv[sl], ok[sl], u if rnd is None else rnd(u).double())
        hit &= ((q >= 0) & (q < torch.tensor(shape, device=dev))).all(-1)
        flat = (q[..., 0] * Y + q[..., 1]) * X + q[..., 2]
        img.scatter_reduce_(0, flat[hit], key[sl, None].expand_as(flat)[hit], reduce="amax")
    return (img & 0xFFFFFFFF).view(Z, Y, X)
