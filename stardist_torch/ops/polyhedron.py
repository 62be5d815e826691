"""Star-convex polyhedron geometry (counterpart of
``stardist_tpu/ops/polyhedron.py``).

A star polyhedron is a centre (z, y, x), R radial distances and a ray set's
unit ``vertices`` (R, 3) with its triangulation ``faces`` (F, 3). It is the
union of the tetrahedra (centre, A_f, B_f, C_f) over the faces f; a point is
inside iff its barycentric coordinates in some face tetrahedron are all
>= -eps and sum to <= 1 + eps (the reference's ``inside_polyhedron``).

Floating-point contract with the reference, which XLA:CPU compiles with
fused multiply-adds: a vertex ``centre + d * dir``, the 3x3 determinant
(jnp.linalg.det's cofactor formula) and the cross products are evaluated
here as the same chains of FMAs, each emulated exactly in float64 (a product
of two f32 values is exact in f64), on any device. The barycentric dot
products of the inside test, by far its largest part, are plain f32
products and sums (the reference fuses them into FMAs): the two can decide
differently only for a point within an f32 rounding of a face. They are
elementwise, never a matmul, so no device runs them in TF32 (the reference
asks for ``Precision.HIGHEST`` for the same reason).
"""
from __future__ import annotations

import numpy as np
import torch


def ray_tensors(rays, device=None):
    """(ray_dirs (R, 3) f32, faces (F, 3) int64) of a ``Rays`` object."""
    dirs = torch.from_numpy(np.asarray(rays.vertices, np.float32)).to(device)
    faces = torch.from_numpy(np.asarray(rays.faces, np.int64)).to(device)
    return dirs, faces


def _fma(a, b, c):
    """a * b + c rounded once to f32 (a fused multiply-add), via float64."""
    return (a.double() * b.double() + c.double()).float()


def _cross(b, c):
    """Cross product over the last axis, each component as XLA:CPU forms it:
    fma(b_i, c_j, -(b_j * c_i))."""
    return torch.stack([_fma(b[..., i], c[..., j], -(b[..., j] * c[..., i]))
                        for i, j in ((1, 2), (2, 0), (0, 1))], dim=-1)


def _det3(m):
    """Determinant of (..., 3, 3) by jnp.linalg.det's 3x3 formula, with the
    six products a*b*c as round(a*b)*c folded into the FMA chain XLA:CPU
    emits for it."""
    e = lambda i, j: m[..., i, j]                                   # noqa: E731
    ab = [e(0, 0) * e(1, 1), e(0, 1) * e(1, 2), e(0, 2) * e(1, 0),
          e(0, 2) * e(1, 1), e(0, 0) * e(1, 2), e(0, 1) * e(1, 0)]
    c = [e(2, 2), e(2, 0), e(2, 1), e(2, 0), e(2, 1), e(2, 2)]
    acc = _fma(ab[0], c[0], ab[1] * c[1])
    for k, sign in ((2, 1.0), (3, -1.0), (4, -1.0), (5, -1.0)):
        acc = _fma(sign * ab[k], c[k], acc)
    return acc


def polyhedron_vertices(dist, points, ray_dirs):
    """dist (..., R), points (..., 3), ray_dirs (R, 3) -> (..., R, 3) f32."""
    v = points.double()[..., None, :] + dist.double()[..., None] * ray_dirs.double()
    return v.float()


def _face_triangles(dist, ray_dirs, faces):
    """(..., F, 3 vertices, 3 coords) face triangles relative to the centre."""
    v = dist[..., None] * ray_dirs                     # (..., R, 3)
    return v[..., faces, :]


def polyhedron_volumes(dist, ray_dirs, faces):
    """Signed-tetrahedron-sum volume (reference rays3d.py:76-107)."""
    det = _det3(_face_triangles(dist, ray_dirs, faces))
    return -1.0 / 6.0 * torch.sum(det, dim=-1)


def polyhedron_face_inverses(dist, ray_dirs, faces, eps=1e-12):
    """Per-face inverse matrices for the barycentric point test.

    Returns inv (..., F, 3, 3), whose rows are those of inverse(M) with
    M = [A B C] (the face's vertices as columns), and valid (..., F) bool
    (non-degenerate faces)."""
    tri = _face_triangles(dist, ray_dirs, faces)
    det = _det3(tri.transpose(-1, -2))
    valid = torch.abs(det) > eps
    safe_det = torch.where(valid, det, torch.ones_like(det))
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    inv = torch.stack([_cross(b, c), _cross(c, a), _cross(a, b)], dim=-2)
    return inv / safe_det[..., None, None], valid


def points_in_polyhedra(inv, valid, points, query, eps=1e-7, face_block=8):
    """Point-in-star-polyhedron test with precomputed face inverses.

    inv (..., F, 3, 3), valid (..., F), points (..., 3) centres, query
    (..., S, 3) -> (..., S) bool. Streams over blocks of faces so that the
    largest temporary is (..., S, face_block)."""
    u = query - points[..., None, :]                                 # (..., S, 3)
    return _inside(lambda f0, f1: (inv[..., None, f0:f1, :, :], valid[..., None, f0:f1]),
                   inv.shape[-3], u, eps, face_block)


def points_in_indexed_polyhedra(inv, valid, points, idx, query, eps=1e-7, face_block=8):
    """:func:`points_in_polyhedra` for a flat list of queries: query k
    (K, 3) is tested against polyhedron ``idx[k]`` of inv (N, F, 3, 3),
    valid (N, F), points (N, 3); the face inverses are gathered one face
    block at a time. Returns (K,) bool."""
    u = query - points[idx]
    return _inside(lambda f0, f1: (inv[idx, f0:f1], valid[idx, f0:f1]),
                   inv.shape[-3], u, eps, face_block)


def _inside(face_block_of, F, u, eps, face_block):
    """Any face f of a block from ``face_block_of(f0, f1)`` -> (inv
    (..., fb, 3, 3), valid (..., fb)) has barycentric coordinates of u
    (..., 3) all >= -eps and summing to <= 1 + eps."""
    u0, u1, u2 = (u[..., None, k] for k in range(3))                 # (..., 1)
    inside = torch.zeros(u.shape[:-1], dtype=torch.bool, device=u.device)
    lo, hi = -eps, 1 + eps
    for f0 in range(0, F, face_block):
        m, val = face_block_of(f0, f0 + face_block)                  # (..., fb, 3, 3)
        b0, b1, b2 = (m[..., r, 0] * u0 + m[..., r, 1] * u1 + m[..., r, 2] * u2
                      for r in range(3))                             # (..., fb)
        ok = (b0 >= lo) & (b1 >= lo) & (b2 >= lo) & (b0 + b1 + b2 <= hi) & val
        inside |= ok.any(dim=-1)
    return inside


def polyhedron_bboxes(dist, points, ray_dirs):
    """Axis-aligned bounding boxes (lo, hi), each (..., 3)."""
    v = polyhedron_vertices(dist, points, ray_dirs)
    return v.amin(dim=-2), v.amax(dim=-2)


def polyhedron_inner_radius(dist, ray_dirs, faces):
    """Lower bound of the inscribed-sphere radius: the least distance from
    the centre to a face plane (reference stardist3d_impl.cpp:343-467)."""
    tri = _face_triangles(dist, ray_dirs, faces)
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    n = _cross(b - a, c - a)
    nn = torch.linalg.norm(n, dim=-1)
    d = torch.abs(torch.sum(n * a, dim=-1)) / torch.clamp_min(nn, 1e-10)
    return torch.amin(d, dim=-1)
