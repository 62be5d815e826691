"""Ray factories for 3D star-convex polyhedra (a copy of
``stardist_tpu/rays3d.py``, which needs only numpy and scipy).

Provides unit direction vectors ("rays") on the sphere plus a triangulation
(faces) of the resulting polyhedron. API-compatible with the reference
``stardist/rays3d.py`` (Rays_Base contract: ``vertices`` (n,3) as (z,y,x)
unit vectors, ``faces`` (m,3) index triples, JSON round trip, ``volume`` /
``surface`` / ``copy`` / ``dist_loss_weights``).
"""
from __future__ import annotations

import copy as _copy

import numpy as np
from scipy.spatial import ConvexHull


class Rays_Base(object):
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        verts, faces = self.setup_vertices_faces()
        self._vertices = np.asarray(verts, np.float32)
        self._faces = np.asarray(faces, int)

    def setup_vertices_faces(self):
        """Return (vertices, faces) with vertices = ((z,y,x), ...)."""
        raise NotImplementedError()

    @property
    def vertices(self):
        return self._vertices.copy()

    @property
    def faces(self):
        return self._faces.copy()

    def __getitem__(self, i):
        return self.vertices[i]

    def __len__(self):
        return len(self._vertices)

    def __repr__(self):
        def _conv(x):
            if isinstance(x, (tuple, list, np.ndarray)):
                return "_".join(_conv(_x) for _x in x)
            if isinstance(x, float):
                return "%.2f" % x
            return str(x)

        return "%s_%s" % (
            self.__class__.__name__,
            "_".join("%s_%s" % (k, _conv(v)) for k, v in sorted(self.kwargs.items())),
        )

    def to_json(self):
        return {"name": self.__class__.__name__, "kwargs": self.kwargs}

    def dist_loss_weights(self, anisotropy=(1, 1, 1)):
        """Anisotropy-corrected per-ray loss weights."""
        anisotropy = np.array(anisotropy)
        assert anisotropy.shape == (3,)
        return np.linalg.norm(self.vertices * anisotropy, axis=-1)

    def volume(self, dist=None):
        """Volume of the star-convex polyhedron spanned by dist.

        dist may be an nD array with last dimension of length n_rays; computed
        as the sum of signed tetrahedron volumes over faces (same formula as
        reference rays3d.py:76-107).
        """
        if dist is None:
            dist = np.ones(len(self._vertices), np.float32)
        dist = np.asarray(dist)
        if dist.shape[-1] != len(self._vertices):
            raise ValueError("last dimension of dist should have length len(rays.vertices)")
        # scaled vertices per input element: (..., n_rays, 3)
        v = dist[..., None] * self._vertices
        # per-face triangles: (..., n_faces, 3, 3)
        tri = v[..., self._faces, :]
        d = np.linalg.det(tri)
        return -1.0 / 6 * np.sum(d, axis=-1)

    def surface(self, dist=None):
        """Surface area of the star-convex polyhedron spanned by dist."""
        if dist is None:
            dist = np.ones(len(self._vertices), np.float32)
        dist = np.asarray(dist)
        if dist.shape[-1] != len(self._vertices):
            raise ValueError("last dimension of dist should have length len(rays.vertices)")
        v = dist[..., None] * self._vertices
        tri = v[..., self._faces, :]
        pa = tri[..., 1, :] - tri[..., 0, :]
        pb = tri[..., 2, :] - tri[..., 0, :]
        d = 0.5 * np.linalg.norm(np.cross(pa, pb), axis=-1)
        return np.sum(d, axis=-1)

    def copy(self, scale=(1, 1, 1)):
        """Copy with vertices scaled by the given per-axis factors."""
        scale = np.asarray(scale)
        assert scale.shape == (3,)
        res = _copy.deepcopy(self)
        res._vertices *= scale[np.newaxis]
        return res


def rays_from_json(d):
    """Reconstruct a Rays object from its JSON dict (by registered class name)."""
    cls = _RAYS_CLASSES.get(d["name"])
    if cls is None:
        raise ValueError(f"unknown rays class '{d['name']}'")
    return cls(**d["kwargs"])


class Rays_Explicit(Rays_Base):
    def __init__(self, vertices0, faces0):
        self.vertices0, self.faces0 = vertices0, faces0
        super().__init__(vertices0=list(np.asarray(vertices0).tolist()),
                         faces0=list(np.asarray(faces0).tolist()))

    def setup_vertices_faces(self):
        return self.vertices0, self.faces0


class Rays_Cartesian(Rays_Base):
    """Rays on a lat/long grid (reference rays3d.py:171-212)."""

    def __init__(self, n_rays_x=11, n_rays_z=5):
        super().__init__(n_rays_x=n_rays_x, n_rays_z=n_rays_z)

    def setup_vertices_faces(self):
        n_rays_x, n_rays_z = self.kwargs["n_rays_x"], self.kwargs["n_rays_z"]
        dphi = np.float32(2.0 * np.pi / n_rays_x)
        dtheta = np.float32(np.pi / n_rays_z)

        verts = []
        for mz in range(n_rays_z):
            for mx in range(n_rays_x):
                phi = mx * dphi
                theta = mz * dtheta
                if mz == 0:
                    theta = 1e-12
                if mz == n_rays_z - 1:
                    theta = np.pi - 1e-12
                dx = np.cos(phi) * np.sin(theta)
                dy = np.sin(phi) * np.sin(theta)
                dz = np.cos(theta)
                if mz == 0 or mz == n_rays_z - 1:
                    dx += 1e-12
                    dy += 1e-12
                verts.append([dz, dy, dx])

        def _ind(mz, mx):
            return mz * n_rays_x + mx

        faces = []
        for mz in range(n_rays_z - 1):
            for mx in range(n_rays_x):
                faces.append([_ind(mz, mx), _ind(mz + 1, (mx + 1) % n_rays_x), _ind(mz, (mx + 1) % n_rays_x)])
                faces.append([_ind(mz, mx), _ind(mz + 1, mx), _ind(mz + 1, (mx + 1) % n_rays_x)])

        return np.array(verts), np.array(faces)


class Rays_SubDivide(Rays_Base):
    """Recursive edge-midpoint subdivision of a base polyhedron.

    n_level = 1 -> base polyhedron, each +1 subdivides every face in 4.
    """

    def __init__(self, n_level=4):
        super().__init__(n_level=n_level)

    def base_polyhedron(self):
        raise NotImplementedError()

    def setup_vertices_faces(self):
        verts, faces = self.base_polyhedron()
        n_level = self.kwargs["n_level"]
        for _ in range(max(0, n_level - 1)):
            verts, faces = Rays_SubDivide.split(verts, faces)
        return verts, faces

    @classmethod
    def split(cls, verts0, faces0):
        split_edges = dict()
        verts = list(np.asarray(verts0))
        faces = []

        def _mid(a, b):
            edge = tuple(sorted((a, b)))
            if edge not in split_edges:
                v = 0.5 * (verts[a] + verts[b])
                v = v / np.linalg.norm(v)
                verts.append(v)
                split_edges[edge] = len(verts) - 1
            return split_edges[edge]

        for v1, v2, v3 in faces0:
            m12 = _mid(v1, v2)
            m23 = _mid(v2, v3)
            m31 = _mid(v3, v1)
            faces.append([v1, m12, m31])
            faces.append([v2, m23, m12])
            faces.append([v3, m31, m23])
            faces.append([m12, m23, m31])

        return verts, faces


class Rays_Tetra(Rays_SubDivide):
    """Subdivided tetrahedron (4/10/34/... vertices)."""

    def base_polyhedron(self):
        verts = np.array([
            [np.sqrt(8.0 / 9), 0.0, -1.0 / 3],
            [-np.sqrt(2.0 / 9), np.sqrt(2.0 / 3), -1.0 / 3],
            [-np.sqrt(2.0 / 9), -np.sqrt(2.0 / 3), -1.0 / 3],
            [0.0, 0.0, 1.0],
        ])
        faces = [[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]]
        return verts, faces


class Rays_Octo(Rays_SubDivide):
    """Subdivided octahedron (6/18/66/... vertices)."""

    def base_polyhedron(self):
        verts = np.array([
            [0, 0, 1], [0, 1, 0], [0, 0, -1], [0, -1, 0], [1, 0, 0], [-1, 0, 0],
        ])
        faces = [
            [0, 1, 4], [0, 5, 1], [1, 2, 4], [1, 5, 2],
            [2, 3, 4], [2, 5, 3], [3, 0, 4], [3, 5, 0],
        ]
        return verts, faces


def reorder_faces(verts, faces):
    """Reorder each face so its orientation points outward (det <= 0)."""
    def _single(face):
        return face[::-1] if np.linalg.det(verts[face]) > 0 else face

    return tuple(map(_single, faces))


class Rays_GoldenSpiral(Rays_Base):
    """Fibonacci-sphere rays, optionally anisotropy-warped; faces from the
    convex hull of the (warped) directions (reference rays3d.py:337-373).

    This is the default ray set for 3D models (Rays_GoldenSpiral(96),
    reference stardist/models/model3d.py:214-224).
    """

    def __init__(self, n=70, anisotropy=None):
        if n < 4:
            raise ValueError("At least 4 points have to be given!")
        super().__init__(n=n, anisotropy=anisotropy if anisotropy is None else tuple(anisotropy))

    def setup_vertices_faces(self):
        n = self.kwargs["n"]
        anisotropy = self.kwargs["anisotropy"]
        anisotropy = np.ones(3) if anisotropy is None else np.array(anisotropy)

        # golden angle spiral on the sphere
        g = (3.0 - np.sqrt(5.0)) * np.pi
        phi = g * np.arange(n)
        z = np.linspace(-1, 1, n)
        rho = np.sqrt(1.0 - z ** 2)
        verts = np.stack([z, rho * np.sin(phi), rho * np.cos(phi)]).T

        # warp by anisotropy before triangulating
        verts = verts / anisotropy
        hull = ConvexHull(verts)
        faces = reorder_faces(verts, hull.simplices)
        verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
        return verts, faces


_RAYS_CLASSES = {
    c.__name__: c
    for c in (Rays_Explicit, Rays_Cartesian, Rays_Tetra, Rays_Octo, Rays_GoldenSpiral)
}
