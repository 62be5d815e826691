"""3D geometry: star distances, polyhedron rendering, vertex coordinates,
volumes and centroids, OBJ export (counterpart of
``stardist_tpu/geometry/geom3d.py``; the numpy helpers are copies of the
reference's).

``polyhedron_to_label`` keeps the reference's order semantics: polyhedra
with ``prob >= thr`` are rendered in decreasing-probability order and the
first writer wins (ties: the earlier index); voxels claimed by more than one
polyhedron can be marked with ``overlap_label``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..matching import _check_label_array
from ..ops.polyhedron import ray_tensors
from ..ops.rasterize import rasterize_polyhedra
from ..ops.stardist3d import march_steps, star_dist3d, star_dist3d_numpy
from ..utils import _normalize_grid, as_tensor_on, regions

# the reference's device modes ('cpp' / 'opencl' accepted for its API), all the torch march
_MARCH_MODES = ("torch", "jax", "tpu", "cpp", "opencl")


def star_dist3D(lbl, rays, grid=(1, 1, 1), mode="torch", *, device="cuda"):
    """Star-convex distances of a 3D label volume along ``rays``:
    ((D - 1) // gz + 1, (H - 1) // gy + 1, (W - 1) // gx + 1, n_rays)
    float32. ``mode`` "numpy" / "python" runs the numpy oracle; the others
    the torch ray march (:func:`..ops.stardist3d.star_dist3d`), numpy in ->
    numpy out, marched on ``device`` (the card unless the caller passes
    ``device="cpu"``); a tensor runs on its own device and comes back as a
    tensor."""
    grid = _normalize_grid(grid, 3)
    if mode in ("numpy", "python"):
        return star_dist3d_numpy(np.asarray(lbl), rays, grid=grid)
    if mode not in _MARCH_MODES:
        raise ValueError(f"Unknown mode {mode}")
    if isinstance(lbl, torch.Tensor):
        return star_dist3d(lbl, rays, grid)
    lbl = np.asarray(lbl).astype(np.int32)
    return star_dist3d(as_tensor_on(lbl, device), rays, grid,
                       n_steps=march_steps(lbl, rays)).cpu().numpy()


def polyhedron_to_label(dist, points, rays, shape, prob=None, thr=-np.inf, labels=None,
                        mode="full", verbose=True, overlap_label=None, *, device="cuda"):
    """Label volume of star polyhedra. dist (n, n_rays), points (n, 3).
    Tensors in -> int32 tensor on their device; numpy in -> numpy int32,
    drawn on ``device`` (the card unless the caller passes ``device="cpu"``).
    ``mode`` "full" draws the exact polyhedron, "kernel" the intersection of
    its faces' inner half-spaces, "bbox" its bounding box; "hull" and
    "debug" raise ``NotImplementedError``, as in the reference."""
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    dev = dist.device
    if len(points) == 0:
        if verbose:
            print("warning: empty list of points (returning background-only image)")
        out = torch.zeros(tuple(shape), dtype=torch.int32, device=dev)
        return out.cpu().numpy() if as_numpy else out
    points = torch.as_tensor(points, device=dev)
    if dist.dim() == 1:
        dist = dist.reshape(1, -1)
    if points.dim() == 1:
        points = points.reshape(1, -1)
    labels = (torch.arange(1, len(points) + 1, device=dev) if labels is None
              else torch.as_tensor(labels, device=dev))
    prob = (torch.ones(len(points), device=dev) if prob is None
            else torch.as_tensor(prob, device=dev))
    if torch.amin(dist) <= 0:
        raise ValueError("distance array should be positive!")
    if dist.dim() != 2:
        raise ValueError("dist should be 2 dimensional but has shape %s" % str(tuple(dist.shape)))
    if dist.shape[1] != len(rays):
        raise ValueError("inconsistent number of rays!")
    if len(prob) != len(points):
        raise ValueError("len(prob) != len(points)")
    if len(labels) != len(points):
        raise ValueError("len(labels) != len(points)")
    if mode not in ("full", "kernel", "bbox", "hull", "debug"):
        raise KeyError(f"Unknown render mode '{mode}'")
    if mode in ("hull", "debug"):
        raise NotImplementedError(f"render mode '{mode}' is not supported")

    # filter by threshold (>= thr, unlike 2D which uses > thr)
    ind = torch.nonzero(prob >= thr).flatten()
    if len(ind) == 0:
        if verbose:
            print(f"warning: no points found with probability>= {thr:.4f} "
                  "(returning background-only image)")
        out = torch.zeros(tuple(shape), dtype=torch.int32, device=dev)
        return out.cpu().numpy() if as_numpy else out
    prob, points, dist, labels = prob[ind], points[ind], dist[ind], labels[ind]

    # decreasing probability, first writer wins: for the scatter-max the
    # order value decreases with the sort position (ties: earlier index)
    order = torch.sort(-prob, stable=True).indices
    n = len(order)
    order_values = torch.empty(n, dtype=torch.int64, device=dev)
    order_values[order] = torch.arange(n, 0, -1, device=dev)

    ray_dirs, faces = ray_tensors(rays, dev)
    out, cnt = rasterize_polyhedra(dist, points, ray_dirs, faces, tuple(shape), order_values,
                                   labels=labels, return_count=overlap_label is not None,
                                   mode=mode)
    if overlap_label is not None:
        out = torch.where(cnt > 1, torch.full_like(out, int(overlap_label)), out)
    return out.cpu().numpy() if as_numpy else out


def dist_to_coord3D(dist, points, rays_vertices):
    """Convert dist/points/rays_vertices to vertex coordinate lists (numpy)."""
    dist = np.asarray(dist)
    points = np.asarray(points)
    rays_vertices = np.asarray(rays_vertices)
    if not all((len(dist) == len(points), dist.ndim == 2, points.ndim == 2,
                points.shape[-1] == 3, rays_vertices.shape[-1] == 3,
                dist.shape[-1] == len(rays_vertices))):
        raise ValueError("Wrong shapes! dist -> (m,n) points -> (m,3) rays_vertices -> (n,3)")
    return points[:, np.newaxis] + dist[..., np.newaxis] * rays_vertices


def relabel_image_stardist3D(lbl, rays, verbose=False, *, device="cuda", **kwargs):
    """Relabel each region of ``lbl`` with its star-convex polyhedron
    approximation (numpy int32); ``kwargs`` go to :func:`star_dist3D`, and
    both it and the drawing run on ``device``."""
    _check_label_array(lbl, "lbl")
    if not lbl.ndim == 3:
        raise ValueError("lbl image should be 3 dimensional")
    dist_all = star_dist3D(lbl, rays, device=device, **kwargs)
    regs = regions(lbl)
    points = np.array(tuple(np.array(r.centroid).astype(int) for r in regs))
    labs = np.array(tuple(r.label for r in regs))
    if len(points) == 0:
        return np.zeros(lbl.shape, np.int32)
    dist = np.array(tuple(dist_all[p[0], p[1], p[2]] for p in points))
    dist = np.maximum(dist, 1e-3)
    return polyhedron_to_label(dist, points, rays, shape=lbl.shape, labels=labs,
                               verbose=verbose, device=device)


def dist_to_volume(dist, rays):
    """Per-voxel polyhedron volumes from a dense dist map (nz, ny, nx,
    n_rays) (reference c_dist_to_volume, stardist3d_impl.cpp:1529-1558)."""
    dist = np.asanyarray(dist)
    if dist.ndim != 4:
        raise ValueError(f"dist.ndim = {dist.ndim} but should be 4")
    if dist.shape[-1] != len(rays):
        raise ValueError(f"dist.shape[-1] = {dist.shape[-1]} but should be {len(rays)}")
    return rays.volume(dist).astype(np.float32)


def dist_to_centroid(dist, rays, mode="absolute"):
    """Per-voxel polyhedron centroids from a dense dist map (nz, ny, nx,
    n_rays). mode='relative' gives centroids relative to the voxel centre;
    'absolute' adds the voxel position (reference c_dist_to_centroid,
    stardist3d_impl.cpp:1561-1589)."""
    dist = np.asanyarray(dist)
    if dist.ndim != 4:
        raise ValueError(f"dist.ndim = {dist.ndim} but should be 4")
    if dist.shape[-1] != len(rays):
        raise ValueError(f"dist.shape[-1] = {dist.shape[-1]} but should be {len(rays)}")
    if mode not in ("absolute", "relative"):
        raise ValueError("mode should be either 'absolute' or 'relative'")
    verts = np.asarray(rays.vertices, np.float32)
    faces = np.asarray(rays.faces)
    v = dist[..., None] * verts                  # (..., R, 3)
    tri = v[..., faces, :]                       # (..., F, 3, 3)
    det = np.linalg.det(tri)                     # (..., F)
    vol_f = -det / 6.0
    cen_f = tri.sum(axis=-2) / 4.0               # tetrahedron centroid about the voxel
    total = vol_f.sum(axis=-1, keepdims=True)
    centroid = (vol_f[..., None] * cen_f).sum(axis=-2) / (total + 1e-10)
    if mode == "absolute":
        zz, yy, xx = np.meshgrid(*map(np.arange, dist.shape[:3]), indexing="ij")
        centroid = centroid + np.stack([zz, yy, xx], axis=-1)
    return centroid.astype(np.float32)


def export_to_obj_file3D(polys, fname=None, scale=1, single_mesh=True, uv_map=False,
                         name="poly"):
    """Export 3D polyhedra (a dict with dist / points / rays_vertices /
    rays_faces, as ``StarDist3D.predict_instances`` returns) to a Wavefront
    OBJ string, written to ``fname`` when given (reference geom3d.py:277-347)."""
    try:
        dist = polys["dist"]
        points = polys["points"]
        rays_vertices = polys["rays_vertices"]
        rays_faces = polys["rays_faces"]
    except KeyError as e:
        raise ValueError(
            "polys should be a dict with keys 'dist', 'points', 'rays_vertices', 'rays_faces' "
            "(such as generated by StarDist3D.predict_instances)"
        ) from e

    coord = dist_to_coord3D(dist, points, rays_vertices)
    if not all((coord.ndim == 3, coord.shape[-1] == 3, np.asarray(rays_faces).shape[-1] == 3)):
        raise ValueError("Wrong shapes! coord -> (m,n,3) rays_faces -> (k,3)")

    if np.isscalar(scale):
        scale = (scale,) * 3
    scale = np.asarray(scale)
    assert len(scale) == 3
    coord = coord * scale

    decimals = int(max(1, 1 - np.log10(np.min(scale))))
    scaled_verts = scale * np.asarray(rays_vertices)
    scaled_verts /= np.linalg.norm(scaled_verts, axis=1, keepdims=True)

    rays_faces = np.asarray(rays_faces).copy() + 1

    parts = []
    for i, xs in enumerate(coord):
        xs = xs[:, [2, 1, 0]]  # reorder to xyz
        if i == 0 or not single_mesh:
            parts.append(f"o {name}_{i:d}\n")
        for x, y, z in xs:
            parts.append(f"v {x:.{decimals}f} {y:.{decimals}f} {z:.{decimals}f}\n")
        if uv_map:
            for vz, vy, vx in scaled_verts:
                u = 1 - (0.5 + 0.5 * np.arctan2(vz, vx) / np.pi)
                v = 1 - (0.5 - np.arcsin(vy) / np.pi)
                parts.append(f"vt {u:.4f} {v:.4f}\n")
        for face in rays_faces:
            parts.append(f"f {face[0]}/{face[0]} {face[1]}/{face[1]} {face[2]}/{face[2]}\n")
        rays_faces += len(xs)

    obj_str = "".join(parts)
    if fname is not None:
        with open(fname, "w") as f:
            f.write(obj_str)
    return obj_str
