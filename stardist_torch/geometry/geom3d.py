"""3D geometry: polyhedron rendering and vertex coordinates (counterpart of
``stardist_tpu/geometry/geom3d.py``).

``polyhedron_to_label`` keeps the reference's order semantics: polyhedra
with ``prob >= thr`` are rendered in decreasing-probability order and the
first writer wins (ties: the earlier index); voxels claimed by more than one
polyhedron can be marked with ``overlap_label``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.polyhedron import ray_tensors
from ..ops.rasterize import rasterize_polyhedra
from ..utils import as_tensor_on


def polyhedron_to_label(dist, points, rays, shape, prob=None, thr=-np.inf, labels=None,
                        mode="full", verbose=True, overlap_label=None, *, device="cuda"):
    """Label volume of star polyhedra. dist (n, n_rays), points (n, 3).
    Tensors in -> int32 tensor on their device; numpy in -> numpy int32,
    drawn on ``device`` (the card unless the caller passes ``device="cpu"``).
    Only ``mode="full"`` (the exact polyhedron) is ported."""
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
    if mode != "full":
        raise NotImplementedError(f"render mode '{mode}' is not ported (only 'full')")

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
                                   labels=labels, return_count=overlap_label is not None)
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
