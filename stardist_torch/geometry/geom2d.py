"""2D geometry: star distances, polar -> cartesian and label rendering
(counterpart of ``stardist_tpu/geometry/geom2d.py``).

``polygons_to_label`` keeps the reference's order semantics: polygons are
rendered in ascending probability order and later ones overwrite earlier
ones (ties: the later one in a stable ascending sort); label ids are
consecutive in the given candidate order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..matching import _check_label_array
from ..ops.rasterize import rasterize_polygons
from ..ops.stardist2d import march_steps, star_dist2d, star_dist2d_numpy
from ..utils import _normalize_grid, as_tensor_on, regions

# the reference's device modes ('cpp' / 'opencl' accepted for its API), all the torch march
_MARCH_MODES = ("torch", "jax", "tpu", "cpp", "opencl")


def ray_angles(n_rays=32):
    return np.linspace(0, 2 * np.pi, n_rays, endpoint=False)


def star_dist(a, n_rays=32, grid=(1, 1), mode="torch", *, device="cuda"):
    """Star-convex distances of a label image ``a`` (id 0 = background):
    ((H - 1) // gy + 1, (W - 1) // gx + 1, n_rays) float32. ``mode``
    "numpy" / "python" runs the numpy oracle; the others the torch ray march
    (:func:`..ops.stardist2d.star_dist2d`), numpy in -> numpy out, drawn on
    ``device`` (the card unless the caller passes ``device="cpu"``); a
    tensor runs on its own device and comes back as a tensor."""
    if not (np.isscalar(n_rays) and 0 < int(n_rays)):
        raise ValueError("need 'n_rays' >= 1")
    if n_rays < 3:
        raise ValueError("need 'n_rays' >= 3")
    n_rays = int(n_rays)
    grid = _normalize_grid(grid, 2)
    if mode in ("numpy", "python"):
        return star_dist2d_numpy(np.asarray(a), n_rays, grid=grid)
    if mode not in _MARCH_MODES:
        raise ValueError(f"Unknown mode {mode}")
    if isinstance(a, torch.Tensor):
        return star_dist2d(a, n_rays, grid)
    a = np.asarray(a).astype(np.int32)
    return star_dist2d(as_tensor_on(a, device), n_rays, grid,
                       n_steps=march_steps(a)).cpu().numpy()


def dist_to_coord(dist, points, scale_dist=(1, 1)):
    """Polar to cartesian (numpy): (n_polys, n_rays), (n_polys, 2) ->
    (n_polys, 2, n_rays) float32, the offsets stretched by ``scale_dist``
    per axis."""
    dist = np.asarray(dist)
    points = np.asarray(points)
    assert dist.ndim == 2 and points.ndim == 2 and len(dist) == len(points) \
        and points.shape[1] == 2 and len(scale_dist) == 2
    phis = ray_angles(dist.shape[1])
    coord = (dist[:, np.newaxis] * np.array([np.sin(phis), np.cos(phis)])).astype(np.float32)
    coord *= np.asarray(scale_dist).reshape(1, 2, 1)
    coord += points[..., np.newaxis]
    return coord


def render_order(prob):
    """1-based rank of each polygon in a stable ascending-prob sort: the
    scatter-max winner is the polygon the reference would draw last."""
    ind = torch.sort(prob, stable=True).indices
    order = torch.empty_like(ind)
    order[ind] = torch.arange(1, len(ind) + 1, device=ind.device)
    return order


def polygons_to_label(dist, points, shape, prob=None, thr=-np.inf, scale_dist=(1, 1), *,
                      out_dtype=torch.int32, device="cuda"):
    """Label image of star polygons. Tensors in -> a tensor on their device
    (int32, or ``out_dtype=torch.uint16`` when there are fewer than 2^16 - 1
    polygons); numpy in -> numpy int32, drawn on ``device`` (the card unless
    the caller passes ``device="cpu"``). Only the polygons with ``prob >
    thr`` are drawn (labels consecutive over them); ``scale_dist`` stretches
    the polygons per axis about their centres (``points``, which need not
    be integers)."""
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    dev = dist.device
    points = torch.as_tensor(points, device=dev)
    if prob is None:
        prob = torch.full((len(points),), float("inf"), device=dev)
    prob = torch.as_tensor(prob, device=dev)
    assert dist.dim() == 2 and points.dim() == 2 and len(dist) == len(points)
    assert len(points) == len(prob) and points.shape[1] == 2 and prob.dim() == 1
    if thr != -np.inf:
        ind = prob > thr
        dist, points, prob = dist[ind], points[ind], prob[ind]

    if out_dtype == torch.uint16 and len(dist) >= 2 ** 16 - 1:
        raise ValueError(f"{len(dist)} polygons do not fit uint16 labels")
    labels = torch.arange(len(dist), device=dev)
    # ranks 1..N and labels + 1 <= N: the raster packs into 32 bits when N fits 16
    img = rasterize_polygons(dist, points, tuple(shape), render_order(prob), labels=labels,
                             out_dtype=torch.int32 if as_numpy else out_dtype,
                             scale_dist=tuple(scale_dist), value_bound=len(dist))
    return img.cpu().numpy() if as_numpy else img


def polygons_to_label_coord(coord, shape, labels=None, *, device="cuda"):
    """Label image (numpy int32) of polygons given by their vertices (n_polys,
    2, n_rays), as :func:`dist_to_coord` makes them (equiangular rays): the
    centre and the dists are recovered by least squares (in numpy, as the
    reference does) and drawn on ``device`` (the card unless the caller
    passes ``device="cpu"``); ``labels[i] + 1`` is polygon i's value, the
    later polygon winning where they overlap."""
    coord = np.asarray(coord)
    if labels is None:
        labels = np.arange(len(coord))
    _check_label_array(labels, "labels")
    assert coord.ndim == 3 and coord.shape[1] == 2 and len(coord) == len(labels)
    n_polys, _, n_rays = coord.shape
    if n_polys == 0:
        return np.zeros(shape, np.int32)
    phis = ray_angles(n_rays)
    dirs = np.stack([np.sin(phis), np.cos(phis)], axis=-1)  # (R, 2)
    # vertex_k = c + d_k * dirs_k: the part of v_k - c across dirs_k is 0,
    # a linear system perp_k . c = perp_k . v_k for the centre c
    perp = np.stack([-dirs[:, 1], dirs[:, 0]], axis=-1)  # (R, 2)
    v = np.moveaxis(coord, 1, -1)  # (N, R, 2)
    b = np.einsum("rk,nrk->nr", perp, v)
    AtA = perp.T @ perp
    Atb = np.einsum("rk,nr->nk", perp, b)
    c = np.linalg.solve(AtA[None], Atb[..., None])[..., 0]  # (N, 2)
    d = np.maximum(np.einsum("rk,nrk->nr", dirs, v - c[:, None, :]), 1e-3)
    order = np.arange(1, n_polys + 1)    # ascending: the later polygon wins
    t = [as_tensor_on(np.asarray(a), device) for a in (d, c, order, labels)]
    img = rasterize_polygons(t[0], t[1], tuple(shape), t[2], labels=t[3],
                             value_bound=int(max(n_polys, labels.max() + 1)))
    return img.cpu().numpy()


# -- the reference's legacy dense-coordinate API (geom2d.py:185-216) ---------

def _dist_to_coord_old(rhos, grid=(1, 1)):
    """Dense polar to cartesian (numpy): (..., Ny, Nx, n_rays) -> (..., Ny,
    Nx, 2, n_rays), the centres on the ``grid``."""
    grid = _normalize_grid(grid, 2)
    is_single = rhos.ndim == 3
    if is_single:
        rhos = rhos[np.newaxis]
    assert rhos.ndim == 4
    n_images, h, w, n_rays = rhos.shape
    coord = np.empty((n_images, h, w, 2, n_rays), dtype=rhos.dtype)
    start = np.indices((h, w))
    for i in range(2):
        coord[..., i, :] = grid[i] * np.broadcast_to(start[i].reshape(1, h, w, 1),
                                                     (n_images, h, w, n_rays))
    phis = ray_angles(n_rays).reshape(1, 1, 1, n_rays)
    coord[..., 0, :] += rhos * np.sin(phis)
    coord[..., 1, :] += rhos * np.cos(phis)
    return coord[0] if is_single else coord


def _polygons_to_label_old(coord, prob, points, shape=None, thr=-np.inf, *, device="cuda"):
    """Draw the polygons at the grid indices ``points`` of a dense coord map,
    in increasing-prob order (the later wins), ids consecutive in that
    order; those with prob below ``thr`` are left out."""
    sh = coord.shape[:2] if shape is None else shape
    points = np.asarray(points)
    ind = np.argsort([prob[p[0], p[1]] for p in points], kind="stable")
    points = points[ind]
    keep = [p for p in points if prob[p[0], p[1]] >= thr]
    if len(keep) == 0:
        return np.zeros(sh, np.int32)
    coords = np.stack([coord[p[0], p[1]] for p in keep])  # (n, 2, R)
    return polygons_to_label_coord(coords, shape=sh, labels=np.arange(len(keep)),
                                   device=device)


def relabel_image_stardist(lbl, n_rays, *, device="cuda", **kwargs):
    """Relabel each region of ``lbl`` with its star-convex polygon
    approximation (numpy int32); ``kwargs`` go to :func:`star_dist`, and
    both it and the drawing run on ``device``."""
    _check_label_array(lbl, "lbl")
    if not lbl.ndim == 2:
        raise ValueError("lbl image should be 2 dimensional")
    dist = star_dist(lbl, n_rays, device=device, **kwargs)
    points = np.array(tuple(np.array(r.centroid).astype(int) for r in regions(lbl)))
    if len(points) == 0:
        dist, points = np.zeros((0, n_rays), np.float32), np.zeros((0, 2), int)
    else:
        dist = dist[tuple(points.T)]
    return polygons_to_label(dist, points, shape=lbl.shape, device=device)
