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


def _check_scale_dist(scale_dist):
    if tuple(scale_dist) != (1, 1):
        raise NotImplementedError("scale_dist other than (1, 1) is not ported yet")


def dist_to_coord(dist, points, scale_dist=(1, 1)):
    """Polar to cartesian (numpy): (n_polys, n_rays), (n_polys, 2) ->
    (n_polys, 2, n_rays)."""
    _check_scale_dist(scale_dist)
    dist = np.asarray(dist)
    points = np.asarray(points)
    assert dist.ndim == 2 and points.ndim == 2 and len(dist) == len(points) \
        and points.shape[1] == 2
    phis = ray_angles(dist.shape[1])
    coord = (dist[:, np.newaxis] * np.array([np.sin(phis), np.cos(phis)])).astype(np.float32)
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
    the caller passes ``device="cpu"``). ``thr`` and ``scale_dist`` are not
    ported yet: other values than their defaults raise."""
    if thr != -np.inf:
        raise NotImplementedError("polygons_to_label(thr=...) is not ported yet")
    _check_scale_dist(scale_dist)
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    dev = dist.device
    points = torch.as_tensor(points, device=dev)
    if prob is None:
        prob = torch.full((len(points),), float("inf"), device=dev)
    prob = torch.as_tensor(prob, device=dev)
    assert dist.dim() == 2 and points.dim() == 2 and len(dist) == len(points)
    assert len(points) == len(prob) and points.shape[1] == 2 and prob.dim() == 1

    if out_dtype == torch.uint16 and len(dist) >= 2 ** 16 - 1:
        raise ValueError(f"{len(dist)} polygons do not fit uint16 labels")
    labels = torch.arange(len(dist), device=dev)
    # ranks 1..N and labels + 1 <= N: the raster packs into 32 bits when N fits 16
    img = rasterize_polygons(dist, points, tuple(shape), render_order(prob), labels=labels,
                             out_dtype=torch.int32 if as_numpy else out_dtype,
                             value_bound=len(dist))
    return img.cpu().numpy() if as_numpy else img


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
