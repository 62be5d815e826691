"""2D geometry: polar -> cartesian and label rendering (counterpart of
``stardist_tpu/geometry/geom2d.py``).

``polygons_to_label`` keeps the reference's order semantics: polygons are
rendered in ascending probability order and later ones overwrite earlier
ones (ties: the later one in a stable ascending sort); label ids are
consecutive in the given candidate order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.rasterize import rasterize_polygons
from ..utils import as_tensor_on


def ray_angles(n_rays=32):
    return np.linspace(0, 2 * np.pi, n_rays, endpoint=False)


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
