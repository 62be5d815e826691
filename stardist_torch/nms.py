"""Non-maximum suppression — API layer (counterpart of ``stardist_tpu/nms.py``).

Sorting and marshalling happen here; the overlap tests and the greedy
suppression run in :mod:`stardist_torch.ops.nms` on the device the
candidates live on. Inputs may be numpy arrays or torch tensors; the outputs
are of the kind ``dist`` was given as. Tensors stay on their device; numpy
inputs go to ``device`` (the card unless the caller passes ``device="cpu"``).

Every entry takes the reference's ``**nms_opts`` (``stardist_tpu/ops/nms.py``
``nms_polygons`` and ``nms_polyhedra``): ``samples`` is the exact overlap
test's resolution (2D: the fine grid's side, 16 by default; 3D: the
lattice's points per axis, 12 by default) and changes the result as it does
there. ``dense_max``, ``row_block``, ``col_block``, ``device_nms`` and
``dist_max`` choose how the reference schedules its work, whose paths share
one criterion: they are taken and change nothing. Any other name raises
``TypeError``, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.profiling import span
from .ops.nms import LATTICE_S, nms_polygons, nms_polyhedra
from .ops.polyhedron import ray_tensors
from .utils import _normalize_grid, as_tensor_on


SCHEDULING_OPTIONS = ("dense_max", "row_block", "col_block", "device_nms", "dist_max")


def _samples(nms_opts, default):
    """The ``samples`` of the reference's NMS options ``nms_opts`` (default
    ``default``), checked; the scheduling options are dropped."""
    unknown = sorted(set(nms_opts) - {"samples", *SCHEDULING_OPTIONS})
    if unknown:
        raise TypeError(f"unexpected NMS option(s): {', '.join(unknown)}")
    samples = nms_opts.get("samples", default)
    if isinstance(samples, bool) or int(samples) != samples or samples < 1:
        raise ValueError(f"samples must be an integer >= 1, got {samples!r}")
    return int(samples)


def descending_order(prob):
    """The candidate order contract: descending prob, ties in descending
    index — ``np.argsort(prob, kind="stable")[::-1]``."""
    return torch.flip(torch.sort(prob, stable=True).indices, dims=(0,))


def _ind_prob_thresh(prob, prob_thresh, b=2):
    """Candidate mask of a dense prob map (numpy, or a tensor on its
    device): prob strictly above ``prob_thresh`` (compared in prob's type,
    as numpy compares with a Python float) and at least ``b`` pixels from
    the border (per axis a (lo, hi) pair, or a scalar for all)."""
    if b is not None and np.isscalar(b):
        b = ((b, b),) * prob.ndim
    ind_thresh = prob > float(prob_thresh)
    if b is not None:
        zeros_like = torch.zeros_like if isinstance(prob, torch.Tensor) else np.zeros_like
        inner = zeros_like(ind_thresh)
        inner[tuple(slice(lo if lo > 0 else None, -hi if hi > 0 else None)
                    for lo, hi in b)] = True
        ind_thresh &= inner
    return ind_thresh


def _dense_candidates(dist, prob, grid, prob_thresh, b):
    """The candidates of dense maps on their device: (prob, dist, points)
    of :func:`_ind_prob_thresh`'s mask (row-major, as np.where) in
    :func:`descending_order`, points (int64) in full-resolution pixels
    (times ``grid``)."""
    with span("stardist.nms.sort"):
        mask = _ind_prob_thresh(prob, prob_thresh, b)
        scores = prob[mask]
        order = descending_order(scores)
        points = torch.nonzero(mask)[order] * torch.tensor(grid, device=dist.device)
        return scores[order], dist[mask][order], points


def non_maximum_suppression(dist, prob, grid=(1, 1), b=2, nms_thresh=0.5, prob_thresh=0.5,
                            use_bbox=True, use_kdtree=True, verbose=False, *, stats=None,
                            device="cuda", **nms_opts):
    """NMS of dense 2D predictions, dist (Ny, Nx, R) and prob (Ny, Nx): the
    candidates of :func:`_ind_prob_thresh`, in :func:`descending_order`,
    through the greedy NMS (the pair kernel on the card), all on the
    device of ``dist`` (numpy inputs go to ``device``). ``use_bbox`` and
    ``use_kdtree`` change nothing, as in the reference; ``nms_opts`` as in
    the module docstring.

    Returns (points, prob, dist) of the survivors, in descending-prob order;
    points (int64) in full-resolution pixels (times ``grid``)."""
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    prob = as_tensor_on(prob, dist.device)
    assert prob.dim() == 2 and dist.dim() == 3 and prob.shape == dist.shape[:2]
    probi, disti, points = _dense_candidates(dist, prob, _normalize_grid(grid, 2),
                                             prob_thresh, b)
    keep = non_maximum_suppression_inds(disti, points, scores=probi, thresh=nms_thresh,
                                        stats=stats, **nms_opts)
    if verbose:
        print("keeping %s/%s polygons" % (int(keep.sum()), len(keep)))
    out = points[keep], probi[keep], disti[keep]
    return tuple(t.cpu().numpy() for t in out) if as_numpy else out


def _non_maximum_suppression_old(coord, prob, grid=(1, 1), b=2, nms_thresh=0.5,
                                 prob_thresh=0.5, verbose=False, max_bbox_search=True, *,
                                 device="cuda"):
    """The reference's legacy NMS on a dense coordinate map (numpy; coord
    (Ny, Nx, 2, n_rays), prob (Ny, Nx)): each candidate's dists are
    recovered from its vertices about its grid centre (in numpy, as the
    reference does) and its NMS runs on ``device``. Returns the grid
    indices (Ny, Nx) of the survivors. ``max_bbox_search`` changes
    nothing."""
    assert prob.ndim == 2 and coord.ndim == 4
    grid = _normalize_grid(grid, 2)
    mask = _ind_prob_thresh(prob, prob_thresh, b)
    points = np.stack(np.where(mask), axis=1)
    scores = prob[mask]
    centers = points * np.array(grid).reshape(1, 2)
    rel = coord[mask] - centers[:, :, None]
    dist = np.sqrt(np.sum(rel ** 2, axis=1)).astype(np.float32)
    ind = np.argsort(scores, kind="stable")[::-1]
    survivors = np.zeros(len(ind), bool)
    survivors[ind] = non_maximum_suppression_inds(dist[ind], centers[ind].astype(np.float32),
                                                  scores[ind], nms_thresh, device=device)
    if verbose:
        print("keeping %s/%s polygons" % (np.count_nonzero(survivors), len(survivors)))
    return points[survivors]


def non_maximum_suppression_sparse(dist, prob, points, b=2, nms_thresh=0.5, use_bbox=True,
                                   use_kdtree=True, verbose=False, *, stats=None,
                                   device="cuda", **nms_opts):
    """NMS from sparse candidate lists (``b``, ``use_bbox`` and
    ``use_kdtree`` are taken for calls written for the reference and change
    nothing, as there; ``nms_opts`` as in the module docstring).

    Returns (points, prob, dist, inds_original) of the survivors, in
    descending-prob order."""
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    prob = as_tensor_on(prob, dist.device)
    points = as_tensor_on(points, dist.device)
    assert dist.dim() == 2 and prob.dim() == 1 and points.dim() == 2 \
        and points.shape[-1] == 2 and len(prob) == len(dist) == len(points)

    with span("stardist.nms.sort"):
        order = descending_order(prob)
        probi, disti, pointsi = prob[order], dist[order], points[order]
    keep = non_maximum_suppression_inds(disti, pointsi, scores=probi,
                                        thresh=nms_thresh, stats=stats, **nms_opts)
    if verbose:
        print("keeping %s/%s polygons" % (int(keep.sum()), len(keep)))
    out = pointsi[keep], probi[keep], disti[keep], order[keep]
    if as_numpy:
        out = tuple(t.cpu().numpy() for t in out)
    return out


def non_maximum_suppression_inds(dist, points, scores, thresh=0.5, use_bbox=True,
                                 use_kdtree=True, verbose=1, *, stats=None, device="cuda",
                                 **nms_opts):
    """Greedy NMS over score-sorted polygons: P1 suppresses P2 if
    overlap(P1, P2) = A_inter / min(A1, A2) > thresh. Returns bool survivors
    (a tensor for tensor input, else a numpy array). ``use_bbox``,
    ``use_kdtree`` and ``verbose`` are taken for calls written for the
    reference and change nothing; ``nms_opts`` as in the module docstring
    (``samples``: the fine grid's side, 16 by default)."""
    samples = _samples(nms_opts, 16)
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    points = as_tensor_on(points, dist.device)
    assert dist.dim() == 2 and points.dim() == 2 and points.shape[0] == dist.shape[0]
    keep = nms_polygons(dist.to(torch.float32), points.to(torch.float32),
                        thresh=float(thresh), stats=stats, samples=samples)
    return keep.cpu().numpy() if as_numpy else keep


def non_maximum_suppression_3d(dist, prob, rays, grid=(1, 1, 1), b=2, nms_thresh=0.5,
                               prob_thresh=0.5, use_bbox=True, use_kdtree=True, verbose=False,
                               *, stats=None, device="cuda", **nms_opts):
    """NMS of dense 3D predictions, dist (Nz, Ny, Nx, R) and prob (Nz, Ny,
    Nx): the candidates of :func:`_ind_prob_thresh`, in
    :func:`descending_order`, through the greedy polyhedron NMS, all on the
    device of ``dist`` (numpy inputs go to ``device``). ``use_bbox`` and
    ``use_kdtree`` change nothing, as in the reference; ``nms_opts`` as in
    the module docstring.

    Returns (points, prob, dist) of the survivors, in descending-prob order;
    points (int64) in full-resolution voxels (times ``grid``)."""
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    prob = as_tensor_on(prob, dist.device)
    assert prob.dim() == 3 and dist.dim() == 4 and dist.shape[-1] == len(rays) \
        and prob.shape == dist.shape[:3]
    probi, disti, points = _dense_candidates(dist, prob, _normalize_grid(grid, 3),
                                             prob_thresh, b)
    keep = non_maximum_suppression_3d_inds(disti, points, rays, scores=probi,
                                           thresh=nms_thresh, stats=stats, **nms_opts)
    if verbose:
        print("keeping %s/%s polyhedra" % (int(keep.sum()), len(keep)))
    out = points[keep], probi[keep], disti[keep]
    return tuple(t.cpu().numpy() for t in out) if as_numpy else out


def non_maximum_suppression_3d_sparse(dist, prob, points, rays, b=2, nms_thresh=0.5,
                                      use_kdtree=True, verbose=False, *, stats=None,
                                      device="cuda", **nms_opts):
    """NMS from sparse 3D candidate lists (``rays``: the model's ``Rays``;
    ``b`` and ``use_kdtree`` change nothing, as in the reference;
    ``nms_opts`` as in the module docstring).

    Returns (points, prob, dist, inds_original) of the survivors, in
    descending-prob order."""
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    prob = as_tensor_on(prob, dist.device)
    points = as_tensor_on(points, dist.device)
    assert dist.dim() == 2 and prob.dim() == 1 and points.dim() == 2 \
        and dist.shape[-1] == len(rays) and points.shape[-1] == 3 \
        and len(prob) == len(dist) == len(points)

    with span("stardist.nms.sort"):
        order = descending_order(prob)
        probi, disti, pointsi = prob[order], dist[order], points[order]
    keep = non_maximum_suppression_3d_inds(disti, pointsi, rays, scores=probi,
                                           thresh=nms_thresh, stats=stats, **nms_opts)
    if verbose:
        print("keeping %s/%s polyhedra" % (int(keep.sum()), len(keep)))
    out = pointsi[keep], probi[keep], disti[keep], order[keep]
    if as_numpy:
        out = tuple(t.cpu().numpy() for t in out)
    return out


def non_maximum_suppression_3d_inds(dist, points, rays, scores, thresh=0.5, use_bbox=True,
                                    use_kdtree=True, verbose=1, *, stats=None, device="cuda",
                                    **nms_opts):
    """Greedy NMS over 3D star polyhedra, sorted here by ``scores`` (the
    reference sorts again even when :func:`non_maximum_suppression_3d_sparse`
    has sorted already, which puts equal scores back in ascending list
    order). Returns bool survivors in the given order (a tensor for tensor
    input, else a numpy array). ``use_bbox``, ``use_kdtree`` and ``verbose``
    change nothing; ``nms_opts`` as in the module docstring (``samples``:
    the lattice's points per axis, 12 by default)."""
    samples = _samples(nms_opts, LATTICE_S)
    as_numpy = not isinstance(dist, torch.Tensor)
    dist = as_tensor_on(dist, device)
    points = as_tensor_on(points, dist.device)
    scores = as_tensor_on(scores, dist.device)
    assert dist.dim() == 2 and points.dim() == 2 and dist.shape[1] == len(rays) \
        and points.shape[0] == dist.shape[0] == scores.shape[0]
    with span("stardist.nms.sort"):
        ind = descending_order(scores)
        dist, points = dist[ind].to(torch.float32), points[ind].to(torch.float32)
    ray_dirs, faces = ray_tensors(rays, dist.device)
    survivors = torch.empty(len(ind), dtype=torch.bool, device=dist.device)
    survivors[ind] = nms_polyhedra(dist, points, ray_dirs, faces, thresh=float(thresh),
                                   stats=stats, samples=samples)
    return survivors.cpu().numpy() if as_numpy else survivors
