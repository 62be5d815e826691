"""Greedy star-polygon NMS (counterpart of ``stardist_tpu/ops/nms.py::
nms_polygons`` with the package-wide overlap criterion of
``stardist_tpu/ops/nms2d_fast.py``).

Semantics (reference stardist/lib/stardist2d.cpp:390-615): candidates come
sorted by descending score; a kept candidate i suppresses every later j with
``overlap(i, j) > thresh``, where overlap = A_inter / min(A_i, A_j). The
decision for one pair is, in order:

1. no bbox intersection -> no suppression;
2. the analytic bounds of ``_bounds_block_2d`` (inscribed/outer-disc lens
   bounds and the bbox intersection) when they decide it;
3. otherwise the sampled cascade: the 8x8 midpoint-grid fraction decides
   when it is at least ``CASCADE_MARGIN`` from ``fstar``, else the 16x16
   fraction decides; both through :func:`.pair_overlap.pair_frac`, which is
   the CUDA pair kernel on the GPU.

For N <= ``DENSE_MAX`` the reference skips step 2 (its dense path); so does
this port.

The greedy result is the unique fixpoint of keep[j] = not any(keep[i] and
sup(i, j), i < j), so any evaluation order gives the same keep flags as the
reference's blocked host loop. The GPU form works on one flat list of the
pairs whose bboxes intersect (found with a cell grid): bounds decide most
pairs at once; then rounds of (a) the fixpoint over the known suppressions,
treating undecided pairs as non-suppressing, and (b) the exact cascade for
the undecided pairs whose suppressor is currently kept, until no kept
candidate has an undecided pair. Killed candidates suppress nothing, so the
pairs of candidates that end up suppressed need no exact test.
"""
from __future__ import annotations

import numpy as np
import torch

from .pair_overlap import pair_frac
from .polygon import polygon_areas, polygon_bboxes

CASCADE_S = 8
CASCADE_MARGIN = 0.1
DENSE_MAX = 256


def _lens_area_lb(r1, r2, d):
    """Lower bound of the disc-intersection area (largest inscribed disc)."""
    rho = torch.clamp_min(torch.minimum((r1 + r2 - d) * 0.5, torch.minimum(r1, r2)), 0.0)
    return np.pi * rho * rho


def _lens_area_ub(r1, r2, d):
    """Upper bound of the disc-intersection area (see ``_lens_area_ub`` of
    the reference for why the chord is used only between the centres)."""
    rmin = torch.minimum(r1, r2)
    w = torch.clamp_min(r1 + r2 - d, 0.0)
    d_safe = torch.clamp_min(d, 1e-6)
    x1 = (d_safe * d_safe + r1 * r1 - r2 * r2) / (2 * d_safe)
    h_chord = 2.0 * torch.sqrt(torch.clamp_min(r1 * r1 - x1 * x1, 0.0))
    h = torch.where((x1 >= 0.0) & (x1 <= d_safe), h_chord, 2.0 * rmin)
    return torch.minimum(w * h, np.pi * rmin * rmin)


def _inner_radius_2d(dist):
    """Lower bound of the polygon inradius: min distance from the centre to
    any edge's supporting line."""
    R = dist.shape[-1]
    dphi = 2 * np.pi / R
    d0 = dist
    d1 = torch.roll(dist, -1, dims=-1)
    chord = torch.sqrt(torch.clamp_min(d0 ** 2 + d1 ** 2 - 2 * d0 * d1 * np.cos(dphi), 1e-12))
    return torch.amin(d0 * d1 * np.sin(dphi) / chord, dim=-1)


def _candidate_pairs(points, rout):
    """All (i, j), i < j, whose centres are close enough for their bboxes
    to meet (|dp| < rout_i + rout_j per axis): a cell grid of side
    2*max(rout) + 1, candidates paired with the 3x3 neighbouring cells."""
    N = points.shape[0]
    dev = points.device
    cell = float(2 * rout.max().item() + 1)
    cr = torch.floor(points[:, 0] / cell).long()
    cc = torch.floor(points[:, 1] / cell).long()
    cr = cr - cr.min()
    cc = cc - cc.min()
    ncol = int(cc.max().item()) + 3
    key = (cr + 1) * ncol + (cc + 1)
    key_sorted, order = torch.sort(key, stable=True)
    i_all, j_all = [], []
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            nkey = key + dr * ncol + dc
            lo = torch.searchsorted(key_sorted, nkey, right=False)
            hi = torch.searchsorted(key_sorted, nkey, right=True)
            cnt = hi - lo
            i = torch.repeat_interleave(torch.arange(N, device=dev), cnt)
            starts = torch.repeat_interleave(lo, cnt)
            offs = torch.arange(i.numel(), device=dev) - torch.repeat_interleave(
                torch.cumsum(cnt, 0) - cnt, cnt)
            j = order[starts + offs]
            sel = i < j
            i_all.append(i[sel])
            j_all.append(j[sel])
    return torch.cat(i_all), torch.cat(j_all)


def _greedy_fixpoint(N, i, j, sup, keep):
    """Unique fixpoint of keep[j] = not any(keep[i] & sup) over the pairs
    (i, j), i < j; Jacobi iteration from ``keep`` (any start converges)."""
    i, j = i[sup], j[sup]
    while True:
        killed = torch.zeros(N, dtype=torch.bool, device=keep.device)
        killed[j[keep[i]]] = True
        new = ~killed
        if torch.equal(new, keep):
            return keep
        keep = new


def _cascade(dist, points, lo, hi, area, i, j, thresh):
    """Sampled-cascade verdicts (bool) for the pairs (i, j)."""
    plo = torch.maximum(lo[i], lo[j])
    ext = torch.clamp_min(torch.minimum(hi[i], hi[j]) - plo, 0.0)
    fstar = (thresh * (torch.minimum(area[i], area[j]) + 1e-10)
             / torch.clamp_min(ext[:, 0] * ext[:, 1], 1e-10))
    d_r, p_r, d_c, p_c = dist[i], points[i], dist[j], points[j]
    frac8 = pair_frac(d_r, p_r, d_c, p_c, plo, ext, S=CASCADE_S)
    sup = frac8 > fstar
    fine = torch.nonzero(torch.abs(frac8 - fstar) < CASCADE_MARGIN).flatten()
    if fine.numel():
        frac16 = pair_frac(d_r[fine], p_r[fine], d_c[fine], p_c[fine],
                           plo[fine], ext[fine], S=16)
        sup[fine] = frac16 > fstar[fine]
    return sup


def nms_polygons(dist, points, thresh=0.5, stats=None):
    """Greedy NMS over score-sorted 2D star polygons.

    dist (N, R) f32, points (N, 2) (full-resolution row, col), both sorted
    by descending score and on one device. Returns keep (N,) bool on that
    device. ``stats``, if a dict, receives pair counts."""
    N = dist.shape[0]
    dev = dist.device
    if N <= 1:
        return torch.ones(N, dtype=torch.bool, device=dev)
    dist = dist.to(torch.float32).contiguous()
    points = points.to(torch.float32).contiguous()
    thresh = float(thresh)
    area = polygon_areas(dist)
    lo, hi = polygon_bboxes(dist, points)
    rout = torch.amax(dist, dim=-1)

    i, j = _candidate_pairs(points, rout)
    ext = torch.clamp_min(torch.minimum(hi[i], hi[j]) - torch.maximum(lo[i], lo[j]), 0.0)
    meet = (ext[:, 0] > 0) & (ext[:, 1] > 0)
    i, j, ext = i[meet], j[meet], ext[meet]

    if N <= DENSE_MAX:
        sup = torch.zeros(i.numel(), dtype=torch.bool, device=dev)
        amb = torch.ones(i.numel(), dtype=torch.bool, device=dev)
    else:
        rin = _inner_radius_2d(dist)
        dc = torch.sqrt(torch.sum((points[i] - points[j]) ** 2, dim=-1))
        denom = torch.minimum(area[i], area[j]) + 1e-10
        ub = torch.minimum(_lens_area_ub(rout[i], rout[j], dc),
                           ext[:, 0] * ext[:, 1]) / denom
        lb = _lens_area_lb(rin[i], rin[j], dc) / denom
        sup = lb > thresh
        amb = ~sup & ~(ub <= thresh)

    keep = torch.ones(N, dtype=torch.bool, device=dev)
    n_eval = n_rounds = 0
    while True:
        keep = _greedy_fixpoint(N, i, j, sup, keep)
        todo = torch.nonzero(amb & keep[i]).flatten()
        if todo.numel() == 0:
            break
        sup[todo] = _cascade(dist, points, lo, hi, area, i[todo], j[todo], thresh)
        amb[todo] = False
        n_eval += todo.numel()
        n_rounds += 1
    if stats is not None:
        stats.update(n_candidates=N, n_pairs=int(i.numel()), n_eval_pairs=n_eval,
                     n_rounds=n_rounds, n_survivors=int(keep.sum().item()))
    return keep
