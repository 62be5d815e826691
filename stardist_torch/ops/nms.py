"""Greedy star-polygon and star-polyhedron NMS (counterpart of
``stardist_tpu/ops/nms.py::nms_polygons``, with the package-wide overlap
criterion of ``stardist_tpu/ops/nms2d_fast.py``, and of ``nms_polyhedra``).

Semantics (reference stardist/lib/stardist2d.cpp:390-615): candidates come
sorted by descending score; a kept candidate i suppresses every later j with
``overlap(i, j) > thresh``, where overlap = A_inter / min(A_i, A_j). The
decision for one pair is, in order:

1. no bbox intersection -> no suppression;
2. the analytic bounds of ``_bounds_block_2d`` (inscribed/outer-disc lens
   bounds and the bbox intersection) when they decide it;
3. otherwise the sampled cascade: the 8x8 midpoint-grid fraction decides
   when it is at least ``CASCADE_MARGIN`` from ``fstar``, else the fine
   grid's, ``samples`` x ``samples`` (16 by default, the reference's
   ``samples``); both through :func:`.pair_overlap.pair_frac`, which is
   the CUDA pair kernel on the GPU.

For N <= ``DENSE_MAX`` the reference skips step 2 (its dense path); so does
this port.

In 3D (:func:`nms_polyhedra`) the steps are the same with the reference's
3D rule: the ball-lens and bbox bounds of ``_bounds_block_3d``, then the
exact overlap of ``_overlap_block_3d``, the polyhedra's common voxels
counted on an integer lattice of at most S points per axis inside the
bbox intersection (``samples``: 12 by default, as the reference's host
NMS; its device path runs 10) and weighted by the lattice stride
(:mod:`.lattice_overlap`: ``csrc/lattice_overlap.cu`` on the GPU, though the
reference runs no Pallas kernel there); no bounds for N <= ``DENSE_MAX_3D``.

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

from ..core.profiling import span
from .lattice_overlap import LATTICE_S, lattice_counts, lattice_grid, lattice_points
from .pair_overlap import pair_frac
from .polygon import polygon_areas, polygon_bboxes
from .polyhedron import (polyhedron_bboxes, polyhedron_face_inverses, polyhedron_inner_radius,
                         polyhedron_volumes)

CASCADE_S = 8
CASCADE_MARGIN = 0.1
DENSE_MAX = 256
DENSE_MAX_3D = 32
LATTICE_BUDGET = 1024  # exact pairs per greedy round in 3D (CPU)
LATTICE_BUDGET_CUDA = 16384  # the same on a GPU, which runs more pairs at once
ROW_BLOCK = 512        # candidates per block of the 3D greedy


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


def _lens_volume_3d(r1, r2, d):
    """Intersection volume of two balls."""
    d = torch.clamp_min(d, 1e-6)
    rmin = torch.minimum(r1, r2)
    full = 4.0 / 3.0 * np.pi * (rmin * rmin * rmin)
    s = r1 + r2 - d
    lens = (np.pi * (s * s) * (d * d + 2 * d * (r1 + r2) - 3 * (r1 * r1 + r2 * r2)
                               + 6 * r1 * r2) / (12 * d))
    zero = torch.zeros_like(d)
    return torch.where(d >= r1 + r2, zero, torch.where(d <= torch.abs(r1 - r2), full, lens))


def _candidate_pairs(points, rout, rows=None):
    """All (i, j), i < j, i in ``rows`` (default: every candidate), whose
    centres are close enough for their bboxes to meet (|dp| <= rout_i +
    rout_j per axis): a cell grid of side 2*max(rout) + 1 over the 2 or 3
    axes, candidates paired with the 3^nd neighbouring cells."""
    N, nd = points.shape
    dev = points.device
    cell = float(2 * rout.max().item() + 1)
    cells = torch.floor(points / cell).long()
    cells = cells - cells.amin(dim=0) + 1
    dims = (cells.amax(dim=0) + 2).tolist()
    key = torch.zeros(N, dtype=torch.long, device=dev)
    strides = []
    for ax in range(nd):
        stride = int(np.prod(dims[ax + 1:]))
        key += cells[:, ax] * stride
        strides.append(stride)
    key_sorted, order = torch.sort(key, stable=True)
    if rows is None:
        rows = torch.arange(N, device=dev)
    i_all, j_all = [], []
    for shift in np.ndindex(*(3,) * nd):
        nkey = key[rows] + sum((o - 1) * st for o, st in zip(shift, strides))
        lo = torch.searchsorted(key_sorted, nkey, right=False)
        hi = torch.searchsorted(key_sorted, nkey, right=True)
        cnt = hi - lo
        i = torch.repeat_interleave(rows, cnt)
        starts = torch.repeat_interleave(lo, cnt)
        offs = torch.arange(i.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(cnt, 0) - cnt, cnt)
        j = order[starts + offs]
        sel = i < j
        i_all.append(i[sel])
        j_all.append(j[sel])
    return torch.cat(i_all), torch.cat(j_all)


def _resolve(N, i, j, sup, amb, exact, budget=None):
    """Greedy keep flags from a flat pair list: rounds of (a) the fixpoint
    over the known suppressions, undecided pairs counting as
    non-suppressing, and (b) ``exact(pair_idx)`` verdicts for the undecided
    pairs whose suppressor is currently kept.

    The loop ends when no undecided pair has a kept suppressor; the keep
    flags are then a fixpoint of the true suppression relation, which is
    unique, so they are the greedy result. Without ``budget`` every such
    pair is tested at once (one round, as a rule: the 2D NMS). With
    ``budget`` (the 3D NMS, whose exact test is dear), a round tests only
    pairs whose two candidates are both kept, and only those of the
    lowest-ranked suppressors, as many as fit in ``budget`` pairs (at least
    one suppressor's): the lowest-ranked one is final, so its tests are
    never wasted, and the candidates it kills drop out before their own
    pairs are tested; the loop then ends when no undecided pair joins two
    kept candidates, which again leaves the unique fixpoint. Returns (keep,
    exact pairs, rounds)."""
    keep = torch.ones(N, dtype=torch.bool, device=sup.device)
    n_eval = n_rounds = 0
    while True:
        with span("stardist.nms.round"):
            keep = _greedy_fixpoint(N, i, j, sup, keep)
            live = amb & keep[i]
            if budget is not None:
                live &= keep[j]
            todo = torch.nonzero(live).flatten()
            if todo.numel() == 0:
                return keep, n_eval, n_rounds
            if budget is not None and todo.numel() > budget:
                rows = i[todo]
                todo = todo[rows <= torch.sort(rows).values[budget - 1]]
            sup[todo] = exact(todo)
            amb[todo] = False
            n_eval += todo.numel()
            n_rounds += 1


def _greedy_fixpoint(N, i, j, sup, keep):
    """Unique fixpoint of keep[j] = not any(keep[i] & sup) over the pairs
    (i, j), i < j; Jacobi iteration from ``keep`` (any start converges)."""
    with span("stardist.nms.fixpoint"):
        i, j = i[sup], j[sup]
        while True:
            killed = torch.zeros(N, dtype=torch.bool, device=keep.device)
            killed[j[keep[i]]] = True
            new = ~killed
            if torch.equal(new, keep):
                return keep
            keep = new


def _cascade(dist, points, lo, hi, area, i, j, thresh, counts, samples):
    """Sampled-cascade verdicts (bool) for the pairs (i, j): the
    ``CASCADE_S`` grid, then the fine ``samples`` grid within
    ``CASCADE_MARGIN``; adds the number of pairs that the fine grid decides
    to ``counts["n_fine_pairs"]``."""
    with span("stardist.nms.cascade"):
        plo = torch.maximum(lo[i], lo[j])
        ext = torch.clamp_min(torch.minimum(hi[i], hi[j]) - plo, 0.0)
        fstar = (thresh * (torch.minimum(area[i], area[j]) + 1e-10)
                 / torch.clamp_min(ext[:, 0] * ext[:, 1], 1e-10))
        d_r, p_r, d_c, p_c = dist[i], points[i], dist[j], points[j]
        frac8 = pair_frac(d_r, p_r, d_c, p_c, plo, ext, S=CASCADE_S)
        sup = frac8 > fstar
        fine = torch.nonzero(torch.abs(frac8 - fstar) < CASCADE_MARGIN).flatten()
        counts["n_fine_pairs"] += fine.numel()
        if fine.numel():
            frac_fine = pair_frac(d_r[fine], p_r[fine], d_c[fine], p_c[fine],
                                  plo[fine], ext[fine], S=samples)
            sup[fine] = frac_fine > fstar[fine]
        return sup


def nms_polygons(dist, points, thresh=0.5, stats=None, samples=16):
    """Greedy NMS over score-sorted 2D star polygons.

    dist (N, R) f32, points (N, 2) (full-resolution row, col), both sorted
    by descending score and on one device; ``samples`` (>= 1) the fine
    grid's side. Returns keep (N,) bool on that device. ``stats``, if a
    dict, receives pair counts: bbox pairs, exact pairs (the S = 8 grid),
    those of them that the fine grid decides, and rounds."""
    N = dist.shape[0]
    dev = dist.device
    if N <= 1:
        return torch.ones(N, dtype=torch.bool, device=dev)
    dist = dist.to(torch.float32).contiguous()
    points = points.to(torch.float32).contiguous()
    thresh = float(thresh)
    with span("stardist.nms.geometry"):
        area = polygon_areas(dist)
        lo, hi = polygon_bboxes(dist, points)
        rout = torch.amax(dist, dim=-1)

    with span("stardist.nms.pairs"):
        i, j = _candidate_pairs(points, rout)
        ext = torch.clamp_min(torch.minimum(hi[i], hi[j]) - torch.maximum(lo[i], lo[j]), 0.0)
        meet = (ext[:, 0] > 0) & (ext[:, 1] > 0)
        i, j, ext = i[meet], j[meet], ext[meet]

    if N <= DENSE_MAX:
        sup = torch.zeros(i.numel(), dtype=torch.bool, device=dev)
        amb = torch.ones(i.numel(), dtype=torch.bool, device=dev)
    else:
        with span("stardist.nms.bounds"):
            rin = _inner_radius_2d(dist)
            dc = torch.sqrt(torch.sum((points[i] - points[j]) ** 2, dim=-1))
            denom = torch.minimum(area[i], area[j]) + 1e-10
            ub = torch.minimum(_lens_area_ub(rout[i], rout[j], dc),
                               ext[:, 0] * ext[:, 1]) / denom
            lb = _lens_area_lb(rin[i], rin[j], dc) / denom
            sup = lb > thresh
            amb = ~sup & ~(ub <= thresh)

    counts = {"n_fine_pairs": 0}
    keep, n_eval, n_rounds = _resolve(N, i, j, sup, amb, lambda t: _cascade(
        dist, points, lo, hi, area, i[t], j[t], thresh, counts, samples))
    if stats is not None:
        stats.update(n_candidates=N, n_pairs=int(i.numel()), n_eval_pairs=n_eval,
                     n_rounds=n_rounds, n_survivors=int(keep.sum().item()), **counts)
    return keep


def _lattice_overlap(points, lo, hi, vol, inv, valid, i, j, thresh, S, totals):
    """Exact-overlap verdicts (bool) for the polyhedron pairs (i, j): the
    common voxels counted on the integer lattice inside the bbox
    intersection (:func:`.lattice_overlap.lattice_counts`; ceil/floor of its
    corners, stride max(ceil(n_vox / S), 1) per axis, at most S points per
    axis), times the stride product, over min(volume) + 1e-10, against
    ``thresh``. Adds the pairs' lattice points and the points tested against
    j (those inside i) to ``totals`` (2,) int64, on the pairs' device."""
    plo, phi, stride = lattice_grid(lo, hi, i, j, S)
    counts = lattice_counts(points, inv, valid, i, j, plo, phi, stride, S)
    totals += torch.stack([lattice_points(plo, phi, stride, S).sum(), counts[:, 0].sum()])
    inter = counts[:, 1].float() * (stride[:, 0] * stride[:, 1] * stride[:, 2])
    return inter / (torch.minimum(vol[i], vol[j]) + 1e-10) > thresh


def nms_polyhedra(dist, points, ray_dirs, faces, thresh=0.5, stats=None, samples=LATTICE_S):
    """Greedy NMS over score-sorted 3D star polyhedra.

    dist (N, R) f32, points (N, 3) (full-resolution z, y, x), both sorted
    by descending score, and the rays' ``ray_dirs`` (R, 3) / ``faces``
    (F, 3), all on one device; ``samples`` (>= 1) the exact test's lattice
    points per axis. Returns keep (N,) bool on that device.
    ``stats``, if a dict, receives pair counts, ``exact_s``, the seconds
    spent in the exact lattice test (its ``stardist.nms.exact`` spans, each
    ended by a sync on the card), ``n_lattice_points``, the lattice points
    of every exact pair, and ``n_lattice_inside_first``, those of them
    inside the pair's first polyhedron (so tested against the second),
    both summed on the device and read with ``n_survivors``.

    The reference's blocked order (``_blocked_greedy``): blocks of the
    ``ROW_BLOCK`` lowest-ranked candidates not yet suppressed. Every
    candidate ranked before a block is decided, so the block's pairs with
    the later candidates near them (bounds first, exact tests through
    :func:`_resolve`) decide the block's rows and suppress later candidates
    for good; the suppressed ones never become rows. The pair list of one
    block stays small where the 3D model's large, overlapping polyhedra
    give each candidate thousands of bbox neighbours."""
    N = dist.shape[0]
    dev = dist.device
    counts = dict(n_candidates=N, n_pairs=0, n_eval_pairs=0, n_rounds=0, n_survivors=N,
                  exact_s=0.0, n_lattice_points=0, n_lattice_inside_first=0)
    if N <= 1:
        if stats is not None:
            stats.update(counts)
        return torch.ones(N, dtype=torch.bool, device=dev)
    dist = dist.to(torch.float32).contiguous()
    points = points.to(torch.float32).contiguous()
    ray_dirs = ray_dirs.to(dev, torch.float32)
    faces = faces.to(dev, torch.int64)
    thresh = float(thresh)
    dense = N <= DENSE_MAX_3D
    with span("stardist.nms.geometry"):
        vol = polyhedron_volumes(dist, ray_dirs, faces)
        lo, hi = polyhedron_bboxes(dist, points, ray_dirs)
        rout = torch.amax(dist, dim=-1)
        rin = None if dense else polyhedron_inner_radius(dist, ray_dirs, faces)
        inv, valid = polyhedron_face_inverses(dist, ray_dirs, faces)
    on_gpu = dev.type == "cuda"
    budget = LATTICE_BUDGET_CUDA if on_gpu else LATTICE_BUDGET
    totals = torch.zeros(2, dtype=torch.int64, device=dev)

    def exact(i, j):
        with span("stardist.nms.exact", counts, "exact_s"):
            out = _lattice_overlap(points, lo, hi, vol, inv, valid, i, j, thresh, samples,
                                   totals)
            if on_gpu:
                torch.cuda.synchronize(dev)
        return out

    suppressed = torch.zeros(N, dtype=torch.bool, device=dev)
    pos = 0
    while pos < N:
        with span("stardist.nms.block"):
            rows = torch.nonzero(~suppressed[pos:]).flatten()[:ROW_BLOCK] + pos
            if rows.numel() == 0:
                break
            with span("stardist.nms.pairs"):
                i, j = _candidate_pairs(points, rout, rows)
                live = ~suppressed[j]
                i, j = i[live], j[live]
            if dense:
                sup = torch.zeros(i.numel(), dtype=torch.bool, device=dev)
                amb = torch.ones(i.numel(), dtype=torch.bool, device=dev)
            else:
                with span("stardist.nms.bounds"):
                    ext = torch.clamp_min(torch.minimum(hi[i], hi[j])
                                          - torch.maximum(lo[i], lo[j]), 0.0)
                    dc = torch.sqrt(torch.sum((points[i] - points[j]) ** 2, dim=-1))
                    denom = torch.minimum(vol[i], vol[j]) + 1e-10
                    ub = torch.minimum(_lens_volume_3d(rout[i], rout[j], dc),
                                       ext[:, 0] * ext[:, 1] * ext[:, 2]) / denom
                    lb = _lens_volume_3d(rin[i], rin[j], dc) / denom
                    sup = lb > thresh
                    amb = ~sup & ~(ub <= thresh)
                    # pairs the bounds decide as not suppressing leave the list
                    live = sup | amb
                    i, j, sup, amb = i[live], j[live], sup[live], amb[live]
            keep, n_eval, n_rounds = _resolve(N, i, j, sup, amb,
                                              lambda t: exact(i[t], j[t]), budget)
            suppressed |= ~keep
            counts["n_pairs"] += int(i.numel())
            counts["n_eval_pairs"] += n_eval
            counts["n_rounds"] += n_rounds
            pos = int(rows[-1].item()) + 1
    counts["n_survivors"], counts["n_lattice_points"], counts["n_lattice_inside_first"] = \
        torch.cat([(~suppressed).sum()[None], totals]).tolist()
    if stats is not None:
        stats.update(counts)
    return ~suppressed
