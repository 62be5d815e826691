"""Greedy non-maximum suppression, plain PyTorch.

Candidates come sorted by descending score. Candidate j survives unless an
earlier survivor i suppresses it: their overlap is above the threshold.
Two boxes that do not meet never suppress. ``shapes.bounds(i, j)`` gives
(suppresses, undecided) for pairs, from bounds of the overlap where the
shapes have them; ``shapes.exact(i, j)`` decides a pair.

The loop takes the next ``shapes.block`` candidates still alive; everything
before them is decided. Inside the block the survivors are the unique
fixpoint of keep[j] = not any(keep[i] and sup(i, j), i < j), found with
the undecided pairs taken as not suppressing, then again after deciding
the undecided pairs whose two candidates are both kept, until none is
left; then the block's survivors suppress every later candidate they
overlap, the pairs the bounds leave undecided in steps that skip the
candidates already suppressed.
"""
from __future__ import annotations

import torch


def boxes_meet(lo, hi, i, j):
    """The boxes of i and j overlap with a positive extent on every axis."""
    ext = torch.minimum(hi[i], hi[j]) - torch.maximum(lo[i], lo[j])
    return torch.all(ext > 0, dim=-1)


def _fixpoint(n, a, b, dev):
    kb = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(n + 1):
        new = torch.ones(n, dtype=torch.bool, device=dev)
        new[b[kb[a]]] = False
        if torch.equal(new, kb):
            break
        kb = new
    return kb


def greedy(shapes, chunk=64, step=2048):
    """keep (N,) bool of the N candidates of ``shapes`` (with boxes
    ``shapes.lo``, ``shapes.hi`` (N, d))."""
    lo, hi, block = shapes.lo, shapes.hi, shapes.block
    N, dev = lo.shape[0], lo.device
    keep = torch.zeros(N, dtype=torch.bool, device=dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    pos = 0
    while pos < N:
        rows = torch.nonzero(alive[pos:]).flatten()[:block] + pos
        n = rows.numel()
        if n == 0:
            break
        a, b = torch.triu_indices(n, n, 1, device=dev)
        meet = boxes_meet(lo, hi, rows[a], rows[b])
        a, b = a[meet], b[meet]
        sup, amb = shapes.bounds(rows[a], rows[b])
        while True:
            kb = _fixpoint(n, a[sup], b[sup], dev)
            need = torch.nonzero(amb & kb[a] & kb[b]).flatten()
            if need.numel() == 0:
                break
            sup[need] = shapes.exact(rows[a[need]], rows[b[need]])
            amb[need] = False
        kept = rows[kb]
        keep[kept] = True
        alive[rows] = False
        pos = int(rows[-1]) + 1
        later = torch.nonzero(alive[pos:]).flatten() + pos
        if later.numel() == 0 or kept.numel() == 0:
            continue
        undecided = []
        for c0 in range(0, kept.numel(), chunk):
            k = kept[c0:c0 + chunk]
            ext = (torch.minimum(hi[k][:, None], hi[later][None])
                   - torch.maximum(lo[k][:, None], lo[later][None]))
            ii, jj = torch.nonzero(torch.all(ext > 0, dim=-1), as_tuple=True)
            sup, amb = shapes.bounds(k[ii], later[jj])
            alive[later[jj[sup]]] = False
            undecided.append((k[ii[amb]], later[jj[amb]]))
        i = torch.cat([u[0] for u in undecided])
        j = torch.cat([u[1] for u in undecided])
        while i.numel():
            i, j = i[alive[j]], j[alive[j]]
            s = shapes.exact(i[:step], j[:step])
            alive[j[:step][s]] = False
            i, j = i[step:], j[step:]
    return keep
