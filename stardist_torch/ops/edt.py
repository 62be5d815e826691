"""Exact Euclidean distance transform of label images, as object
probabilities (counterpart of ``stardist_tpu/ops/edt.py``).

For each label ``l`` of a patch: the distance of every pixel of ``l`` to the
nearest pixel of the patch not labeled ``l``, over the largest such distance
of ``l``; background 0. The squared distances come from the separable
min-plus form, per axis ``D(i) = min_j f(j) + (i - j)^2``, one-vs-rest over
the patch's labels, in float32 as the reference computes them. The
reference's compiler fuses the (labels, *sp, n) sum of each axis into the
min; eager PyTorch writes it out, so the labels go through in chunks that
keep it within a fixed budget, and the lines of one axis go through in
chunks too when one label's sum alone exceeds it (a 128^3 patch: 2^21 lines
of 128, 1 GiB). Each pixel takes its value from the one label it carries,
and a min is the same however its lines are grouped, so the chunking
changes no sum.
"""
from __future__ import annotations

import math

import torch

_INF = 1e12
_BUDGET = 1 << 26    # float32 elements of one chunk's (labels, *sp, n) sum


def _minplus_axis(f, axis, spacing):
    """Exact 1D squared EDT along ``axis`` of f (squared distances); the
    lines go through in chunks of at most ``_BUDGET`` summed elements."""
    n = f.shape[axis]
    i = torch.arange(n, dtype=torch.float32, device=f.device)
    d2 = ((i[:, None] - i[None, :]) * spacing) ** 2
    f = f.movedim(axis, -1)
    lines = f.reshape(-1, n)
    rows = max(1, _BUDGET // (n * n))
    if rows >= lines.shape[0]:
        out = (lines[:, None, :] + d2).amin(-1)
    else:
        out = torch.empty_like(lines)
        for r0 in range(0, lines.shape[0], rows):
            out[r0:r0 + rows] = (lines[r0:r0 + rows, None, :] + d2).amin(-1)
    return out.view(f.shape).movedim(-1, axis)


def edt_prob_batch(lbl, labels, spacing=None):
    """Normalized EDT of integer labels ``lbl`` (B, *sp) for the labels
    ``labels`` (B, L) of each patch (0 pads a list; only labels > 0 count)
    -> float32 (B, *sp) on their device."""
    B, sp = lbl.shape[0], tuple(lbl.shape[1:])
    nd = len(sp)
    spacing = (1.0,) * nd if spacing is None else tuple(float(s) for s in spacing)
    L = labels.shape[1]
    lab = labels.reshape(-1)
    owner = torch.arange(B, device=lbl.device)[:, None].expand(B, L).reshape(-1)
    chunk = max(1, _BUDGET // (math.prod(sp) * max(sp)))
    view = (-1,) + (1,) * nd
    parts = []
    for c0 in range(0, B * L, chunk):
        lb = lab[c0:c0 + chunk]
        mask = lbl[owner[c0:c0 + chunk]] == lb.view(view)
        f = torch.where(mask, _INF, 0.0)
        for ax in range(nd):
            f = _minplus_axis(f, ax + 1, spacing[ax])
        d = torch.sqrt(f.clamp_min(0.0))
        dmax = torch.where(mask, d, 0.0).amax(dim=tuple(range(1, nd + 1)), keepdim=True)
        parts.append(torch.where(mask & (lb > 0).view(view), d / (dmax + 1e-10), 0.0))
    return torch.cat(parts).view((B, L) + sp).sum(1)


def edt_prob_core(lbl, labels, spacing=None):
    """One patch: ``lbl`` (*sp), ``labels`` (L,) -> float32 (*sp); the
    reference's ``edt_prob_core``."""
    return edt_prob_batch(lbl[None], labels[None], spacing)[0]
