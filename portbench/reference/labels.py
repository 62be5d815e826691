"""Comparisons of two label images (any dimension), plain PyTorch."""
from __future__ import annotations

import torch


def _pairs(a, b):
    """The (label in a, label in b, pixel count) of every pair that meets on
    a pixel where a or b is foreground."""
    a, b = a.reshape(-1).long(), b.reshape(-1).long()
    fg = (a > 0) | (b > 0)
    a, b = a[fg], b[fg]
    nb = int(b.max()) + 1 if b.numel() else 1
    key, cnt = torch.unique(a * nb + b, return_counts=True)
    return key // nb, key % nb, cnt


def differing_pixels(a, b):
    """Foreground pixels on which a and b disagree, up to a renaming of the
    labels: a pixel agrees when its pair of labels is each label's
    best-overlapping partner in the other image."""
    pa, pb, cnt = _pairs(a, b)
    if cnt.numel() == 0:
        return 0
    best_a = torch.zeros(int(pa.max()) + 1, dtype=cnt.dtype, device=cnt.device)
    best_a.scatter_reduce_(0, pa, cnt, reduce="amax")
    best_b = torch.zeros(int(pb.max()) + 1, dtype=cnt.dtype, device=cnt.device)
    best_b.scatter_reduce_(0, pb, cnt, reduce="amax")
    agree = (pa > 0) & (pb > 0) & (cnt == best_a[pa]) & (cnt == best_b[pb])
    return int(cnt.sum() - cnt[agree].sum())


def iou_deficit(a, b):
    """1 - the mean, over the objects of a and of b, of each object's best
    IoU with an object of the other image (0 for one that meets none)."""
    pa, pb, cnt = _pairs(a, b)
    area_a = torch.bincount(a.reshape(-1).long())
    area_b = torch.bincount(b.reshape(-1).long())
    n = int((area_a[1:] > 0).sum()) + int((area_b[1:] > 0).sum())
    if n == 0:
        return 0.0
    both = (pa > 0) & (pb > 0)
    pa, pb, cnt = pa[both], pb[both], cnt[both]
    j = cnt.double() / (area_a[pa] + area_b[pb] - cnt).double()
    best_a = torch.zeros(len(area_a), dtype=j.dtype, device=j.device)
    best_a.scatter_reduce_(0, pa, j, reduce="amax")
    best_b = torch.zeros(len(area_b), dtype=j.dtype, device=j.device)
    best_b.scatter_reduce_(0, pb, j, reduce="amax")
    return 1.0 - float(best_a.sum() + best_b.sum()) / n
