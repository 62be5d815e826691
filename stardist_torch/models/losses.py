"""Training losses and metrics (counterpart of
``stardist_tpu/models/losses.py``, itself the reference's Keras losses).

Masked distance losses (mae / mse / iou) with a background regularizer and
mask normalization, the BCE probability loss where ``y_true == -1`` turns
the loss off, the weighted categorical cross-entropy of multiclass models,
and the kld / relevant_mae / relevant_mse / dist_iou metrics. The gradients
at ties follow the reference's: the clips and the elementwise min / max are
``torch.minimum`` / ``torch.maximum``, which split a tie in half, and
``|x|`` has the slope 1 at 0 (``torch.abs`` has 0 there).

Each function takes ``shard``, a :class:`Shard`, when its inputs are one
rank's rows of a batch split over data-parallel ranks: it then divides by
the whole batch's normalizers and returns its rows' share of the whole
batch's value, so that the ranks' values (and gradients) sum to those of
the whole batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-7  # Keras epsilon


def _const(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)   # a fill: no host copy


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, _const(lo, x)), _const(hi, x))


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _bce(y_true, y_pred):
    p = _clip(y_pred, _EPS, 1 - _EPS)
    return -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p))


class Shard(NamedTuple):
    """The whole batch's normalizers for a loss on some of its rows: the
    count of its prob pixels with y_true >= 0 (``prob_mask_sum``), the mean
    of its dist mask (``dist_mask_mean``), both 0-d tensors, and the rows'
    fraction of the batch (``share``)."""
    prob_mask_sum: torch.Tensor
    dist_mask_mean: torch.Tensor
    share: float


def _masked_mean(v, mask, shard=None):
    total = torch.sum(mask) if shard is None else shard.prob_mask_sum
    return torch.sum(v * mask) / torch.clamp_min(total, 1.0)


def _mean(v, shard=None):
    return torch.mean(v) if shard is None else torch.mean(v) * shard.share


def prob_loss(y_true, y_pred, shard=None):
    """BCE over the pixels with y_true >= 0 (y_true == -1 disables the loss)."""
    mask = (y_true >= 0).to(y_pred.dtype)
    return _masked_mean(_bce(torch.clamp_min(y_true, 0.0), y_pred), mask, shard)


def kld_metric(y_true, y_pred, shard=None):
    """KL-divergence-style prob metric."""
    mask = (y_true >= 0).to(y_pred.dtype)
    t = _clip(y_true, _EPS, 1.0)
    p = _clip(y_pred, _EPS, 1.0)
    return _masked_mean(_bce(t, p) - _bce(t, t), mask, shard)


def _generic_masked(mask, loss_map, reg_weight, reg_map, norm_by_mask=True, shard=None):
    """Per-pixel channel mean of mask * loss over the global mask mean, plus
    an optional background regularizer on (1 - mask)."""
    out = torch.mean(mask * loss_map, dim=-1)
    if norm_by_mask:
        out = out / ((torch.mean(mask) if shard is None else shard.dist_mask_mean) + _EPS)
    if reg_weight > 0:
        out = out + reg_weight * torch.mean((1 - mask) * reg_map, dim=-1)
    return _mean(out, shard)


def dist_loss(dist_true, dist_mask, dist_pred, kind="mae", reg_weight=0.0, shard=None):
    """Masked distance loss; dist_mask is the (0..1) EDT-prob weight map of
    shape (..., 1), broadcast over the rays."""
    diff = dist_true - dist_pred
    if kind == "mae":
        loss_map = _abs(diff)
    elif kind == "mse":
        loss_map = torch.square(diff)
    elif kind == "iou":
        inter = torch.mean(torch.sign(dist_pred) * torch.square(torch.minimum(dist_true, dist_pred)),
                           dim=-1)
        union = torch.mean(torch.square(torch.maximum(dist_true, dist_pred)), dim=-1)
        loss_map = (1.0 - inter / (union + _EPS))[..., None]
    else:
        raise ValueError(f"unknown dist loss '{kind}'")
    return _generic_masked(dist_mask, loss_map, reg_weight, _abs(dist_pred), shard=shard)


def dist_iou_metric(dist_true, dist_mask, dist_pred, shard=None):
    pred = torch.maximum(_const(0.0, dist_pred), dist_pred)
    inter = torch.mean(torch.square(torch.minimum(dist_true, pred)), dim=-1)
    union = torch.mean(torch.square(torch.maximum(dist_true, pred)), dim=-1)
    return _generic_masked(dist_mask, (inter / (union + _EPS))[..., None], 0.0, None, shard=shard)


def relevant_mae(dist_true, dist_mask, dist_pred, shard=None):
    return _generic_masked(dist_mask, _abs(dist_true - dist_pred), 0.0, None, shard=shard)


def relevant_mse(dist_true, dist_mask, dist_pred, shard=None):
    return _generic_masked(dist_mask, torch.square(dist_true - dist_pred), 0.0, None,
                           shard=shard)


def class_loss(y_true, y_pred, class_weights, shard=None):
    """Weighted categorical cross-entropy; y_true < 0 is ignored."""
    w = torch.as_tensor(class_weights, dtype=y_pred.dtype, device=y_pred.device)
    mask = (y_true >= 0).to(y_pred.dtype)
    p = y_pred / torch.sum(y_pred + _EPS, dim=-1, keepdim=True)
    p = _clip(p, _EPS, 1 - _EPS)
    loss = -torch.sum(w * mask * torch.clamp_min(y_true, 0.0) * torch.log(p), dim=-1)
    return _mean(loss, shard)
