"""Label-image rasterization of star polygons (counterpart of
``stardist_tpu/ops/rasterize.py::rasterize_polygons`` / ``_raster2d_impl``).

Splatting: every polygon tests a fixed square window around its centre
(the atan2-wedge inside test of :func:`.polygon.points_in_polygons`) and a
scatter-max over the packed ``(order << 32) | label`` resolves the winner
and its label per pixel in one pass, so "later in the rendering order wins"
becomes a max (packed in int64, so the order values have no 2^15 limit).
Plain torch ops on any device (the reference leaves this stage to XLA too).
"""
from __future__ import annotations

import numpy as np
import torch

from .polygon import points_in_polygons


CHUNK = 1024  # polygons per scatter step (bounds the (chunk, window^2) temporaries)


def raster_window(dmax, shape):
    """Splat window: 2*ceil(max dist)+4, capped by the image, rounded up to
    a multiple of 16."""
    window = 2 * int(np.ceil(float(dmax))) + 4
    window = int(min(window, 2 * max(shape) + 4))
    return -(-window // 16) * 16


def rasterize_polygons(dist, points, shape, order_values, labels=None):
    """Per pixel, the polygon with the largest positive order value wins.

    dist (N, R), points (N, 2), order_values (N,) int (0 = never drawn);
    all tensors on one device. Returns an int32 (H, W) tensor on that
    device: the winner's ``labels[i] + 1`` (or its order value when
    ``labels`` is None), 0 for background."""
    dev = dist.device
    H, W = (int(s) for s in shape)
    N = dist.shape[0]
    img = torch.zeros(H * W, dtype=torch.int64, device=dev)
    if N == 0:
        return img.view(H, W).to(torch.int32)
    dist = dist.to(torch.float32)
    points = points.to(torch.float32)
    order_values = order_values.to(dev, torch.int64)
    labs = order_values if labels is None else labels.to(dev, torch.int64) + 1
    packed = (order_values << 32) | labs
    window = raster_window(dist.max().item(), shape)
    ar = torch.arange(window, dtype=torch.int32, device=dev)
    for i0 in range(0, N, CHUNK):
        d = dist[i0:i0 + CHUNK]
        p = points[i0:i0 + CHUNK]
        v = order_values[i0:i0 + CHUNK]
        pk = packed[i0:i0 + CHUNK]
        n = d.shape[0]
        start = torch.round(p).to(torch.int32) - window // 2
        rr = start[:, 0:1] + ar[None]                     # (n, Wn)
        cc = start[:, 1:2] + ar[None]
        q = torch.stack(torch.broadcast_tensors(
            rr[:, :, None].float(), cc[:, None, :].float()), dim=-1).reshape(n, -1, 2)
        inside = points_in_polygons(d, p, q) & (v > 0)[:, None]
        in_img = (((rr >= 0) & (rr < H))[:, :, None]
                  & ((cc >= 0) & (cc < W))[:, None, :]).reshape(n, -1)
        inside = inside & in_img
        flat = (rr.long()[:, :, None] * W + cc.long()[:, None, :]).reshape(n, -1)
        vals = pk[:, None].expand_as(flat)
        img.scatter_reduce_(0, flat[inside], vals[inside], reduce="amax")
    return (img & 0xFFFFFFFF).to(torch.int32).view(H, W)
