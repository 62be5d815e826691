"""StarDist 2D and 3D U-Net for inference (counterpart of ``stardist_tpu/
models/unet.py::StarDistNet`` and its inference form ``models/unet_chw.py::
chw_forward``).

Activations are channels-last, ``(H, W, C)`` or ``(D, H, W, C)``, so that
every 3x3 (3x3x3) conv reads and writes them without a transpose. The
topology mirrors the flax call order exactly — grid pre-pooling convs, the
csbdeep U-Net backbone (max-pool, nearest upsample, skip concat), the
feature conv, and the fused 1+R head — and the outputs keep the reference's
contract: ``prob (*sp')`` and ``dist (R, *sp')`` float32, channel-major.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.conv import (ACTS, conv3x3_hwc, conv3x3_hwc_plain, conv3x3x3_dhwc,
                        conv3x3x3_dhwc_plain)


_CONVS = {2: (conv3x3_hwc, conv3x3_hwc_plain), 3: (conv3x3x3_dhwc, conv3x3x3_dhwc_plain)}


class ConvBlock(nn.Module):
    """3x3 (3x3x3) SAME conv + bias + activation; weight in the flax HWIO
    (DHWIO) layout."""

    def __init__(self, c_in, c_out, act="relu", n_dim=2):
        super().__init__()
        act = str(act).lower()
        if act not in ACTS:
            raise NotImplementedError(f"activation {act!r} has no conv kernel epilogue")
        self.act = act
        self.weight = nn.Parameter(torch.zeros((3,) * n_dim + (c_in, c_out)),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c_out), requires_grad=False)
        self.kernel, self.plain = _CONVS[n_dim]

    def forward(self, h, plain=False):
        conv = self.plain if plain else self.kernel
        return conv(h, self.weight, self.bias, self.act)


def max_pool(h, pool):
    """Max-pool channels-last (*sp, C) by ``pool`` (one factor per spatial
    dim); each spatial size is a multiple of its factor."""
    if all(p == 1 for p in pool):
        return h
    shape = []
    for s, p in zip(h.shape[:-1], pool):
        shape += [s // p, p]
    return h.view(*shape, h.shape[-1]).amax(dim=tuple(range(1, 2 * len(pool), 2)))


def upsample(h, pool):
    """Nearest-neighbour upsampling of channels-last (*sp, C) by ``pool``."""
    for ax, p in enumerate(pool):
        if p > 1:
            h = h.repeat_interleave(p, dim=ax)
    return h


class StarDistNet(nn.Module):
    """2D or 3D StarDist network with a U-Net backbone (inference only).

    ``dtype`` is the activation type of the convs: ``torch.bfloat16`` (the
    CUDA kernel's type and the reference's TPU inference type) or
    ``torch.float32``, whose convs are always the plain PyTorch versions
    (on CUDA too: the kernels take bfloat16 only)."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        c = config
        nd = self.n_dim = int(c.n_dim)
        if c.backbone != "unet" or tuple(c.unet_kernel_size) != (3,) * nd or c.unet_batch_norm:
            raise NotImplementedError(
                "only the U-Net backbone with 3x3 (3x3x3) kernels and no batch norm is ported")
        if c.n_classes is not None:
            raise NotImplementedError("multiclass heads are not ported yet")
        self.grid = tuple(int(g) for g in c.grid)
        self.n_rays = int(c.n_rays)
        self.n_depth = int(c.unet_n_depth)
        self.n_conv = int(c.unet_n_conv_per_depth)
        self.pool = tuple(int(p) for p in c.unet_pool)
        self.dtype = dtype
        act, last_act = c.unet_activation, c.unet_last_activation
        base = int(c.unet_n_filter_base)

        # grid pre-pooling (unet.py StarDistNet.__call__)
        top, self.prepools = [], []
        ch = int(c.n_channel_in)
        pooled = np.ones(nd, int)
        while tuple(pooled) != self.grid:
            p = 1 + (np.asarray(self.grid) > pooled)
            pooled *= p
            for _ in range(self.n_conv):
                top.append(ConvBlock(ch, base, act, nd))
                ch = base
            self.prepools.append(tuple(int(v) for v in p))

        # backbone (unet.py UNetBackbone.__call__)
        bb, skip_ch = [], []
        for n in range(self.n_depth):
            for _ in range(self.n_conv):
                bb.append(ConvBlock(ch, base * 2 ** n, act, nd))
                ch = base * 2 ** n
            skip_ch.append(ch)
        for _ in range(self.n_conv - 1):
            bb.append(ConvBlock(ch, base * 2 ** self.n_depth, act, nd))
            ch = base * 2 ** self.n_depth
        bb.append(ConvBlock(ch, base * 2 ** max(0, self.n_depth - 1), act, nd))
        ch = base * 2 ** max(0, self.n_depth - 1)
        for n in reversed(range(self.n_depth)):
            ch = ch + skip_ch[n]
            for _ in range(self.n_conv - 1):
                bb.append(ConvBlock(ch, base * 2 ** n, act, nd))
                ch = base * 2 ** n
            bb.append(ConvBlock(ch, base * 2 ** max(0, n - 1), act if n > 0 else last_act, nd))
            ch = base * 2 ** max(0, n - 1)

        self.n_feat = int(c.net_conv_after_unet)
        if self.n_feat > 0:
            top.append(ConvBlock(ch, self.n_feat, act, nd))
            ch = self.n_feat
        self.top = nn.ModuleList(top)
        self.backbone = nn.ModuleList(bb)
        self.head_prob = nn.Module()
        self.head_prob.weight = nn.Parameter(torch.zeros(ch, 1), requires_grad=False)
        self.head_prob.bias = nn.Parameter(torch.zeros(1), requires_grad=False)
        self.head_dist = nn.Module()
        self.head_dist.weight = nn.Parameter(torch.zeros(ch, self.n_rays), requires_grad=False)
        self.head_dist.bias = nn.Parameter(torch.zeros(self.n_rays), requires_grad=False)

    def conv_blocks(self):
        return list(self.top) + list(self.backbone)

    def init_weights(self, generator):
        """Glorot-uniform kernels (flax's default) and zero biases, drawn
        from ``generator``."""
        for blk in self.conv_blocks():
            k = blk.weight
            taps = 3 ** self.n_dim
            fan_in, fan_out = taps * k.shape[-2], taps * k.shape[-1]
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            with torch.no_grad():
                k.copy_((torch.rand(k.shape, generator=generator) * 2 - 1) * lim)
                blk.bias.zero_()
        for head in (self.head_prob, self.head_dist):
            w = head.weight
            lim = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            with torch.no_grad():
                w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * lim)
                head.bias.zero_()

    @torch.no_grad()
    def forward(self, x, plain=False):
        """x (*sp, C_in) -> prob (*sp') f32, dist (R, *sp') f32.

        ``plain=True`` runs every conv through its plain PyTorch version
        (the reference the kernel path is checked against); a float32 net
        always does."""
        plain = plain or self.dtype == torch.float32
        h = x.to(self.dtype)
        top = iter(self.top)
        for p in self.prepools:
            for _ in range(self.n_conv):
                h = next(top)(h, plain)
            h = max_pool(h, p)

        bb = iter(self.backbone)
        skips = []
        for _ in range(self.n_depth):
            for _ in range(self.n_conv):
                h = next(bb)(h, plain)
            skips.append(h)
            h = max_pool(h, self.pool)
        for _ in range(self.n_conv):
            h = next(bb)(h, plain)
        for n in reversed(range(self.n_depth)):
            h = torch.cat([upsample(h, self.pool), skips[n]], dim=-1)
            for _ in range(self.n_conv):
                h = next(bb)(h, plain)
        feat = next(top)(h, plain) if self.n_feat > 0 else h

        # fused 1+R head as one f32 channel contraction; the weights are
        # rounded to the activation type first, as the reference does
        sp, C = feat.shape[:-1], feat.shape[-1]
        k = torch.cat([self.head_prob.weight, self.head_dist.weight], dim=1)
        k = k.to(feat.dtype).float()                                   # (C, 1+R)
        b = torch.cat([self.head_prob.bias, self.head_dist.bias]).float()
        y = torch.matmul(k.t(), feat.reshape(-1, C).float().t()) + b[:, None]
        prob = torch.sigmoid(y[0]).view(sp)
        dist = y[1:].view(self.n_rays, *sp)
        return prob, dist
