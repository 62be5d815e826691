"""StarDist 2D and 3D U-Net (counterpart of ``stardist_tpu/models/unet.py::
StarDistNet`` and its inference form ``models/unet_chw.py::chw_forward``).

One walker of the topology, in the flax call order — grid pre-pooling
convs, the csbdeep U-Net backbone (max-pool, nearest upsample, skip concat),
the feature conv, the 1x1 heads — with two routes:

- inference (:meth:`StarDistNet.forward`): one unbatched channels-last
  image, ``(H, W, C)`` or ``(D, H, W, C)``, so that every 3x3 (3x3x3) conv
  reads and writes it without a transpose; the conv kernel on CUDA in
  bf16, the plain version otherwise; no autograd. Outputs as the
  reference's: ``prob (*sp')`` and ``dist (R, *sp')`` float32,
  channel-major;
- training (:meth:`StarDistNet.train_forward`): a float32 batch
  ``(B, *sp, C)`` through ``F.conv2d`` / ``F.conv3d`` with autograd, and
  the reference's dropout; outputs ``prob (B, *sp', 1)`` and ``dist (B,
  *sp', R)``, as the reference's ``net.apply(..., train=True)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import (ACTS, conv3x3_hwc, conv3x3_hwc_plain, conv3x3x3_dhwc,
                        conv3x3x3_dhwc_plain)


_CONVS = {2: (conv3x3_hwc, conv3x3_hwc_plain), 3: (conv3x3x3_dhwc, conv3x3x3_dhwc_plain)}


# the training route's activations: relu's gradient at 0 is 0, as flax's
_TRAIN_ACTS = {"relu": F.relu, "elu": F.elu, "linear": lambda y: y}


def dropout(h, rate, generator):
    """flax's ``nn.Dropout``: keep with probability 1 - rate (drawn from
    ``generator``), scale the kept values by 1 / (1 - rate)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
    return torch.where(keep, h / keep_prob, torch.zeros((), dtype=h.dtype, device=h.device))


class ConvBlock(nn.Module):
    """3x3 (3x3x3) SAME conv + bias + activation (+ dropout in training);
    weight in the flax HWIO (DHWIO) layout."""

    def __init__(self, c_in, c_out, act="relu", n_dim=2, dropout=0.0):
        super().__init__()
        act = str(act).lower()
        if act not in ACTS:
            raise NotImplementedError(f"activation {act!r} has no conv kernel epilogue")
        self.act = act
        self.dropout = float(dropout)
        self.weight = nn.Parameter(torch.zeros((3,) * n_dim + (c_in, c_out)))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.kernel, self.plain = _CONVS[n_dim]

    def forward(self, h, plain=False):
        """Inference route: channels-last (*sp, C) in the net's type."""
        conv = self.plain if plain else self.kernel
        return conv(h, self.weight, self.bias, self.act)

    def train_forward(self, h, generator=None):
        """Training route: float32 (B, C, *sp) -> (B, Cout, *sp)."""
        nd = self.weight.dim() - 2
        w = self.weight.permute(nd + 1, nd, *range(nd))             # (Cout, C, 3, ...)
        y = _TRAIN_ACTS[self.act]((F.conv2d if nd == 2 else F.conv3d)(h, w, self.bias, padding=1))
        if self.dropout > 0:
            y = dropout(y, self.dropout, generator)
        return y


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
    """2D or 3D StarDist network with a U-Net backbone.

    ``dtype`` is the activation type of the inference route's convs:
    ``torch.bfloat16`` (the CUDA kernel's type and the reference's TPU
    inference type) or ``torch.float32``, whose convs are always the plain
    PyTorch versions (on CUDA too: the kernels take bfloat16 only). The
    training route is float32 whatever ``dtype`` is."""

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
        drop = float(c.unet_dropout)       # the backbone's convs only, as in flax

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
                bb.append(ConvBlock(ch, base * 2 ** n, act, nd, drop))
                ch = base * 2 ** n
            skip_ch.append(ch)
        for _ in range(self.n_conv - 1):
            bb.append(ConvBlock(ch, base * 2 ** self.n_depth, act, nd, drop))
            ch = base * 2 ** self.n_depth
        bb.append(ConvBlock(ch, base * 2 ** max(0, self.n_depth - 1), act, nd, drop))
        ch = base * 2 ** max(0, self.n_depth - 1)
        for n in reversed(range(self.n_depth)):
            ch = ch + skip_ch[n]
            for _ in range(self.n_conv - 1):
                bb.append(ConvBlock(ch, base * 2 ** n, act, nd, drop))
                ch = base * 2 ** n
            bb.append(ConvBlock(ch, base * 2 ** max(0, n - 1), act if n > 0 else last_act, nd,
                                 drop))
            ch = base * 2 ** max(0, n - 1)

        self.n_feat = int(c.net_conv_after_unet)
        if self.n_feat > 0:
            top.append(ConvBlock(ch, self.n_feat, act, nd))
            ch = self.n_feat
        self.top = nn.ModuleList(top)
        self.backbone = nn.ModuleList(bb)
        self.head_prob = nn.Module()
        self.head_prob.weight = nn.Parameter(torch.zeros(ch, 1))
        self.head_prob.bias = nn.Parameter(torch.zeros(1))
        self.head_dist = nn.Module()
        self.head_dist.weight = nn.Parameter(torch.zeros(ch, self.n_rays))
        self.head_dist.bias = nn.Parameter(torch.zeros(self.n_rays))

    def conv_blocks(self):
        return list(self.top) + list(self.backbone)

    @torch.no_grad()
    def init_weights(self, generator):
        """flax's initializers, drawn from ``generator`` (a CPU generator, so
        that every device starts from the same weights): glorot-uniform
        conv kernels, lecun-normal (truncated to 2 std) 1x1 heads, zero
        biases."""
        taps = 3 ** self.n_dim
        for blk in self.conv_blocks():
            k = blk.weight
            lim = math.sqrt(6.0 / (taps * k.shape[-2] + taps * k.shape[-1]))
            k.copy_((torch.rand(k.shape, generator=generator) * 2 - 1) * lim)
            blk.bias.zero_()
        for head in (self.head_prob, self.head_dist):
            w = torch.empty(head.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            # flax: stddev sqrt(1 / fan_in) over the std of a unit normal cut at +-2
            head.weight.copy_(w * (math.sqrt(1.0 / w.shape[0]) / .87962566103423978))
            head.bias.zero_()

    def _walk(self, h, conv, pool, up, cat):
        """The topology up to the features: ``conv(block, h)``, ``pool(h,
        factors)``, ``up(h, factors)``, ``cat(upsampled, skip)``."""
        top = iter(self.top)
        for p in self.prepools:
            for _ in range(self.n_conv):
                h = conv(next(top), h)
            h = pool(h, p)

        bb = iter(self.backbone)
        skips = []
        for _ in range(self.n_depth):
            for _ in range(self.n_conv):
                h = conv(next(bb), h)
            skips.append(h)
            h = pool(h, self.pool)
        for _ in range(self.n_conv):
            h = conv(next(bb), h)
        for n in reversed(range(self.n_depth)):
            h = cat(up(h, self.pool), skips[n])
            for _ in range(self.n_conv):
                h = conv(next(bb), h)
        return conv(next(top), h) if self.n_feat > 0 else h

    def forward(self, x, plain=False):
        """Inference route: x (*sp, C_in) -> prob (*sp') f32, dist (R, *sp')
        f32, without autograd.

        ``plain=True`` runs every conv through its plain PyTorch version
        (the reference the kernel path is checked against); a float32 net
        always does."""
        plain = plain or self.dtype == torch.float32
        with torch.no_grad():
            feat = self._walk(x.to(self.dtype), lambda blk, h: blk(h, plain), max_pool, upsample,
                              lambda a, b: torch.cat([a, b], dim=-1))
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

    def train_forward(self, x, generator=None):
        """Training route: x (B, *sp, C_in) float32 -> prob (B, *sp', 1),
        dist (B, *sp', R), with autograd. ``generator`` draws the dropout
        masks (on x's device)."""
        nd = self.n_dim
        pool = F.max_pool2d if nd == 2 else F.max_pool3d

        def up(h, factors):                          # nearest, as jnp.repeat
            for ax, p in enumerate(factors, start=2):
                if p > 1:
                    shape = list(h.shape)
                    shape.insert(ax + 1, p)
                    h = h.unsqueeze(ax + 1).expand(shape).flatten(ax, ax + 1)
            return h

        h = x.float().movedim(-1, 1)                 # (B, C, *sp), channels-last in memory
        feat = self._walk(h, lambda blk, h: blk.train_forward(h, generator),
                          lambda h, p: pool(h, p) if any(v > 1 for v in p) else h, up,
                          lambda a, b: torch.cat([a, b], dim=1))
        feat = feat.movedim(1, -1)                   # (B, *sp', C)
        prob = torch.sigmoid(feat @ self.head_prob.weight + self.head_prob.bias)
        dist = feat @ self.head_dist.weight + self.head_dist.bias
        return prob, dist
