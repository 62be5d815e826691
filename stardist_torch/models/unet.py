"""StarDist 2D and 3D networks (counterpart of ``stardist_tpu/models/unet.py::
StarDistNet`` and its inference form ``models/unet_chw.py::chw_forward``).

The U-Net: one walker of the topology, in the flax call order — grid
pre-pooling convs, the csbdeep U-Net backbone (max-pool, nearest upsample,
skip concat), the feature conv, the 1x1 heads; with ``n_classes`` a second
feature conv on the backbone's output and a 1x1 class head with a softmax
(the reference's ``head_prob_class``) — with two routes:

- inference (:meth:`StarDistNet.forward`): one unbatched channels-last
  image, ``(H, W, C)`` or ``(D, H, W, C)``, so that every 3x3 (3x3x3) conv
  reads and writes it without a transpose; the conv kernel on CUDA in
  bf16, the plain version otherwise; no autograd. Outputs as the
  reference's: ``prob (*sp')`` and ``dist (R, *sp')`` float32,
  channel-major, and with ``n_classes`` ``prob_class (n_classes + 1,
  *sp')`` float32;
- training (:meth:`StarDistNet.train_forward`): a float32 batch
  ``(B, *sp, C)`` through ``F.conv2d`` / ``F.conv3d`` with autograd, and
  the reference's dropout; outputs ``prob (B, *sp', 1)``, ``dist (B,
  *sp', R)`` and with ``n_classes`` ``prob_class (B, *sp', n_classes +
  1)``, as the reference's ``net.apply(..., train=True)``.

The ResNet (3D; the reference's ``backbone="resnet"``): a 7^3 and a 3^3 conv
(no activation), ``resnet_n_blocks`` csbdeep residual blocks whose first
conv and 1x1 projection shortcut are strided until the grid is reached
(filters doubling at each stride), the feature convs, the heads. Its convs
are ``F.conv3d`` on ``(B, C, *sp)`` in both routes (the net's type for
inference, float32 for training), as the reference runs them through XLA
and never through its Pallas conv (``supports_chw`` excludes them); a
strided conv pads as flax's ``padding="SAME"`` does, ``total // 2`` before
and the rest after, ``total = max((out - 1) * s + k - in, 0)``.
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


def dropout(h, rate, generator, rows=None):
    """flax's ``nn.Dropout``: keep with probability 1 - rate (drawn from
    ``generator``), scale the kept values by 1 / (1 - rate). ``rows`` =
    (slice, batch size): ``h`` holds those rows of a batch, and gets their
    rows of the whole batch's mask (a data-parallel rank's share)."""
    keep_prob = 1.0 - rate
    if rows is None:
        keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
    else:
        sl, batch = rows
        keep = torch.rand((batch,) + tuple(h.shape[1:]), generator=generator,
                          device=h.device)[sl] < keep_prob
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

    def train_forward(self, h, generator=None, rows=None):
        """Training route: float32 (B, C, *sp) -> (B, Cout, *sp); ``rows`` as
        in :func:`dropout`."""
        nd = self.weight.dim() - 2
        w = self.weight.permute(nd + 1, nd, *range(nd))             # (Cout, C, 3, ...)
        y = _TRAIN_ACTS[self.act]((F.conv2d if nd == 2 else F.conv3d)(h, w, self.bias, padding=1))
        if self.dropout > 0:
            y = dropout(y, self.dropout, generator, rows)
        return y


def same_pads(sizes, k, stride):
    """flax's ``padding="SAME"`` per spatial axis: (before, after) with
    ``total = max((ceil(n / s) - 1) * s + k - n, 0)`` and ``total // 2``
    before (asymmetric for a stride 2 and an even extent: (0, 1) at k = 3)."""
    pads = []
    for n, s in zip(sizes, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


class Conv(nn.Module):
    """A k^nd conv with a stride and flax's SAME padding (+ activation), on
    (B, C, *sp) in the input's type; weight in the flax (k..., C, Cout)
    layout. The ResNet's convs, in both routes."""

    def __init__(self, c_in, c_out, k, n_dim, stride=1, act="linear"):
        super().__init__()
        self.k = int(k)
        self.stride = (int(stride),) * n_dim if np.isscalar(stride) else tuple(map(int, stride))
        self.act = str(act).lower()
        if self.act not in _TRAIN_ACTS:
            raise NotImplementedError(f"activation {act!r} is not ported")
        self.weight = nn.Parameter(torch.zeros((self.k,) * n_dim + (c_in, c_out)))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, h):
        nd = self.weight.dim() - 2
        pads = same_pads(h.shape[2:], self.k, self.stride)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            h = F.pad(h, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        w = self.weight.permute(nd + 1, nd, *range(nd)).to(h.dtype)   # (Cout, C, k, ...)
        conv = F.conv2d if nd == 2 else F.conv3d
        return _TRAIN_ACTS[self.act](conv(h, w, self.bias.to(h.dtype), self.stride, padding))


class ResNetBlock(nn.Module):
    """csbdeep's ``resnet_block`` (reference unet.py ``ResNetBlock``):
    ``n_conv`` convs, the first strided by ``pool``, an activation after
    each but the last; a strided 1x1 projection shortcut when the block
    pools or changes the width; the activation after the sum."""

    def __init__(self, c_in, c_out, k, pool, n_conv, n_dim, act):
        super().__init__()
        self.act = _TRAIN_ACTS[str(act).lower()]
        self.convs = nn.ModuleList(
            [Conv(c_in, c_out, k, n_dim, pool, act)]
            + [Conv(c_out, c_out, k, n_dim, 1, act if i < n_conv - 2 else "linear")
               for i in range(n_conv - 1)])
        self.shortcut = (Conv(c_in, c_out, 1, n_dim, pool)
                         if any(p > 1 for p in pool) or c_in != c_out else None)

    def forward(self, x):
        y = x
        for conv in self.convs:
            y = conv(y)
        return self.act((x if self.shortcut is None else self.shortcut(x)) + y)


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
    """2D or 3D StarDist network with a U-Net backbone, or 3D with a ResNet.

    ``dtype`` is the activation type of the inference route's convs:
    ``torch.bfloat16`` (the CUDA kernel's type and the reference's TPU
    inference type) or ``torch.float32``, whose convs are always the plain
    PyTorch versions (on CUDA too: the kernels take bfloat16 only). The
    training route is float32 whatever ``dtype`` is."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        c = config
        self.n_dim = int(c.n_dim)
        self.n_classes = None if c.n_classes is None else int(c.n_classes)
        self.feat_class = None      # the class branch's feature conv (see _class_branch)
        self.backbone_kind = str(c.backbone).lower()
        self.grid = tuple(int(g) for g in c.grid)
        self.n_rays = int(c.n_rays)
        self.dtype = dtype
        if self.backbone_kind == "resnet":
            ch = self._build_resnet(c)
        elif self.backbone_kind == "unet":
            ch = self._build_unet(c)
        else:
            raise NotImplementedError(f"backbone {c.backbone!r} is not ported")
        self.head_prob = nn.Module()
        self.head_prob.weight = nn.Parameter(torch.zeros(ch, 1))
        self.head_prob.bias = nn.Parameter(torch.zeros(1))
        self.head_dist = nn.Module()
        self.head_dist.weight = nn.Parameter(torch.zeros(ch, self.n_rays))
        self.head_dist.bias = nn.Parameter(torch.zeros(self.n_rays))
        if self.n_classes is not None:
            # the class branch: its own feature conv on the backbone's output
            # (none when the net has no feature conv) and a 1x1 head
            ch_class = self._class_branch(c)
            self.head_prob_class = nn.Module()
            self.head_prob_class.weight = nn.Parameter(torch.zeros(ch_class, self.n_classes + 1))
            self.head_prob_class.bias = nn.Parameter(torch.zeros(self.n_classes + 1))

    def _class_branch(self, c):
        """Build ``feat_class``, the class branch's feature conv (a copy of
        the feature conv's shape; none without a feature conv), and return
        its output width."""
        if self.n_feat <= 0:
            return self.n_base
        if self.backbone_kind == "resnet":
            k = int(c.resnet_kernel_size[0])
            self.feat_class = Conv(self.n_base, self.n_feat, k, self.n_dim, 1,
                                   c.resnet_activation)
        else:
            self.feat_class = ConvBlock(self.n_base, self.n_feat, c.unet_activation, self.n_dim)
        return self.n_feat

    def _build_unet(self, c):
        nd = self.n_dim
        if tuple(c.unet_kernel_size) != (3,) * nd or c.unet_batch_norm:
            raise NotImplementedError(
                "only the U-Net backbone with 3x3 (3x3x3) kernels and no batch norm is ported")
        self.n_depth = int(c.unet_n_depth)
        self.n_conv = int(c.unet_n_conv_per_depth)
        self.pool = tuple(int(p) for p in c.unet_pool)
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

        self.n_base = ch
        self.n_feat = int(c.net_conv_after_unet)
        if self.n_feat > 0:
            top.append(ConvBlock(ch, self.n_feat, act, nd))
            ch = self.n_feat
        self.top = nn.ModuleList(top)
        self.backbone = nn.ModuleList(bb)
        return ch

    def _build_resnet(self, c):
        """unet.py StarDistNet.__call__, ``backbone == "resnet"``."""
        nd = self.n_dim
        k = tuple(int(v) for v in c.resnet_kernel_size)
        if len(set(k)) != 1 or c.resnet_batch_norm:
            raise NotImplementedError(
                "only the ResNet backbone with cubic kernels and no batch norm is ported")
        if str(c.resnet_kernel_init).lower() != "he_normal":
            raise NotImplementedError("only the ResNet's he_normal initializer is ported")
        act = c.resnet_activation
        ch = base = int(c.resnet_n_filter_base)
        self.stem = nn.ModuleList([Conv(int(c.n_channel_in), base, 7, nd),
                                   Conv(base, base, 3, nd)])
        blocks, pooled = [], np.ones(nd, int)
        for _ in range(int(c.resnet_n_blocks)):
            pool = 1 + (np.asarray(self.grid) > pooled)
            pooled *= pool
            c_out = ch * 2 if any(p > 1 for p in pool) else ch
            blocks.append(ResNetBlock(ch, c_out, k[0], tuple(int(p) for p in pool),
                                      int(c.resnet_n_conv_per_block), nd, act))
            ch = c_out
        if tuple(pooled) != self.grid:
            raise ValueError(f"resnet_n_blocks = {c.resnet_n_blocks} cannot reach grid {self.grid}")
        self.blocks = nn.ModuleList(blocks)
        self.n_base = ch
        self.n_feat = int(c.net_conv_after_resnet)
        self.feat = Conv(ch, self.n_feat, k[0], nd, 1, act) if self.n_feat > 0 else None
        return self.n_feat if self.n_feat > 0 else ch

    def conv_blocks(self):
        """The convs of the conv kernel (the U-Net's, the class branch's
        feature conv last); the ResNet has none."""
        if self.backbone_kind == "resnet":
            return []
        fc = self.feat_class
        return list(self.top) + list(self.backbone) + ([fc] if fc is not None else [])

    def resnet_convs(self):
        """The ResNet's convs as flax creates them: the stem, each block's
        convs and shortcut, the feature conv, the class branch's."""
        convs = list(self.stem)
        for blk in self.blocks:
            convs += list(blk.convs) + ([blk.shortcut] if blk.shortcut is not None else [])
        return convs + [m for m in (self.feat, self.feat_class) if m is not None]

    @torch.no_grad()
    def init_weights(self, generator):
        """flax's initializers, drawn from ``generator`` (a CPU generator, so
        that every device starts from the same weights): glorot-uniform
        U-Net and feature convs, he-normal ResNet convs (stem, blocks,
        shortcuts), lecun-normal 1x1 heads (both normals truncated at 2
        std), zero biases."""
        def trunc_normal(w, scale):
            # flax's variance_scaling: stddev sqrt(scale / fan_in) over the std
            # of a unit normal cut at +-2
            fan_in = math.prod(w.shape[:-1])
            r = torch.empty(w.shape)
            nn.init.trunc_normal_(r, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.copy_(r * (math.sqrt(scale / fan_in) / .87962566103423978))

        def glorot(w):
            taps = math.prod(w.shape[:-2])
            lim = math.sqrt(6.0 / (taps * w.shape[-2] + taps * w.shape[-1]))
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * lim)

        if self.backbone_kind == "resnet":
            for conv in self.resnet_convs():
                if conv is self.feat or conv is self.feat_class:
                    glorot(conv.weight)
                else:
                    trunc_normal(conv.weight, 2.0)
                conv.bias.zero_()
        for blk in self.conv_blocks():
            glorot(blk.weight)
            blk.bias.zero_()
        for head in self._heads():
            trunc_normal(head.weight, 1.0)
            head.bias.zero_()

    def _heads(self):
        heads = [self.head_prob, self.head_dist]
        return heads + ([self.head_prob_class] if self.n_classes is not None else [])

    def _resnet(self, h):
        """The ResNet's backbone output of (B, C, *sp) in h's type."""
        for conv in self.stem:
            h = conv(h)
        for blk in self.blocks:
            h = blk(h)
        return h

    def _walk(self, h, conv, pool, up, cat):
        """The U-Net's topology up to the backbone's output: ``conv(block,
        h)``, ``pool(h, factors)``, ``up(h, factors)``, ``cat(upsampled,
        skip)``."""
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
        return h

    def _features(self, base, conv):
        """(the heads' features, the class branch's or None) of the
        backbone's output, ``conv(module, h)`` applying a feature conv."""
        feat = self.top[-1] if self.backbone_kind == "unet" else self.feat
        fc = self.feat_class
        if self.n_feat <= 0:
            return base, (base if self.n_classes is not None else None)
        return conv(feat, base), (conv(fc, base) if fc is not None else None)

    def forward(self, x, plain=False):
        """Inference route: x (*sp, C_in) -> prob (*sp') f32, dist (R, *sp')
        f32, without autograd.

        ``plain=True`` runs every conv through its plain PyTorch version
        (the reference the kernel path is checked against); a float32 net
        always does."""
        plain = plain or self.dtype == torch.float32
        with torch.no_grad():
            if self.backbone_kind == "resnet":
                def conv(mod, h):
                    return mod(h.movedim(-1, 0)[None])[0].movedim(0, -1)
                base = conv(self._resnet, x.to(self.dtype))
            else:
                def conv(blk, h):
                    return blk(h, plain)
                base = self._walk(x.to(self.dtype), conv, max_pool, upsample,
                                  lambda a, b: torch.cat([a, b], dim=-1))
            feat, feat_c = self._features(base, conv)
            # fused 1+R head as one f32 channel contraction; the weights are
            # rounded to the activation type first, as the reference does
            sp = feat.shape[:-1]
            y = _head(feat, torch.cat([self.head_prob.weight, self.head_dist.weight], dim=1),
                      torch.cat([self.head_prob.bias, self.head_dist.bias]))
            prob = torch.sigmoid(y[0]).view(sp)
            dist = y[1:].view(self.n_rays, *sp)
            if self.n_classes is None:
                return prob, dist
            pc = _head(feat_c, self.head_prob_class.weight, self.head_prob_class.bias)
            prob_class = torch.softmax(pc, dim=0).view(self.n_classes + 1, *sp)
        return prob, dist, prob_class

    def train_forward(self, x, generator=None, rows=None):
        """Training route: x (B, *sp, C_in) float32 -> prob (B, *sp', 1),
        dist (B, *sp', R), with autograd. ``generator`` draws the dropout
        masks (on x's device); ``rows`` = (slice, batch size) when ``x`` is
        a data-parallel rank's rows of a batch (see :func:`dropout`)."""
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
        if self.backbone_kind == "resnet":
            def conv(mod, h):
                return mod(h)
            base = self._resnet(h)
        else:
            def conv(blk, h):
                return blk.train_forward(h, generator, rows)
            base = self._walk(h, conv, lambda h, p: pool(h, p) if any(v > 1 for v in p) else h,
                              up, lambda a, b: torch.cat([a, b], dim=1))
        feat, feat_c = self._features(base, conv)
        feat = feat.movedim(1, -1)                   # (B, *sp', C)
        prob = torch.sigmoid(feat @ self.head_prob.weight + self.head_prob.bias)
        dist = feat @ self.head_dist.weight + self.head_dist.bias
        if self.n_classes is None:
            return prob, dist
        pc = feat_c.movedim(1, -1) @ self.head_prob_class.weight + self.head_prob_class.bias
        return prob, dist, torch.softmax(pc, dim=-1)


def _head(feat, w, b):
    """A 1x1 head on channels-last features (*sp, C) as one f32 channel
    contraction, channel-major out (Cout, n_pix); the weights rounded to the
    features' type first, as the reference does."""
    C = feat.shape[-1]
    k = w.to(feat.dtype).float()                                  # (C, Cout)
    return torch.matmul(k.t(), feat.reshape(-1, C).float().t()) + b.float()[:, None]
