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

The reference's other network options: the activations of
:data:`ACTIVATIONS` (an activation outside the conv kernel's epilogue runs
after the kernel's linear output, as ``unet_chw.py::_conv_block`` does);
U-Net kernel sizes other than 3^nd, whose convs run through ``F.conv2d`` /
``F.conv3d`` in both routes, as the reference runs them through XLA; and
batch norm (:class:`BatchNorm`, flax's ``nn.BatchNorm`` with its running
statistics), folded into the conv's weight and bias for inference, so that
a 3x3 (3x3x3) block still runs the conv kernel. Training a batch-norm net
raises: the reference cannot train one either.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.profiling import span
from ..ops.conv import (ACTS, conv3x3_hwc, conv3x3_hwc_plain, conv3x3x3_dhwc,
                        conv3x3x3_dhwc_plain)


_CONVS = {2: (conv3x3_hwc, conv3x3_hwc_plain), 3: (conv3x3x3_dhwc, conv3x3x3_dhwc_plain)}

# flax's activations (reference unet.py ``_ACTIVATIONS``): elu with alpha 1,
# swish = silu, gelu with flax's default tanh approximation; relu's gradient
# at 0 is 0, as flax's
ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "linear": lambda y: y,
    "swish": F.silu,
    "gelu": lambda y: F.gelu(y, approximate="tanh"),
}

BN_EPS = 1e-5     # flax's nn.BatchNorm epsilon
# why a batch-norm net does not train
BN_TRAINING = ("training a batch-norm net is not ported: the reference cannot train one "
               "(stardist_tpu/models/base.py:675-677 applies the net with train=True but "
               "without mutable=['batch_stats'], and flax refuses to update the statistics)")


def activation_name(act):
    """The lower-case name of one of :data:`ACTIVATIONS`; the reference also
    takes a callable, which the port does not."""
    if callable(act):
        raise NotImplementedError("callable activations are not ported")
    name = str(act).lower()
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    return name


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


def same_pads(sizes, k, stride):
    """flax's ``padding="SAME"`` per spatial axis: (before, after) with
    ``total = max((ceil(n / s) - 1) * s + k - n, 0)`` and ``total // 2``
    before (asymmetric for a stride 2 and an even extent: (0, 1) at k = 3;
    and for an even k: (1, 2) at k = 4). ``k``: one size, or one per axis."""
    ks = [k] * len(sizes) if np.isscalar(k) else k
    pads = []
    for n, kk, s in zip(sizes, ks, stride):
        total = max((-(-n // s) - 1) * s + kk - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv_same(h, w, b, stride=None):
    """flax's ``nn.Conv(padding="SAME")`` of (B, C, *sp) by ``w`` in the flax
    (k..., C, Cout) layout and bias ``b``, in h's type."""
    nd = w.dim() - 2
    stride = (1,) * nd if stride is None else stride
    pads = same_pads(h.shape[2:], w.shape[:nd], stride)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        h = F.pad(h, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = 0
    wt = w.permute(nd + 1, nd, *range(nd)).to(h.dtype)            # (Cout, C, k, ...)
    return (F.conv2d if nd == 2 else F.conv3d)(h, wt, b.to(h.dtype), stride, padding)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` with its running statistics (the reference's
    prediction): ``(y - mean) * rsqrt(var + 1e-5) * scale + bias`` per
    channel. ``scale`` and ``bias`` are parameters, ``mean`` and ``var``
    buffers (the flax ``batch_stats``), so that the state dict, a deep copy
    and the training state carry all four; flax's initial values."""

    def __init__(self, c):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self._folded = None

    def fold(self, w, b):
        """(weight, bias) in float32 of the conv (w (k..., C, Cout), b) followed
        by this batch norm. Cached, keyed on the device, storage and version
        of all six tensors: a fold made per call would repack the conv
        kernel's weights at every launch, and one keyed on the weight alone
        would miss new statistics (``load_weights``)."""
        key = tuple((t.device, t.data_ptr(), t._version)
                    for t in (w, b, self.scale, self.bias, self.mean, self.var))
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                s = self.scale.float() * torch.rsqrt(self.var.float() + BN_EPS)
                self._folded = (key, w.float() * s, (b.float() - self.mean.float()) * s
                                + self.bias.float())
        return self._folded[1:]


class ConvBlock(nn.Module):
    """The reference's ``ConvBlock``: a SAME conv + bias (+ batch norm) +
    activation (+ dropout in training); weight in the flax HWIO (DHWIO)
    layout. A 3x3 (3x3x3) block runs the conv kernel for inference; another
    kernel size runs ``F.conv2d`` / ``F.conv3d``."""

    def __init__(self, c_in, c_out, act="relu", n_dim=2, dropout=0.0, k=3, batch_norm=False):
        super().__init__()
        self.act = activation_name(act)
        self.dropout = float(dropout)
        k = (int(k),) * n_dim if np.isscalar(k) else tuple(int(v) for v in k)
        self.on_kernel = k == (3,) * n_dim          # run by the conv kernel (conv_blocks())
        self.weight = nn.Parameter(torch.zeros(k + (c_in, c_out)))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.bn = BatchNorm(c_out) if batch_norm else None
        self.kernel, self.plain = _CONVS[n_dim]

    def forward(self, h, plain=False):
        """Inference route: channels-last (*sp, C) in the net's type. An
        activation outside the kernel's epilogue runs on the conv's output
        in that type; the batch norm is folded into the conv."""
        w, b = (self.weight, self.bias) if self.bn is None else self.bn.fold(self.weight,
                                                                               self.bias)
        act = self.act if self.act in ACTS else "linear"
        if self.on_kernel:
            y = (self.plain if plain else self.kernel)(h, w, b, act)
        else:
            # the plain version: float32 sums of operands in the net's type
            x = h.movedim(-1, 0)[None]
            y = conv_same(x.float(), w.to(h.dtype).float(), b) if plain else conv_same(x, w, b)
            y = ACTIVATIONS[act](y).to(h.dtype)[0].movedim(0, -1).contiguous()
        return y if act == self.act else ACTIVATIONS[self.act](y)

    def train_forward(self, h, generator=None, rows=None):
        """Training route: float32 (B, C, *sp) -> (B, Cout, *sp) (no batch
        norm: :meth:`StarDistNet.train_forward` refuses it); ``rows`` as in
        :func:`dropout`."""
        y = ACTIVATIONS[self.act](conv_same(h, self.weight, self.bias))
        if self.dropout > 0:
            y = dropout(y, self.dropout, generator, rows)
        return y


class Conv(nn.Module):
    """A SAME conv with a stride (+ batch norm) (+ activation), on (B, C, *sp)
    in the input's type; weight in the flax (k..., C, Cout) layout, ``k``
    one size or one per axis. The ResNet's convs, in both routes."""

    def __init__(self, c_in, c_out, k, n_dim, stride=1, act="linear", batch_norm=False):
        super().__init__()
        k = (int(k),) * n_dim if np.isscalar(k) else tuple(int(v) for v in k)
        self.stride = (int(stride),) * n_dim if np.isscalar(stride) else tuple(map(int, stride))
        self.act = activation_name(act)
        self.weight = nn.Parameter(torch.zeros(k + (c_in, c_out)))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.bn = BatchNorm(c_out) if batch_norm else None

    def forward(self, h):
        w, b = (self.weight, self.bias) if self.bn is None else self.bn.fold(self.weight,
                                                                               self.bias)
        return ACTIVATIONS[self.act](conv_same(h, w, b, self.stride))


class ResNetBlock(nn.Module):
    """csbdeep's ``resnet_block`` (reference unet.py ``ResNetBlock``):
    ``n_conv`` convs, the first strided by ``pool``, each followed by the
    batch norm where the net has it, an activation after each but the
    last; a strided 1x1 projection shortcut (no batch norm) when the block
    pools or changes the width; the activation after the sum."""

    def __init__(self, c_in, c_out, k, pool, n_conv, n_dim, act, batch_norm=False):
        super().__init__()
        self.act = ACTIVATIONS[activation_name(act)]
        self.convs = nn.ModuleList(
            [Conv(c_in, c_out, k, n_dim, pool, act, batch_norm)]
            + [Conv(c_out, c_out, k, n_dim, 1, act if i < n_conv - 2 else "linear", batch_norm)
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
            self.feat_class = Conv(self.n_base, self.n_feat, tuple(c.resnet_kernel_size),
                                   self.n_dim, 1, c.resnet_activation)
        else:
            self.feat_class = ConvBlock(self.n_base, self.n_feat, c.unet_activation, self.n_dim,
                                        k=tuple(c.unet_kernel_size))
        return self.n_feat

    def _build_unet(self, c):
        nd = self.n_dim
        self.n_depth = int(c.unet_n_depth)
        self.n_conv = int(c.unet_n_conv_per_depth)
        self.pool = tuple(int(p) for p in c.unet_pool)
        act, last_act = c.unet_activation, c.unet_last_activation
        base = int(c.unet_n_filter_base)
        drop = float(c.unet_dropout)       # the backbone's convs only, as in flax
        k = tuple(int(v) for v in c.unet_kernel_size)
        # batch norm in the backbone's convs only, as in flax
        bn = dict(k=k, batch_norm=bool(c.unet_batch_norm))

        # grid pre-pooling (unet.py StarDistNet.__call__)
        top, self.prepools = [], []
        ch = int(c.n_channel_in)
        pooled = np.ones(nd, int)
        while tuple(pooled) != self.grid:
            p = 1 + (np.asarray(self.grid) > pooled)
            pooled *= p
            for _ in range(self.n_conv):
                top.append(ConvBlock(ch, base, act, nd, k=k))
                ch = base
            self.prepools.append(tuple(int(v) for v in p))

        # backbone (unet.py UNetBackbone.__call__)
        bb, skip_ch = [], []
        for n in range(self.n_depth):
            for _ in range(self.n_conv):
                bb.append(ConvBlock(ch, base * 2 ** n, act, nd, drop, **bn))
                ch = base * 2 ** n
            skip_ch.append(ch)
        for _ in range(self.n_conv - 1):
            bb.append(ConvBlock(ch, base * 2 ** self.n_depth, act, nd, drop, **bn))
            ch = base * 2 ** self.n_depth
        bb.append(ConvBlock(ch, base * 2 ** max(0, self.n_depth - 1), act, nd, drop, **bn))
        ch = base * 2 ** max(0, self.n_depth - 1)
        for n in reversed(range(self.n_depth)):
            ch = ch + skip_ch[n]
            for _ in range(self.n_conv - 1):
                bb.append(ConvBlock(ch, base * 2 ** n, act, nd, drop, **bn))
                ch = base * 2 ** n
            bb.append(ConvBlock(ch, base * 2 ** max(0, n - 1), act if n > 0 else last_act, nd,
                                 drop, **bn))
            ch = base * 2 ** max(0, n - 1)

        self.n_base = ch
        self.n_feat = int(c.net_conv_after_unet)
        if self.n_feat > 0:
            top.append(ConvBlock(ch, self.n_feat, act, nd, k=k))
            ch = self.n_feat
        self.top = nn.ModuleList(top)
        self.backbone = nn.ModuleList(bb)
        return ch

    def _build_resnet(self, c):
        """unet.py StarDistNet.__call__, ``backbone == "resnet"``."""
        nd = self.n_dim
        k = tuple(int(v) for v in c.resnet_kernel_size)
        self.resnet_kernel_init = str(c.resnet_kernel_init).lower()
        act = c.resnet_activation
        ch = base = int(c.resnet_n_filter_base)
        self.stem = nn.ModuleList([Conv(int(c.n_channel_in), base, 7, nd),
                                   Conv(base, base, 3, nd)])
        blocks, pooled = [], np.ones(nd, int)
        for _ in range(int(c.resnet_n_blocks)):
            pool = 1 + (np.asarray(self.grid) > pooled)
            pooled *= pool
            c_out = ch * 2 if any(p > 1 for p in pool) else ch
            blocks.append(ResNetBlock(ch, c_out, k, tuple(int(p) for p in pool),
                                      int(c.resnet_n_conv_per_block), nd, act,
                                      bool(c.resnet_batch_norm)))
            ch = c_out
        if tuple(pooled) != self.grid:
            raise ValueError(f"resnet_n_blocks = {c.resnet_n_blocks} cannot reach grid {self.grid}")
        self.blocks = nn.ModuleList(blocks)
        self.n_base = ch
        self.n_feat = int(c.net_conv_after_resnet)
        self.feat = Conv(ch, self.n_feat, k, nd, 1, act) if self.n_feat > 0 else None
        return self.n_feat if self.n_feat > 0 else ch

    def unet_blocks(self):
        """The U-Net's convs (the class branch's feature conv last); the
        ResNet has none."""
        if self.backbone_kind == "resnet":
            return []
        fc = self.feat_class
        return list(self.top) + list(self.backbone) + ([fc] if fc is not None else [])

    def conv_blocks(self):
        """The convs of the conv kernel: the U-Net's with 3x3 (3x3x3)
        kernels."""
        return [blk for blk in self.unet_blocks() if blk.on_kernel]

    @property
    def batch_norm(self):
        """Whether the net has batch norm."""
        return any(isinstance(m, BatchNorm) for m in self.modules())

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
        U-Net and feature convs; the ResNet's convs (stem, blocks, shortcuts)
        by ``resnet_kernel_init`` (reference unet.py ``_kernel_init``):
        he-normal, he-uniform, glorot-uniform for ``glorot_uniform`` /
        ``xavier_uniform`` and for any other name; lecun-normal 1x1 heads
        (both normals truncated at 2 std), zero biases. Batch norms keep
        flax's initial scale 1, bias 0, mean 0, var 1."""
        def trunc_normal(w, scale):
            # flax's variance_scaling: stddev sqrt(scale / fan_in) over the std
            # of a unit normal cut at +-2
            fan_in = math.prod(w.shape[:-1])
            r = torch.empty(w.shape)
            nn.init.trunc_normal_(r, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.copy_(r * (math.sqrt(scale / fan_in) / .87962566103423978))

        def uniform(w, lim):
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * lim)

        def glorot(w):
            taps = math.prod(w.shape[:-2])
            uniform(w, math.sqrt(6.0 / (taps * w.shape[-2] + taps * w.shape[-1])))

        def resnet_init(w):
            if self.resnet_kernel_init == "he_normal":
                trunc_normal(w, 2.0)
            elif self.resnet_kernel_init == "he_uniform":
                uniform(w, math.sqrt(6.0 / math.prod(w.shape[:-1])))
            else:
                glorot(w)

        if self.backbone_kind == "resnet":
            for conv in self.resnet_convs():
                if conv is self.feat or conv is self.feat_class:
                    glorot(conv.weight)
                else:
                    resnet_init(conv.weight)
                conv.bias.zero_()
        for blk in self.unet_blocks():
            glorot(blk.weight)
            blk.bias.zero_()
        for head in self._heads():
            trunc_normal(head.weight, 1.0)
            head.bias.zero_()

    def _heads(self):
        heads = [self.head_prob, self.head_dist]
        return heads + ([self.head_prob_class] if self.n_classes is not None else [])

    def _resnet(self, h):
        """The ResNet's backbone output of (B, C, *sp) in h's type, the stem
        and each block in a span of its own (in both routes)."""
        with span("stardist.forward.stem"):
            for conv in self.stem:
                h = conv(h)
        for blk in self.blocks:
            with span("stardist.forward.block"):
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
        if self.n_feat <= 0:
            return base, (base if self.n_classes is not None else None)
        feat = self.top[-1] if self.backbone_kind == "unet" else self.feat
        fc = self.feat_class
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
                with span("stardist.forward.head"):
                    return self._outputs(base, conv)

            def conv(blk, h):
                return blk(h, plain)
            base = self._walk(x.to(self.dtype), conv, max_pool, upsample,
                              lambda a, b: torch.cat([a, b], dim=-1))
            return self._outputs(base, conv)

    def _outputs(self, base, conv):
        """:meth:`forward`'s outputs from the backbone's channels-last output
        ``base``: the feature convs (``conv(module, h)``) and the heads."""
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
        a data-parallel rank's rows of a batch (see :func:`dropout`). A
        batch-norm net raises ``NotImplementedError`` (:data:`BN_TRAINING`)."""
        if self.batch_norm:
            raise NotImplementedError(BN_TRAINING)
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
