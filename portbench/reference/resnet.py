"""Plain PyTorch forward of a StarDist ResNet (3D), from the model folder alone.

Upstream StarDist's ``backbone="resnet"`` (stardist/models/model3d.py,
``_build_resnet``, with csbdeep's ``resnet_block``): a 7^nd and a 3^nd conv
without activation; ``resnet_n_blocks`` residual blocks, the first
``len(prepools(grid))`` of them strided by the pooling factors that reach
the grid (one factor of at most 2 per axis a block) and doubling the width,
the others of stride 1 and the same width. A block is
``resnet_n_conv_per_block`` convs, the first strided, relu after each but
the last; a 1x1 projection shortcut of the same stride where the block
pools or changes the width, the input itself otherwise; relu after the
sum. Then the feature conv ``net_conv_after_resnet`` with relu, and the 1x1
heads: sigmoid prob and linear dist.

Every conv pads as flax's ``padding="SAME"``: the output has ``ceil(n / s)``
voxels an axis, and the input is padded by ``total = max((out - 1) * s + k
- n, 0)``, ``total // 2`` before and the rest after. Every conv is
``F.conv3d`` (``F.conv2d``) in float32 with TF32 off. The weights are the
flax tree of ``weights.load_flax_variables``: ``Conv_0``, ``Conv_1`` (the
stem), ``ResNetBlock_b/Conv_k`` (the shortcut last), ``ConvBlock_0/Conv_0``
(the feature conv), ``head_prob``, ``head_dist``.

``precision="fp8"`` is the control, as in ``unet.py``: every conv's input
and weights rounded to float8 e4m3 (one scale per tensor), the conv in
float32 on the rounded values.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .unet import fp8_round, no_tf32, prepools


def same_pads(sizes, ks, strides):
    """flax's ``padding="SAME"``: (before, after) per spatial axis."""
    pads = []
    for n, k, s in zip(sizes, ks, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


class PlainResNet:
    """prob and dist maps of a ResNet StarDist model (``config`` the model's
    config.json as a dict, ``params`` the flax ``params`` tree)."""

    def __init__(self, config, params, device, precision="float32"):
        if config.get("backbone") != "resnet" or config.get("n_classes") is not None:
            raise ValueError("the plain ResNet forward covers ResNet models without classes")
        if config.get("resnet_batch_norm") or config.get("resnet_activation") != "relu":
            raise ValueError("the plain ResNet forward covers relu ResNets without batch norm")
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.nd = int(config["n_dim"])
        self.grid = tuple(int(g) for g in config["grid"])
        self.n_conv = int(config["resnet_n_conv_per_block"])
        n_blocks = int(config["resnet_n_blocks"])
        pools = prepools(self.grid)
        if len(pools) > n_blocks:
            raise ValueError(f"{n_blocks} blocks cannot reach the grid {self.grid}")
        self.pools = pools + [(1,) * self.nd] * (n_blocks - len(pools))
        self.precision = precision
        self.device = torch.device(device)

        def conv(p):
            w = torch.from_numpy(np.array(p["kernel"], np.float32))
            w = w.permute(self.nd + 1, self.nd, *range(self.nd)).contiguous()  # (Cout, Cin, k...)
            return (w.to(self.device), torch.from_numpy(np.array(p["bias"], np.float32))
                    .to(self.device))

        self.stem = [conv(params["Conv_0"]), conv(params["Conv_1"])]
        self.blocks = []
        for b in range(n_blocks):
            blk = params[f"ResNetBlock_{b}"]
            convs = [conv(blk[f"Conv_{k}"]) for k in range(self.n_conv)]
            short = blk.get(f"Conv_{self.n_conv}")
            self.blocks.append((convs, None if short is None else conv(short)))
        feat = params.get("ConvBlock_0")
        self.feat = None if feat is None else conv(feat["Conv_0"])
        self.head_prob = conv(params["head_prob"])
        self.head_dist = conv(params["head_dist"])

    def _conv(self, h, wb, stride=1, act=True):
        w, b = wb
        if self.precision == "fp8":
            h, w = fp8_round(h), fp8_round(w)
        strides = (stride,) * self.nd if np.isscalar(stride) else tuple(stride)
        pads = same_pads(h.shape[2:], w.shape[2:], strides)
        h = F.pad(h, [p for lo_hi in reversed(pads) for p in lo_hi])
        h = (F.conv2d if self.nd == 2 else F.conv3d)(h, w, b, stride=strides)
        return torch.relu(h) if act else h

    def _block(self, x, convs, short, pool):
        y = x
        for k, wb in enumerate(convs):
            y = self._conv(y, wb, pool if k == 0 else 1, act=k < len(convs) - 1)
        if short is not None:
            x = self._conv(x, short, pool, act=False)
        return torch.relu(x + y)

    def __call__(self, img):
        """img (*sp) or (*sp, 1) -> prob (*sp') and dist (R, *sp'), float32 on
        the device, sp' = ceil(sp / grid)."""
        x = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        if x.dim() == self.nd + 1:
            x = x[..., 0]
        h = x[None, None]
        with torch.no_grad(), no_tf32():
            for wb in self.stem:
                h = self._conv(h, wb, act=False)
            for (convs, short), pool in zip(self.blocks, self.pools):
                h = self._block(h, convs, short, pool)
            if self.feat is not None:
                h = self._conv(h, self.feat)
            prob = torch.sigmoid(self._conv(h, self.head_prob, act=False))[0, 0]
            dist = self._conv(h, self.head_dist, act=False)[0]
        return prob, dist
