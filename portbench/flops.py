"""The benchmark's own count of a StarDist network's convs, from the model's
config.json and the input's spatial shape (upstream StarDist's networks.
The U-Net: convs at the filter base and max-pools until the input is
pooled to the grid, the csbdeep U-Net, the feature conv, the 1x1 heads.
The ResNet, ``backbone: "resnet"``: the 7^nd and 3^nd stem convs, the
residual blocks, strided until the grid is reached, with their 1x1
projection shortcuts, the feature conv, the 1x1 heads; see
``reference/resnet.py``)."""
from __future__ import annotations

import numpy as np

from .reference.unet import prepools


def conv_layers(cfg, shape):
    """[((*sp, C), Cout, taps)] of every conv of one forward on an input of
    spatial ``shape``, the 1x1 heads last: C the conv's input channels and
    sp its output grid, so that a strided conv counts its output voxels
    (the U-Net's convs keep their input's grid)."""
    if cfg.get("backbone") == "resnet":
        return resnet_layers(cfg, shape)
    k = int(np.prod(cfg["unet_kernel_size"]))
    base, n_conv = int(cfg["unet_n_filter_base"]), int(cfg["unet_n_conv_per_depth"])
    depth, pool = int(cfg["unet_n_depth"]), tuple(cfg["unet_pool"])
    sp, c = tuple(int(s) for s in shape), int(cfg["n_channel_in"])
    out = []

    def conv(cout, taps=k):
        nonlocal c
        out.append(((*sp, c), cout, taps))
        c = cout

    def down(p):
        nonlocal sp
        sp = tuple(s // f for s, f in zip(sp, p))

    for p in prepools(cfg["grid"]):
        for _ in range(n_conv):
            conv(base)
        down(p)
    skips = []
    for n in range(depth):
        for _ in range(n_conv):
            conv(base * 2 ** n)
        skips.append((sp, c))
        down(pool)
    for _ in range(n_conv - 1):
        conv(base * 2 ** depth)
    conv(base * 2 ** max(0, depth - 1))
    for n in reversed(range(depth)):
        sp, c = skips[n][0], c + skips[n][1]
        for _ in range(n_conv - 1):
            conv(base * 2 ** n)
        conv(base * 2 ** max(0, n - 1))
    if int(cfg["net_conv_after_unet"]) > 0:
        conv(int(cfg["net_conv_after_unet"]))
    conv(1 + int(cfg["n_rays"]), taps=1)
    return out


def resnet_layers(cfg, shape):
    """:func:`conv_layers` of a ResNet: a strided SAME conv gives ceil(n / s)
    voxels an axis; a block that pools doubles the width and has the 1x1
    shortcut, after its convs as in the flax tree."""
    nd, n_conv = len(shape), int(cfg["resnet_n_conv_per_block"])
    k = int(np.prod(cfg["resnet_kernel_size"]))
    pools = prepools(cfg["grid"])
    pools += [(1,) * nd] * (int(cfg["resnet_n_blocks"]) - len(pools))
    sp, c = tuple(int(s) for s in shape), int(cfg["resnet_n_filter_base"])
    out = [((*sp, int(cfg["n_channel_in"])), c, 7 ** nd), ((*sp, c), c, 3 ** nd)]
    for pool in pools:
        strided = any(p > 1 for p in pool)
        cout = 2 * c if strided else c
        sp = tuple(-(-s // p) for s, p in zip(sp, pool))
        out += [((*sp, c), cout, k)] + [((*sp, cout), cout, k)] * (n_conv - 1)
        if strided:
            out.append(((*sp, c), cout, 1))
        c = cout
    if int(cfg["net_conv_after_resnet"]) > 0:
        out.append(((*sp, c), int(cfg["net_conv_after_resnet"]), k))
        c = int(cfg["net_conv_after_resnet"])
    out.append(((*sp, c), 1 + int(cfg["n_rays"]), 1))
    return out


def forward_flops(cfg, shape):
    """FLOPs of one forward: 2 * taps * C * Cout per output pixel, summed."""
    return sum(2 * taps * s[-1] * cout * int(np.prod(s[:-1]))
               for s, cout, taps in conv_layers(cfg, shape))
