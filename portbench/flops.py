"""The benchmark's own count of a StarDist U-Net's convs, from the model's
config.json and the input's spatial shape (upstream StarDist's network:
convs at the filter base and max-pools until the input is pooled to the
grid, the csbdeep U-Net, the feature conv, the 1x1 heads)."""
from __future__ import annotations

import numpy as np

from .reference.unet import prepools


def conv_layers(cfg, shape):
    """[(input shape (*sp, C), Cout, taps)] of every conv of one forward on
    an input of spatial ``shape``, the 1x1 heads last."""
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


def forward_flops(cfg, shape):
    """FLOPs of one forward: 2 * taps * C * Cout per output pixel, summed."""
    return sum(2 * taps * s[-1] * cout * int(np.prod(s[:-1]))
               for s, cout, taps in conv_layers(cfg, shape))
