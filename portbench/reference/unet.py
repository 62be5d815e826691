"""Plain PyTorch forward of a StarDist U-Net, from the model folder alone.

Upstream StarDist's network (stardist/models/model2d.py and model3d.py,
``_build``): convs and max-pools until the input is pooled to the grid,
the csbdeep U-Net (``n_conv`` SAME convs a level, max-pool, nearest
upsampling, the upsampled map concatenated before the skip), the feature
conv ``net_conv_after_unet``, then the 1x1 heads: sigmoid prob and linear
dist. Every conv is ``F.conv2d`` / ``F.conv3d`` in float32 with TF32 off.
The weights are the flax tree of ``weights.load_flax_variables``.

``precision="fp8"`` is the control: every conv's input and weights are
rounded to float8 e4m3 (one scale per tensor, its largest magnitude at
448) and the conv runs in float32 on the rounded values.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """Float32 convs and matmuls in full float32 on the card."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def fp8_round(t):
    """t rounded to float8 e4m3 with one scale for the tensor, back in float32."""
    s = t.abs().amax().clamp_min(1e-30).float() / FP8_MAX
    return (t.float() / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def prepools(grid):
    """The pooling factors applied before the U-Net (upstream's loop that
    pools the input to the grid, one factor of at most 2 per axis a step)."""
    pooled, out = np.ones(len(grid), int), []
    while tuple(pooled) != tuple(grid):
        pool = 1 + (np.asarray(grid) > pooled)
        pooled = pooled * pool
        out.append(tuple(int(p) for p in pool))
    return out


class PlainStarDist:
    """prob and dist maps of a U-Net StarDist model (``config`` the model's
    config.json as a dict, ``params`` the flax ``params`` tree)."""

    def __init__(self, config, params, device, precision="float32"):
        if config.get("backbone", "unet") != "unet" or config.get("n_classes") is not None:
            raise ValueError("the plain forward covers U-Net models without classes")
        if config.get("unet_batch_norm") or config.get("unet_activation") != "relu" \
                or config.get("unet_last_activation") != "relu":
            raise ValueError("the plain forward covers relu U-Nets without batch norm")
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.nd = int(config["n_dim"])
        self.grid = tuple(int(g) for g in config["grid"])
        self.n_depth = int(config["unet_n_depth"])
        self.n_conv = int(config["unet_n_conv_per_depth"])
        self.pool = tuple(int(p) for p in config["unet_pool"])
        self.n_feat = int(config["net_conv_after_unet"])
        self.prepools = prepools(self.grid)
        self.precision = precision
        self.device = torch.device(device)

        def conv(p):
            w = torch.from_numpy(np.array(p["kernel"], np.float32))
            w = w.permute(self.nd + 1, self.nd, *range(self.nd)).contiguous()  # (Cout, Cin, k...)
            return (w.to(self.device), torch.from_numpy(np.array(p["bias"], np.float32))
                    .to(self.device))

        n_top = len(self.prepools) * self.n_conv
        self.top = [conv(params[f"ConvBlock_{k}"]["Conv_0"]) for k in range(n_top)]
        self.feat = conv(params[f"ConvBlock_{n_top}"]["Conv_0"]) if self.n_feat > 0 else None
        bb = params["UNetBackbone_0"]
        self.backbone = [conv(bb[f"ConvBlock_{k}"]["Conv_0"]) for k in range(len(bb))]
        self.head_prob = conv(params["head_prob"])
        self.head_dist = conv(params["head_dist"])

    def _conv(self, h, wb, act=True):
        w, b = wb
        if self.precision == "fp8":
            h, w = fp8_round(h), fp8_round(w)
        f = F.conv2d if self.nd == 2 else F.conv3d
        h = f(h, w, b, padding=w.shape[-1] // 2)
        return torch.relu(h) if act else h

    def _max_pool(self, h, pool):
        f = F.max_pool2d if self.nd == 2 else F.max_pool3d
        return f(h, kernel_size=pool, stride=pool)

    @staticmethod
    def _upsample(h, pool):
        for ax, p in enumerate(pool):
            if p > 1:
                h = h.repeat_interleave(p, dim=2 + ax)
        return h

    def __call__(self, img):
        """img (*sp) or (*sp, 1), each size a multiple of the network's
        stride -> prob (*sp') and dist (R, *sp'), float32 on the device."""
        x = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        if x.dim() == self.nd + 1:
            x = x[..., 0]
        h = x[None, None]
        with torch.no_grad(), no_tf32():
            top = iter(self.top)
            for p in self.prepools:
                for _ in range(self.n_conv):
                    h = self._conv(h, next(top))
                h = self._max_pool(h, p)
            bb, skips = iter(self.backbone), []
            for _ in range(self.n_depth):
                for _ in range(self.n_conv):
                    h = self._conv(h, next(bb))
                skips.append(h)
                h = self._max_pool(h, self.pool)
            for _ in range(self.n_conv):
                h = self._conv(h, next(bb))
            for n in reversed(range(self.n_depth)):
                h = torch.cat([self._upsample(h, self.pool), skips[n]], dim=1)
                for _ in range(self.n_conv):
                    h = self._conv(h, next(bb))
            if self.feat is not None:
                h = self._conv(h, self.feat)
            prob = torch.sigmoid(self._conv(h, self.head_prob, act=False))[0, 0]
            dist = self._conv(h, self.head_dist, act=False)[0]
        return prob, dist
