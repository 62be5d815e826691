"""Label rasterization of star polygons with the wedge test of the TPU tile
kernel (counterpart of ``stardist_tpu/ops/raster_pallas.py::
rasterize_polygons_tiles``).

Per pixel, the largest packed value ``(order << 32) | (label + 1)`` among
the polygons whose splat window (side ``window`` from ``round(p) - window
// 2``) covers it and that contain it. A pixel is inside a polygon if it is
the centre, or if for some ray r it lies in wedge r by two cross-product
signs (``c_r*ur - s_r*uc >= 0`` and ``c_{r+1}*ur - s_{r+1}*uc < 0``) and
passes the edge test ``cross_p * cross_c >= 0``. The int64 packing has no
16-bit limit, so unlike the reference nothing is declined.

:func:`rasterize_polygons_tiles_cuda` launches ``csrc/raster_tiles.cu``
(a wedge lookup, a box of pixels per polygon, a persistent grid; a 32-bit
packing when the caller bounds the values below 2^16) on CUDA tensors; it
is the 2D raster of :func:`.rasterize.rasterize_polygons` on the card.
:func:`rasterize_polygons_tiles_plain` is its plain version on any device,
the splat loop of :mod:`.rasterize` with this inside test, which agrees
with the kernel bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "raster_tiles.cu", "raster_labels",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    extra_flags=("-fmad=false",))
PACK32_MAX = 0xFFFF  # the largest order value and label + 1 of the 32-bit packing

_PLAIN_ELEMS = 1 << 21  # polygons x window^2 per step of the plain version


def tile_window(dmax, shape):
    """Splat window of the tile kernel: 2*ceil(max dist)+4, capped by the
    image (``rasterize_polygons_tiles`` of the reference)."""
    window = 2 * int(np.ceil(float(dmax))) + 4
    return int(min(window, 2 * max(shape) + 4))


@functools.lru_cache(maxsize=None)
def _tables(R, device):
    """The two (4, R) f32 trig tables, made once per (R, device): the
    feature table [sin, cos] of ``arange(R) * 2pi/R`` and of the same plus
    2pi/R, and the wedge table [sin phi_r, cos phi_r, sin phi_r+1, cos
    phi_r+1] of ``arange(R + 1) * 2pi/R``. Both are formed in f64 and cast,
    each as the reference forms it, so that the f32 roundings agree bit for
    bit."""
    step = 2.0 * np.pi / R
    a = np.arange(R) * step
    feat = np.stack([np.sin(a), np.cos(a), np.sin(a + step), np.cos(a + step)])
    w = np.arange(R + 1) * step
    wedge = np.stack([np.sin(w[:R]), np.cos(w[:R]), np.sin(w[1:]), np.cos(w[1:])])
    return tuple(torch.from_numpy(t.astype(np.float32)).to(device) for t in (feat, wedge))


def _setup(dist, points, shape, order_values, labels):
    """The kernel's inputs, computed with torch on the inputs' device:
    features (N, 4R) ``d*s0 | d*c0 | d1*s1 | d1*c1`` (one f32 product each,
    the reference's feature rows), centres (N, 2) f32, window origins (N, 2)
    int32, packed values (N,) int64 (0 = not drawn) and the window
    (:func:`tile_window` of the largest dist)."""
    dev = dist.device
    dist = dist.to(torch.float32)
    points = points.to(dev, torch.float32).contiguous()
    window = tile_window(dist.max().item(), shape)
    trig = _tables(dist.shape[1], dev)[0]
    d1 = torch.roll(dist, -1, dims=1)
    feats = torch.cat([dist * trig[0], dist * trig[1], d1 * trig[2], d1 * trig[3]],
                      dim=1).contiguous()
    origin = (torch.round(points).to(torch.int32) - window // 2).contiguous()
    order_values = order_values.to(dev, torch.int64)
    labs = order_values if labels is None else labels.to(dev, torch.int64) + 1
    packed = torch.where(order_values > 0, (order_values << 32) | labs,
                         torch.zeros_like(order_values)).contiguous()
    return feats, points, origin, packed, window


def unpack_labels(img, shape, out_dtype):
    """int64 packed image -> the winner's label (low 32 bits) in ``out_dtype``
    (int32, or uint16 when every value fits in 16 bits)."""
    if out_dtype == torch.uint16:
        return (img & 0xFFFF).to(torch.uint16).view(shape)
    if out_dtype != torch.int32:
        raise ValueError(f"out_dtype must be torch.int32 or torch.uint16, got {out_dtype}")
    return (img & 0xFFFFFFFF).to(torch.int32).view(shape)


def _inside_wedges(feats, ur, uc):
    """Inside test of pixels (ur, uc) (n, P), relative to the centres,
    against the polygons of ``feats`` (n, 4R): the TPU kernel's body, one
    torch op per rounding."""
    R = feats.shape[1] // 4
    s_l, c_l, s_h, c_h = _tables(R, torch.device("cpu"))[1].tolist()
    inside = (ur == 0.0) & (uc == 0.0)
    for r in range(R):
        lo = ur * c_l[r] - uc * s_l[r]
        hi = ur * c_h[r] - uc * s_h[r]
        wedge = (lo >= 0.0) & (hi < 0.0)
        v0r = feats[:, r:r + 1]
        v0c = feats[:, R + r:R + r + 1]
        er = feats[:, 2 * R + r:2 * R + r + 1] - v0r
        ec = feats[:, 3 * R + r:3 * R + r + 1] - v0c
        cross_p = er * (uc - v0c) - ec * (ur - v0r)
        cross_c = ec * v0r - er * v0c
        inside |= wedge & (cross_p * cross_c >= 0.0)
    return inside


def rasterize_polygons_tiles_plain(dist, points, shape, order_values, labels=None,
                                   out_dtype=torch.int32):
    """Per pixel, the polygon with the largest positive order value wins.

    dist (N, R), points (N, 2), order_values (N,) int (0 = never drawn),
    labels (N,) int or None; tensors on one device (any device). Returns an
    (H, W) tensor of ``out_dtype`` on that device: the winner's
    ``labels[i] + 1`` (its order value when ``labels`` is None), 0 for
    background. The plain version of the CUDA kernel: chunks of polygons,
    the window's pixels of each, the wedge test, and a scatter-max of the
    packed values."""
    H, W = (int(s) for s in shape)
    img = torch.zeros(H * W, dtype=torch.int64, device=dist.device)
    if dist.shape[0] == 0:
        return unpack_labels(img, (H, W), out_dtype)
    feats, points, origin, packed, window = _setup(dist, points, (H, W), order_values,
                                                   labels)
    ar = torch.arange(window, dtype=torch.int32, device=dist.device)
    chunk = max(1, _PLAIN_ELEMS // (window * window))
    for i0 in range(0, feats.shape[0], chunk):
        sl = slice(i0, i0 + chunk)
        n = feats[sl].shape[0]
        rr = origin[sl, 0:1] + ar[None]                          # (n, Wn)
        cc = origin[sl, 1:2] + ar[None]
        ur = rr.float()[:, :, None] - points[sl, 0, None, None]  # (n, Wn, 1)
        uc = cc.float()[:, None, :] - points[sl, 1, None, None]  # (n, 1, Wn)
        ur, uc = (t.reshape(n, -1) for t in torch.broadcast_tensors(ur, uc))
        inside = _inside_wedges(feats[sl], ur, uc) & (packed[sl] > 0)[:, None]
        in_img = (((rr >= 0) & (rr < H))[:, :, None]
                  & ((cc >= 0) & (cc < W))[:, None, :]).reshape(n, -1)
        inside &= in_img
        flat = (rr.long()[:, :, None] * W + cc.long()[:, None, :]).reshape(n, -1)
        vals = packed[sl, None].expand_as(flat)
        img.scatter_reduce_(0, flat[inside], vals[inside], reduce="amax")
    return unpack_labels(img, (H, W), out_dtype)


def kernel_inputs(dist, points, order_values, labels):
    """The kernel's inputs on the card, with no host sync: dist (N, R) and
    centres (N, 2) f32, order values and labels (N,) int64 (labels may be
    None), and the largest dist as a one-element tensor."""
    dist = dist.to(torch.float32).contiguous()
    return (dist, points.to(torch.float32).contiguous(),
            order_values.to(torch.int64).contiguous(),
            None if labels is None else labels.to(torch.int64).contiguous(),
            dist.amax().reshape(1) if dist.numel() else dist.new_zeros(1))


def draw(inputs, shape, pack32):
    """Zero a packed label image ((H * W,) int32 with ``pack32``, else
    int64) and launch the kernel on ``inputs`` (:func:`kernel_inputs`)."""
    dist = inputs[0]
    H, W = shape
    img = torch.zeros(H * W, dtype=torch.int32 if pack32 else torch.int64, device=dist.device)
    N, R = dist.shape
    if N > 0:
        tabs = _tables(R, dist.device)
        ptrs = [ctypes.c_void_p(0 if t is None else t.data_ptr()) for t in (*inputs, *tabs, img)]
        KERNEL.launch(*ptrs, N, R, H, W, 32 if pack32 else 64, stream_ptr(dist.device))
    return img


def narrow(img, shape, out_dtype):
    """The packed image of :func:`draw` -> the winners' labels: the int64
    image through :func:`unpack_labels`; the int32 one (low 16 bits) in
    place to int32, or by one copy to uint16."""
    if img.dtype == torch.int64:
        return unpack_labels(img, shape, out_dtype)
    if out_dtype == torch.uint16:
        return img.view(torch.uint16)[0::2].reshape(shape)   # little-endian low halves
    if out_dtype != torch.int32:
        raise ValueError(f"out_dtype must be torch.int32 or torch.uint16, got {out_dtype}")
    return img.bitwise_and_(PACK32_MAX).view(shape)


def rasterize_polygons_tiles_cuda(dist, points, shape, order_values, labels=None,
                                  out_dtype=torch.int32, *, value_bound=None):
    """:func:`rasterize_polygons_tiles_plain` on CUDA tensors: launches
    ``csrc/raster_tiles.cu``, or raises. It makes no host sync.

    ``value_bound``, where the caller knows one, is at least every order
    value and every ``labels[i] + 1`` (every order value without labels);
    when it is at most ``PACK32_MAX`` the kernel packs into 32 bits and no
    int64 image is made. The bound is the caller's promise: it is not
    checked."""
    N, R = dist.shape
    for t, sh in ((dist, (N, R)), (points, (N, 2)), (order_values, (N,)),
                  (labels, (N,))):
        if t is not None and (not t.is_cuda or tuple(t.shape) != sh):
            raise ValueError(f"rasterize_polygons_tiles_cuda: bad input {tuple(t.shape)} "
                             f"on {t.device}")
    shape = tuple(int(s) for s in shape)
    pack32 = value_bound is not None and value_bound <= PACK32_MAX
    img = draw(kernel_inputs(dist, points, order_values, labels), shape, pack32)
    return narrow(img, shape, out_dtype)
