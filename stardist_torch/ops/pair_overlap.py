"""Sampled overlap fraction of star-polygon pairs (counterpart of
``stardist_tpu/ops/pair_overlap.py::pair_frac``).

For a flat list of P pairs, the fraction of an S x S midpoint grid over the
pair's bbox intersection (``plo``, ``ext``) that lies inside both polygons.
Any S >= 1, as the TPU kernel: the 2D NMS runs S = 8 and its fine grid,
``samples`` (16 by default). On CUDA tensors it runs in
``csrc/pair_overlap.cu`` (a wedge lookup per sample, up to 32 lanes per
pair); on CPU tensors in :func:`pair_frac_plain`,
which follows the TPU kernel's ``_inside_body`` step for step (the
cross-product wedge rule, a walk over every wedge), so that the two agree
bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "pair_overlap.cu", "pair_frac_f32",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    extra_flags=("-fmad=false",))

_PLAIN_CHUNK = 4096  # pairs per step of the plain version (bounds its memory)
S_MAX = 46340        # the largest S whose S * S samples fit an int32


@functools.lru_cache(maxsize=None)
def trig_table(R, device=None):
    """(4, R) f32 [sin phi_k, cos phi_k, sin phi_k+1, cos phi_k+1]: numpy f64
    trig cast to f32, the constants the TPU kernel bakes in; made once per
    (R, device), so that a kernel call copies nothing to the card."""
    dphi = 2 * np.pi / R
    angles = np.arange(R) * dphi
    t = np.stack([np.sin(angles), np.cos(angles),
                  np.sin(angles + dphi), np.cos(angles + dphi)]).astype(np.float32)
    return torch.from_numpy(t).to(device)


@functools.lru_cache(maxsize=None)
def _sample_grid(S, device=None):
    """The grid's (S * S,) f32 row and column fractions (i // S + 0.5) / S
    and (i % S + 0.5) / S as the TPU kernel's formula computes where XLA
    compiles it: times f32(1 / S), the reciprocal rounded once (a division
    at S = 8 and 16, powers of two). Made in numpy on the host, so that it
    is the same on every device."""
    i = np.arange(S * S)
    inv = _f32_reciprocal(S)
    gr = ((i // S).astype(np.float32) + np.float32(0.5)) * inv
    gc = ((i % S).astype(np.float32) + np.float32(0.5)) * inv
    return torch.from_numpy(gr).to(device), torch.from_numpy(gc).to(device)


def _f32_reciprocal(n):
    return np.float32(1) / np.float32(n)


def _inside_plain(d, p_r, p_c, qr, qc, trig):
    """Inside test of samples (qr, qc) (P, NS) against polygons d (P, R)
    centred at (p_r, p_c) (P, 1) — ``_inside_body`` of the TPU kernel."""
    R = d.shape[-1]
    s0, c0, s1, c1 = (t.tolist() for t in trig.cpu())
    ur = qr - p_r
    uc = qc - p_c

    def cr(k):
        return ur * c0[k % R] - uc * s0[k % R]

    cr0 = cr(0)
    prev = cr0
    v0r = torch.zeros_like(ur)
    v0c = torch.zeros_like(ur)
    v1r = torch.zeros_like(ur)
    v1c = torch.zeros_like(ur)
    for k in range(R):
        nxt = cr0 if k == R - 1 else cr(k + 1)
        w = ((prev >= 0) & (nxt < 0)).to(d.dtype)
        prev = nxt
        a = d[:, k:k + 1]
        b = d[:, (k + 1) % R:(k + 1) % R + 1]
        v0r = v0r + w * (a * s0[k])
        v0c = v0c + w * (a * c0[k])
        v1r = v1r + w * (b * s1[k])
        v1c = v1c + w * (b * c1[k])
    er = v1r - v0r
    ec = v1c - v0c
    cross_p = er * (uc - v0c) - ec * (ur - v0r)
    cross_c = ec * v0r - er * v0c
    return cross_p * cross_c >= 0


def pair_frac_plain(d_r, p_r, d_c, p_c, plo, ext, S=16):
    """Plain PyTorch version of :func:`pair_frac` (any device, any S >= 1)."""
    P, R = d_r.shape
    trig = trig_table(R)
    gr, gc = _sample_grid(S, d_r.device)
    inv_n = float(_f32_reciprocal(S * S))          # the count times f32(1 / S^2)
    out = torch.empty(P, dtype=torch.float32, device=d_r.device)
    chunk = max(1, min(_PLAIN_CHUNK, _PLAIN_CHUNK * 256 // (S * S)))  # S = 16's memory at most
    for i0 in range(0, P, chunk):
        sl = slice(i0, i0 + chunk)
        qr = plo[sl, 0:1] + gr[None] * ext[sl, 0:1]
        qc = plo[sl, 1:2] + gc[None] * ext[sl, 1:2]
        in_r = _inside_plain(d_r[sl], p_r[sl, 0:1], p_r[sl, 1:2], qr, qc, trig)
        in_c = _inside_plain(d_c[sl], p_c[sl, 0:1], p_c[sl, 1:2], qr, qc, trig)
        both = (in_r & in_c).to(torch.float32)
        out[sl] = both.sum(dim=1) * inv_n
    return out


def pair_frac_cuda(d_r, p_r, d_c, p_c, plo, ext, S=16):
    """Launch ``csrc/pair_overlap.cu`` on CUDA f32 tensors."""
    S = int(S)
    if not 1 <= S <= S_MAX:
        raise ValueError(f"S must be in [1, {S_MAX}], got {S}")
    P, R = d_r.shape
    args = [t.to(torch.float32).contiguous() for t in (d_r, p_r, d_c, p_c, plo, ext)]
    for t, cols in zip(args, (R, 2, R, 2, 2, 2)):
        if not t.is_cuda or t.shape != (P, cols):
            raise ValueError(f"pair_frac_cuda: bad input {tuple(t.shape)} on {t.device}")
    out = torch.empty(P, dtype=torch.float32, device=d_r.device)
    if P == 0:
        return out
    trig = trig_table(R, d_r.device)
    KERNEL.launch(*(ctypes.c_void_p(t.data_ptr()) for t in args),
                  ctypes.c_void_p(trig.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                  P, R, S, stream_ptr(d_r.device))
    return out


def pair_frac(d_r, p_r, d_c, p_c, plo, ext, S=16):
    """S x S midpoint-grid overlap fraction for a flat pair list.

    d_r, d_c (P, R) dists of the two polygons, p_r, p_c (P, 2) centres,
    plo, ext (P, 2) corner and extent of the bbox intersection; any S >= 1
    (up to ``S_MAX``, where S * S still fits an int32).
    Returns (P,) float32."""
    if d_r.is_cuda:
        return pair_frac_cuda(d_r, p_r, d_c, p_c, plo, ext, S)
    if d_r.device.type != "cpu":
        raise RuntimeError(f"no pair kernel for device {d_r.device}")
    return pair_frac_plain(d_r, p_r, d_c, p_c, plo, ext, S)
