"""3x3 and 3x3x3 SAME convolution + bias + activation (counterparts of
``stardist_tpu/ops/conv_pallas.py::conv2d_hcw`` and ``conv3d_hcw``).

On a CUDA tensor the convolution runs in a hand-written kernel
(``csrc/conv3x3.cu`` in 2D, ``csrc/conv3x3x3.cu`` in 3D; bf16 in and out,
f32 accumulation); on a CPU tensor it runs in the plain PyTorch version
(:func:`conv3x3_hwc_plain`, :func:`conv3x3x3_dhwc_plain`). The model keeps
its activations channels-last, ``(H, W, C)`` or ``(D, H, W, C)``, and calls
:func:`conv3x3_hwc` / :func:`conv3x3x3_dhwc`; :func:`conv2d_hcw` and
:func:`conv3d_hcw` keep the JAX functions' ``(H, C, W)`` / ``(D, H, C, W)``
signatures.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import CudaKernel, stream_ptr

ACTS = {"linear": 0, "relu": 1, "elu": 2}

KERNEL = CudaKernel(
    "conv3x3.cu", "conv3x3_bf16_hwc",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
KERNEL3D = CudaKernel(
    "conv3x3x3.cu", "conv3x3x3_bf16_dhwc",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _activate(y, act):
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "elu":
        return torch.where(y > 0, y, torch.expm1(y))
    if act == "linear":
        return y
    raise ValueError(f"unknown activation {act!r}")


def _pad_channels(x, w):
    """Zero-pad C to a multiple of 8 (the C_in = 1 first layer), as
    conv_pallas.py does; zero channels times zero weights add nothing.
    x (..., C), w (3, ..., 3, C, Cout)."""
    C = x.shape[-1]
    Cp = -(-C // 8) * 8
    if Cp != C:
        x = F.pad(x, (0, Cp - C))
        w = F.pad(w, (0, 0, 0, Cp - C))
    return x, w


def _conv_plain(x, w, b, act):
    """Plain PyTorch version of both convs. x (*sp, C) channels-last with
    2 or 3 spatial dims, w (3,)*nd + (C, Cout), b (Cout,).

    A bf16 input is computed as the kernels do: bf16 operands, f32 sums,
    bias and activation in f32, output rounded to bf16. A float32 input is
    computed and returned in float32 (the reference's f32 forward)."""
    nd = x.dim() - 1
    out_dtype = x.dtype
    xf = x.float().movedim(-1, 0)[None]                         # (1, C, *sp)
    wf = w.to(x.dtype).float().permute(nd + 1, nd, *range(nd))  # (Cout, C, 3, ...)
    conv = F.conv2d if nd == 2 else F.conv3d
    y = conv(xf, wf, None if b is None else b.float(), padding=1)
    y = _activate(y[0].movedim(0, -1), act)                     # (*sp, Cout)
    return y.to(out_dtype).contiguous()


def conv3x3_hwc_plain(x, w, b=None, act="relu"):
    """Plain PyTorch 3x3 conv. x (H, W, C), w (3, 3, C, Cout) HWIO, b (Cout,)."""
    return _conv_plain(x, w, b, act)


def conv3x3x3_dhwc_plain(x, w, b=None, act="relu"):
    """Plain PyTorch 3x3x3 conv. x (D, H, W, C), w (3, 3, 3, C, Cout)
    DHWIO, b (Cout,)."""
    return _conv_plain(x, w, b, act)


def _conv_cuda(kernel, x, w, b, act):
    """Launch ``kernel`` on channels-last bf16 x (*sp, C) -> (*sp, Cout) bf16.
    C and Cout are zero-padded to multiples of 8 (the kernels' 16-byte
    loads); the padded output channels are cut off again."""
    nd = w.dim() - 2
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the conv kernel takes bfloat16 activations, got {x.dtype}")
    if x.dim() != nd + 1 or w.shape[:nd] != (3,) * nd or w.shape[nd] != x.shape[-1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    x, w = _pad_channels(x, w)
    Cout = w.shape[-1]
    Cp = -(-Cout // 8) * 8
    wk = w.to(torch.bfloat16)
    bk = torch.zeros(Cout, device=x.device) if b is None else b.float()
    if Cp != Cout:
        wk = F.pad(wk, (0, Cp - Cout))
        bk = F.pad(bk, (0, Cp - Cout))
    x = x.contiguous()
    wk = wk.contiguous()
    bk = bk.contiguous()
    y = torch.empty(x.shape[:-1] + (Cp,), dtype=torch.bfloat16, device=x.device)
    kernel.launch(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wk.data_ptr()),
                  ctypes.c_void_p(bk.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                  *x.shape, Cp, ACTS[act], stream_ptr(x.device))
    return y if Cp == Cout else y[..., :Cout].contiguous()


def conv3x3_hwc_cuda(x, w, b=None, act="relu"):
    """Launch ``csrc/conv3x3.cu``. x (H, W, C) bf16 CUDA -> (H, W, Cout) bf16."""
    return _conv_cuda(KERNEL, x, w, b, act)


def conv3x3x3_dhwc_cuda(x, w, b=None, act="relu"):
    """Launch ``csrc/conv3x3x3.cu``. x (D, H, W, C) bf16 CUDA ->
    (D, H, W, Cout) bf16."""
    return _conv_cuda(KERNEL3D, x, w, b, act)


def _dispatch(cuda_fn, plain_fn, x, w, b, act):
    """CUDA tensor: the kernel (bf16 only); CPU tensor: the plain version."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.is_cuda:
        return cuda_fn(x, w, b, act)
    if x.device.type != "cpu":
        raise RuntimeError(f"no conv kernel for device {x.device}")
    return plain_fn(x, w, b, act)


def conv3x3_hwc(x, w, b=None, act="relu"):
    """3x3 SAME conv on channels-last (H, W, C). CUDA tensor: the kernel
    (bf16 only); CPU tensor: :func:`conv3x3_hwc_plain`."""
    return _dispatch(conv3x3_hwc_cuda, conv3x3_hwc_plain, x, w, b, act)


def conv3x3x3_dhwc(x, w, b=None, act="relu"):
    """3x3x3 SAME conv on channels-last (D, H, W, C). CUDA tensor: the
    kernel (bf16 only); CPU tensor: :func:`conv3x3x3_dhwc_plain`."""
    return _dispatch(conv3x3x3_dhwc_cuda, conv3x3x3_dhwc_plain, x, w, b, act)


def conv2d_hcw(x, w, b=None, act="relu"):
    """Same contract as ``stardist_tpu.ops.conv_pallas.conv2d_hcw``:
    x (H, C, W) any float dtype, computed in bfloat16; w (3, 3, C, Cout);
    returns (H, Cout, W) bfloat16."""
    y = conv3x3_hwc(x.to(torch.bfloat16).transpose(-1, -2).contiguous(), w, b, act)
    return y.transpose(-1, -2).contiguous()


def conv3d_hcw(x, w, b=None, act="relu"):
    """Same contract as ``stardist_tpu.ops.conv_pallas.conv3d_hcw``:
    x (D, H, C, W) any float dtype, computed in bfloat16; w (3, 3, 3, C,
    Cout) DHWIO; returns (D, H, Cout, W) bfloat16."""
    y = conv3x3x3_dhwc(x.to(torch.bfloat16).transpose(-1, -2).contiguous(), w, b, act)
    return y.transpose(-1, -2).contiguous()
