"""3x3 SAME convolution + bias + activation (counterpart of
``stardist_tpu/ops/conv_pallas.py::conv2d_hcw``).

On a CUDA tensor the convolution runs in the hand-written kernel
``csrc/conv3x3.cu`` (bf16 in and out, f32 accumulation); on a CPU tensor it
runs in the plain PyTorch version :func:`conv3x3_hwc_plain`. The model keeps
its activations channels-last, ``(H, W, C)``, and calls :func:`conv3x3_hwc`;
:func:`conv2d_hcw` keeps the JAX function's ``(H, C, W)`` signature.
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
    conv_pallas.py does; zero channels times zero weights add nothing."""
    C = x.shape[-1]
    Cp = -(-C // 8) * 8
    if Cp != C:
        x = F.pad(x, (0, Cp - C))
        w = F.pad(w, (0, 0, 0, Cp - C))
    return x, w


def conv3x3_hwc_plain(x, w, b=None, act="relu"):
    """Plain PyTorch version. x (H, W, C), w (3, 3, C, Cout) HWIO, b (Cout,).

    A bf16 input is computed as the kernel does: bf16 operands, f32 sums,
    bias and activation in f32, output rounded to bf16. A float32 input is
    computed and returned in float32 (the reference's f32 forward)."""
    out_dtype = x.dtype
    xf = x.float().permute(2, 0, 1)[None]                  # (1, C, H, W)
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)          # (Cout, C, 3, 3)
    y = F.conv2d(xf, wf, None if b is None else b.float(), padding=1)
    y = _activate(y[0].permute(1, 2, 0), act)               # (H, W, Cout)
    return y.to(out_dtype).contiguous()


def conv3x3_hwc_cuda(x, w, b=None, act="relu"):
    """Launch ``csrc/conv3x3.cu``. x (H, W, C) bf16 CUDA -> (H, W, Cout) bf16."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the conv kernel takes bfloat16 activations, got {x.dtype}")
    if x.dim() != 3 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[-1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    x, w = _pad_channels(x, w)
    H, W, C = x.shape
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
    y = torch.empty((H, W, Cp), dtype=torch.bfloat16, device=x.device)
    KERNEL.launch(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wk.data_ptr()),
                  ctypes.c_void_p(bk.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                  H, W, C, Cp, ACTS[act], stream_ptr(x.device))
    return y if Cp == Cout else y[..., :Cout].contiguous()


def conv3x3_hwc(x, w, b=None, act="relu"):
    """3x3 SAME conv on channels-last (H, W, C). CUDA tensor: the kernel
    (bf16 only); CPU tensor: :func:`conv3x3_hwc_plain`."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.is_cuda:
        return conv3x3_hwc_cuda(x, w, b, act)
    if x.device.type != "cpu":
        raise RuntimeError(f"no conv kernel for device {x.device}")
    return conv3x3_hwc_plain(x, w, b, act)


def conv2d_hcw(x, w, b=None, act="relu"):
    """Same contract as ``stardist_tpu.ops.conv_pallas.conv2d_hcw``:
    x (H, C, W) any float dtype, computed in bfloat16; w (3, 3, C, Cout);
    returns (H, Cout, W) bfloat16."""
    y = conv3x3_hwc(x.to(torch.bfloat16).permute(0, 2, 1).contiguous(), w, b, act)
    return y.permute(0, 2, 1).contiguous()
