"""3x3 and 3x3x3 SAME convolution + bias + activation (counterparts of
``stardist_tpu/ops/conv_pallas.py::conv2d_hcw`` and ``conv3d_hcw``).

On a CUDA tensor the convolution runs in a hand-written Hopper kernel
(``csrc/conv_sm90.cuh``, entry points ``csrc/conv3x3.cu`` in 2D and
``csrc/conv3x3x3.cu`` in 3D; bf16 in and out, f32 accumulation); on a CPU
tensor it runs in the plain PyTorch version (:func:`conv3x3_hwc_plain`,
:func:`conv3x3x3_dhwc_plain`). The model keeps its activations
channels-last, ``(H, W, C)`` or ``(D, H, W, C)``, and calls
:func:`conv3x3_hwc` / :func:`conv3x3x3_dhwc`; :func:`conv2d_hcw` and
:func:`conv3d_hcw` keep the JAX functions' ``(H, C, W)`` / ``(D, H, C, W)``
signatures.

What the kernel needs from the host is kept here, where the CPU tests reach
it: :func:`conv_plan` picks the tile shape, the K chunk, whether the
weights stay resident in shared memory and the depth of the copy ring;
:func:`pack_weights` lays the weights out once per layer as the kernel's
shared memory wants them, cached on the weight tensor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .cuda_build import CudaKernel, stream_ptr

ACTS = {"linear": 0, "relu": 1, "elu": 2}

# act, kc, bn, resident, stages, th, tw; the stream
_PLAN_ARGS = [ctypes.c_int] * 7 + [ctypes.c_void_p]
KERNEL = CudaKernel(
    "conv3x3.cu", "conv3x3_bf16_hwc",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + _PLAN_ARGS)
KERNEL3D = CudaKernel(
    "conv3x3x3.cu", "conv3x3x3_bf16_dhwc",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + _PLAN_ARGS)

# The kernel's values of csrc/conv_sm90.cuh (tests/test_torch_conv_plan.py
# reads them out of the header and holds these to them): an SM's shared
# memory, what the system keeps of it per block, a block's fixed parts, the
# ring's largest depth, the output pixels of a tile, the widest N that runs
# two blocks per SM, the N that stage the output tile for a TMA store
SMEM_SM, SMEM_RESERVED, SMEM_SLACK, BAR_BYTES, MAX_STAGES = 233472, 1024, 1024, 256, 8
TILE_M = 128
TWO_BLOCKS_MAX_N = 64
STAGED_STORE_N = (64, 128)
MAX_COUT = 256            # output channels of one launch
BNS = (16, 32, 64, 128, 256)
KCS = (64, 32, 16, 8)     # K chunks: input channels per stage
HALO_PX = 6 * 34          # the largest halo box of a tile :func:`tile_shape` picks (4 x 32)


class ConvPlan(NamedTuple):
    kc: int         # input channels per stage (the halo box's inner size)
    bn: int         # output channels computed (wgmma N), >= Cout of the launch
    resident: bool  # all weights in shared memory (else one slice per stage)
    stages: int     # depth of the copy ring
    th: int         # tile rows and
    tw: int         # columns: th * tw = TILE_M output pixels of one plane


def _align1024(n):
    return -(-n // 1024) * 1024


def steps_per_stage(kc):
    """k16 steps of one stage: 9 taps x kc channels, padded to 16."""
    return -(-9 * kc // 16)


def smem_bytes(kc, bn, planes, n_chunks, resident, stages, halo_px):
    """Dynamic shared memory of the kernel (``Layout`` in conv_sm90.cuh):
    the resident weights, the output tile (staged for a TMA store at N = 64
    and 128), the ring, the barriers."""
    halo = _align1024(2 * kc * halo_px)
    wslice = steps_per_stage(kc) * bn * 32
    stage = halo + (0 if resident else _align1024(wslice))
    weights = n_chunks * planes * wslice if resident else 0
    out = 2 * TILE_M * bn if bn in STAGED_STORE_N else 0
    return SMEM_SLACK + _align1024(weights) + out + stages * stage + BAR_BYTES


def smem_limit(bn):
    """Shared memory of one block: two blocks share an SM at N <= 64."""
    return SMEM_SM // (2 if bn <= TWO_BLOCKS_MAX_N else 1) - SMEM_RESERVED


def tile_shape(W):
    """(rows, columns) of an output tile: 32 columns (4 rows), or 16 / 8
    columns for a narrower image, so that few of a tile's 128 pixels fall
    past the right edge."""
    tw = 8 if W <= 8 else 16 if W <= 16 else 32
    return TILE_M // tw, tw


@functools.lru_cache(maxsize=None)
def _chunking(C, bn, planes):
    """(kc, resident) of a layer: resident weights if they fit beside a ring
    of 3 stages, else weights streamed per stage; the largest kc that
    divides C either way. Reckoned with the largest halo box of any tile
    shape, so that kc (and with it the order of every pixel's sum) depends
    on the layer alone and not on the image size."""
    for resident in (True, False):
        for kc in KCS:
            if C % kc == 0 and smem_bytes(kc, bn, planes, C // kc, resident, 3,
                                          HALO_PX) <= smem_limit(bn):
                return kc, resident
    raise ValueError(f"no conv plan fits shared memory for C={C}, N={bn}")


def conv_plan(spatial, C, cout):
    """The kernel's plan for a layer: ``spatial`` (H, W) or (D, H, W), C
    input channels (a multiple of 8), ``cout`` <= 256 output channels."""
    if C % 8 or not 0 < cout <= MAX_COUT:
        raise ValueError(f"no conv plan for C={C}, Cout={cout}")
    planes = 3 if len(spatial) == 3 else 1
    bn = next(b for b in BNS if b >= cout)
    kc, resident = _chunking(C, bn, planes)
    th, tw = tile_shape(spatial[-1])
    halo_px = (th + 2) * (tw + 2)
    stages = max(s for s in range(3, MAX_STAGES + 1)
                 if smem_bytes(kc, bn, planes, C // kc, resident, s, halo_px) <= smem_limit(bn))
    return ConvPlan(kc, bn, resident, stages, th, tw)


def pack_weights(w, kc, bn, co0=0):
    """The kernel's weight image for output channels co0..co0+bn-1: w (3,)*nd
    + (C, Cout) -> bf16 (n_chunks * planes * steps * bn * 16,).

    Order: K chunk of kc input channels, input plane dz (one in 2D), k16
    step, then the step's B tile as wgmma reads it from shared memory
    (K-major, no swizzle): 8x8 core matrices (8 output channels x 8 k, k
    contiguous), the two k halves of a step side by side, then the next 8
    output channels. k within a stage is tap * kc + c, tap = 3 * dy + dx;
    C is zero-padded to a multiple of kc, k to the step's 16 and the output
    channels to bn."""
    nd = w.dim() - 2
    C = w.shape[-2]
    planes = 3 if nd == 3 else 1
    Cp = -(-C // kc) * kc
    nch, steps = Cp // kc, steps_per_stage(kc)
    wk = w.to(torch.bfloat16)[..., co0:co0 + bn]
    wk = F.pad(wk, (0, bn - wk.shape[-1], 0, Cp - C))
    wk = wk.reshape(planes, 9, nch, kc, bn).permute(2, 0, 1, 3, 4)
    wk = wk.reshape(nch, planes, 9 * kc, bn)
    wk = F.pad(wk, (0, 0, 0, 16 * steps - 9 * kc))
    wk = wk.reshape(nch, planes, steps, 2, 8, bn // 8, 8).permute(0, 1, 2, 5, 3, 6, 4)
    return wk.contiguous().reshape(-1)


def _packed(w, b, plan, co0):
    """(weight image, f32 bias padded to bn) of output channels co0.., cached
    on the weight tensor and rebuilt when the weights, the bias or the plan
    change."""
    key = (plan.kc, plan.bn, co0, None if b is None else (b.data_ptr(), b._version))
    state = (w.device, w.data_ptr(), w._version)
    cache = getattr(w, "_conv_sm90_packed", None)
    if cache is None or cache[0] != state:
        cache = (state, {})
        w._conv_sm90_packed = cache
    if key not in cache[1]:
        bias = torch.zeros(plan.bn, dtype=torch.float32, device=w.device)
        if b is not None:
            bb = b[co0:co0 + plan.bn].float()
            bias[:bb.shape[0]] = bb
        cache[1][key] = (pack_weights(w, plan.kc, plan.bn, co0), bias)
    return cache[1][key]


def _activate(y, act):
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "elu":
        return torch.where(y > 0, y, torch.expm1(y))
    if act == "linear":
        return y
    raise ValueError(f"unknown activation {act!r}")


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
    C is zero-padded to a multiple of 8 (the C_in = 1 first layer; zero
    channels times zero weights add nothing) and Cout to a multiple of 8,
    cut off again after; more than 256 output channels take one launch per
    256."""
    nd = w.dim() - 2
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the conv kernel takes bfloat16 activations, got {x.dtype}")
    if x.dim() != nd + 1 or w.shape[:nd] != (3,) * nd or w.shape[nd] != x.shape[-1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    C = x.shape[-1]
    if C % 8:
        x = F.pad(x, (0, 8 - C % 8))
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    sp, C = tuple(x.shape[:-1]), x.shape[-1]
    Cout = w.shape[-1]
    Cp = -(-Cout // 8) * 8
    y = torch.empty(sp + (Cp,), dtype=torch.bfloat16, device=x.device)
    for co0 in range(0, Cp, MAX_COUT):
        n = min(MAX_COUT, Cp - co0)
        plan = conv_plan(sp, C, n)
        wimg, bias = _packed(w, b, plan, co0)
        kernel.launch(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wimg.data_ptr()),
                      ctypes.c_void_p(bias.data_ptr()), ctypes.c_void_p(y.data_ptr() + 2 * co0),
                      *sp, C, n, Cp, ACTS[act], plan.kc, plan.bn, int(plan.resident),
                      plan.stages, plan.th, plan.tw, stream_ptr(x.device))
    return y if Cp == Cout else y[..., :Cout].contiguous()


def conv3x3_hwc_cuda(x, w, b=None, act="relu"):
    """Launch the kernel through ``csrc/conv3x3.cu``. x (H, W, C) bf16 CUDA
    -> (H, W, Cout) bf16."""
    return _conv_cuda(KERNEL, x, w, b, act)


def conv3x3x3_dhwc_cuda(x, w, b=None, act="relu"):
    """Launch the kernel through ``csrc/conv3x3x3.cu``. x (D, H, W, C) bf16
    CUDA -> (D, H, W, Cout) bf16."""
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
