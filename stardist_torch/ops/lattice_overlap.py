"""Exact lattice counts of star-polyhedron pairs: the overlap test of the 3D
NMS (the count of ``stardist_tpu/ops/nms.py::_overlap_block_3d``, which the
reference computes in plain jnp).

For a flat list of P pairs (i, j), the integer lattice inside the pair's
bbox intersection (:func:`lattice_grid`: per axis ``plo + stride * k``,
k < S, up to ``phi``) is tested against polyhedron i, and the points inside
i against polyhedron j (:func:`.polyhedron.points_in_indexed_polyhedra`).
:func:`lattice_counts` returns both counts, (P, 2) int32. On CUDA tensors it
runs in ``csrc/lattice_overlap.cu`` (a warp per pair, the two face sets in
shared memory, the polyhedra's rows read by index); on CPU tensors in
:func:`lattice_counts_plain`, whose steps the kernel follows bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, stream_ptr
from .polyhedron import points_in_indexed_polyhedra

KERNEL = CudaKernel(
    "lattice_overlap.cu", "lattice_counts_i32",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    extra_flags=("-fmad=false",))

LATTICE_S = 12       # lattice points per axis: the reference's host NMS
# pairs per step of the plain version at LATTICE_S (bounds its (points, 8)
# temporaries); a step holds as many lattice points at any S
LATTICE_PAIRS = 64
S_MAX = 1290         # the largest S whose S^3 points fit an int32
F_MAX = 605          # the most faces whose two sets a warp stages (the kernel's F_MAX)


def lattice_grid(lo, hi, i, j, S):
    """The lattices of the pairs (i, j) of bboxes ``lo``, ``hi`` (N, 3):
    plo, phi (ceil / floor of the intersection's corners) and stride
    (max(ceil(n_vox / S), 1)), each (P, 3) f32."""
    plo = torch.ceil(torch.maximum(lo[i], lo[j]))
    phi = torch.floor(torch.minimum(hi[i], hi[j]))
    n_vox = torch.clamp_min(phi - plo + 1, 0.0)
    stride = torch.clamp_min(torch.ceil(n_vox / S), 1.0)
    return plo, phi, stride


def _axis_points(plo, phi, stride, S):
    """(P, 3, S) lattice coordinates per axis, and which lie at most phi."""
    ar = torch.arange(S, dtype=torch.float32, device=plo.device)
    pos = plo[:, :, None] + stride[:, :, None] * ar                # integers
    return pos, pos <= phi[:, :, None]


def lattice_points(plo, phi, stride, S):
    """(P,) int64: the lattice points of each pair."""
    return _axis_points(plo, phi, stride, S)[1].sum(dim=-1).prod(dim=-1)


def lattice_counts_plain(points, inv, valid, i, j, plo, phi, stride, S):
    """Plain PyTorch version of :func:`lattice_counts` (any device), in
    steps of ``LATTICE_PAIRS`` pairs at ``LATTICE_S`` (as many points at
    any S). Only the lattice points inside the intersection are tested
    against i, and only those inside i against j."""
    P = i.numel()
    out = torch.empty(P, 2, dtype=torch.int32, device=points.device)
    step = max(1, LATTICE_PAIRS * LATTICE_S ** 3 // S ** 3)
    for c in range(0, P, step):
        sl = slice(c, c + step)
        pos, ok = _axis_points(plo[sl], phi[sl], stride[sl], S)
        n = pos.shape[0]
        m = (ok[:, 0, :, None, None] & ok[:, 1, None, :, None]
             & ok[:, 2, None, None, :]).reshape(n, -1)
        pair, sample = torch.nonzero(m, as_tuple=True)
        iz, iy, ix = sample // (S * S), (sample // S) % S, sample % S
        q = torch.stack([pos[pair, 0, iz], pos[pair, 1, iy], pos[pair, 2, ix]], dim=-1)
        sel = points_in_indexed_polyhedra(inv, valid, points, i[sl][pair], q)
        pair, q = pair[sel], q[sel]
        sel = points_in_indexed_polyhedra(inv, valid, points, j[sl][pair], q)
        out[sl, 0] = torch.bincount(pair, minlength=n).int()
        out[sl, 1] = torch.bincount(pair[sel], minlength=n).int()
    return out


def lattice_counts_cuda(points, inv, valid, i, j, plo, phi, stride, S):
    """Launch ``csrc/lattice_overlap.cu`` on CUDA tensors."""
    S = int(S)
    if not 1 <= S <= S_MAX:
        raise ValueError(f"S must be in [1, {S_MAX}], got {S}")
    N, F = valid.shape
    if not 1 <= F <= F_MAX:
        raise ValueError(f"lattice_counts_cuda: {F} faces, at most {F_MAX}")
    P = i.numel()
    args = [points.to(torch.float32).contiguous(), inv.to(torch.float32).contiguous(),
            valid.to(torch.bool).contiguous(), i.to(torch.int64).contiguous(),
            j.to(torch.int64).contiguous(),
            *(t.to(torch.float32).contiguous() for t in (plo, phi, stride))]
    shapes = [(N, 3), (N, F, 3, 3), (N, F), (P,), (P,), (P, 3), (P, 3), (P, 3)]
    for t, shape in zip(args, shapes):
        if not t.is_cuda or t.device != points.device or tuple(t.shape) != shape:
            raise ValueError(f"lattice_counts_cuda: bad input {tuple(t.shape)} on {t.device}")
    out = torch.empty(P, 2, dtype=torch.int32, device=points.device)
    if P == 0:
        return out
    KERNEL.launch(*(ctypes.c_void_p(t.data_ptr()) for t in args),
                  ctypes.c_void_p(out.data_ptr()), P, F, S, stream_ptr(points.device))
    return out


def lattice_counts(points, inv, valid, i, j, plo, phi, stride, S):
    """Lattice counts of the polyhedron pairs (i, j).

    points (N, 3) centres, inv (N, F, 3, 3) / valid (N, F) the face
    inverses of :func:`.polyhedron.polyhedron_face_inverses`, i, j (P,)
    rows, plo, phi, stride (P, 3) of :func:`lattice_grid`, S (>= 1) the
    lattice points per axis. Returns (P, 2) int32: the points inside
    polyhedron i, and of those the points inside j."""
    if points.is_cuda:
        return lattice_counts_cuda(points, inv, valid, i, j, plo, phi, stride, S)
    if points.device.type != "cpu":
        raise RuntimeError(f"no lattice kernel for device {points.device}")
    return lattice_counts_plain(points, inv, valid, i, j, plo, phi, stride, S)
