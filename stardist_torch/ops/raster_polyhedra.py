"""Label rasterization of star polyhedra on the card: the 3D raster of
:func:`.rasterize.rasterize_polyhedra` on CUDA tensors (the reference draws
3D labels in plain jnp, ``stardist_tpu/ops/rasterize.py::_raster3d_impl``;
no Pallas kernel).

:func:`rasterize_polyhedra_cuda` forms each polyhedron's face rows with
torch on the card (:func:`face_table`: the face inverses in "full" mode,
the face planes in "kernel" mode, the box in "bbox" mode, each as the plain
version forms them) and launches ``csrc/raster_polyhedra.cu`` once: a block
per polyhedron, its faces in shared memory, the voxels of its cube
round-robin over the block's threads, and a 64-bit atomic max of the packed
``(order << 32) | label`` per voxel inside. The plain version, which runs on
CPU tensors, chunks the polyhedra and scatters; the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, stream_ptr
from .polyhedron import _cross, polyhedron_face_inverses

KERNEL = CudaKernel(
    "raster_polyhedra.cu", "raster_polyhedra",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    extra_flags=("-fmad=false",))

MODES = {"full": 0, "kernel": 1, "bbox": 2}
F_MAX = 4842         # the most faces a block stages in "full" mode (the kernel's F_MAX)


def kernel_planes(dist, ray_dirs, faces):
    """The face planes of "kernel" mode: (normals (N, F, 3), thresholds (N,
    F)) f32, each normal turned to the centre's side of its plane and the
    threshold its offset + 1e-6. The normals are the plain version's
    (``_cross`` of the face's edges); the offset n . a is summed as
    (n0 * a0 + n1 * a1) + n2 * a2, the order of torch.sum over three values
    on the CPU, on any device."""
    tri = (dist[..., None] * ray_dirs)[:, faces]                    # (N, F, 3, 3)
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    n = _cross(b - a, c - a)
    na = n * a
    off = (na[..., 0] + na[..., 1]) + na[..., 2]
    sgn = torch.where(off < 0, -1.0, 1.0)
    return n * sgn[..., None], off * sgn + 1e-6


def face_table(dist, points, ray_dirs, faces, mode):
    """The kernel's rows of each polyhedron in ``mode``: (table, valid).
    "full": the face inverses (N, F, 3, 3) and their valid flags (N, F);
    "kernel": (N, F, 4), the normal and threshold of :func:`kernel_planes`;
    "bbox": (N, 6), the box's low and high corners, centre + the least and
    the largest ray vector per axis; valid None but in "full"."""
    if mode == "full":
        return polyhedron_face_inverses(dist, ray_dirs, faces)
    if mode == "kernel":
        n, thr = kernel_planes(dist, ray_dirs, faces)
        return torch.cat([n, thr[..., None]], dim=-1), None
    v = dist[..., None] * ray_dirs                                   # (N, R, 3)
    return torch.cat([points + v.amin(dim=1), points + v.amax(dim=1)], dim=-1), None


def kernel_inputs(dist, points, ray_dirs, faces, order_values, labels, mode):
    """The kernel's inputs on the card, formed with no host sync: centres
    (N, 3) f32, the table and valid flags of :func:`face_table`, order
    values and packed values ``(order << 32) | label`` (N,) int64 (the
    order value in the low half where ``labels`` is None), and the largest
    dist as a one-element tensor."""
    dist = dist.to(torch.float32).contiguous()
    points = points.to(torch.float32).contiguous()
    order_values = order_values.to(torch.int64).contiguous()
    labs = order_values if labels is None else labels.to(torch.int64)
    tab, valid = face_table(dist, points, ray_dirs.to(torch.float32), faces, mode)
    return (points, tab.contiguous(), None if valid is None else valid.contiguous(),
            order_values, ((order_values << 32) | labs).contiguous(),
            dist.amax().reshape(1) if dist.numel() else dist.new_zeros(1))


def draw(inputs, shape, F, mode, return_count=False):
    """Zero the packed image ((D * H * W,) int64) and, with
    ``return_count``, the count (int32), and launch the kernel on
    ``inputs`` (:func:`kernel_inputs`) in ``mode``. Returns (img, count or
    None)."""
    dev = inputs[0].device
    D, H, W = shape
    img = torch.zeros(D * H * W, dtype=torch.int64, device=dev)
    cnt = torch.zeros(D * H * W, dtype=torch.int32, device=dev) if return_count else None
    N = inputs[0].shape[0]
    if N > 0:
        KERNEL.launch(*(ctypes.c_void_p(0 if t is None else t.data_ptr())
                        for t in (*inputs, img, cnt)),
                      N, F, D, H, W, MODES[mode], stream_ptr(dev))
    return img, cnt


def rasterize_polyhedra_cuda(dist, points, ray_dirs, faces, shape, order_values, labels=None,
                             return_count=False, mode="full"):
    """:func:`.rasterize.rasterize_polyhedra` on CUDA tensors: launches
    ``csrc/raster_polyhedra.cu``, or raises. It makes no host sync."""
    if mode not in MODES:
        raise ValueError(f"unknown render mode {mode!r}")
    N, R = dist.shape
    F = faces.shape[0]
    for t, sh in ((dist, (N, R)), (points, (N, 3)), (ray_dirs, (R, 3)), (faces, (F, 3)),
                  (order_values, (N,)), (labels, (N,))):
        if t is not None and (not t.is_cuda or t.device != dist.device
                              or tuple(t.shape) != sh):
            raise ValueError(f"rasterize_polyhedra_cuda: bad input {tuple(t.shape)} "
                             f"on {t.device}")
    if mode != "bbox" and not 1 <= F <= F_MAX:
        raise ValueError(f"rasterize_polyhedra_cuda: {F} faces, at most {F_MAX}")
    shape = tuple(int(s) for s in shape)
    img, cnt = draw(kernel_inputs(dist, points, ray_dirs, faces, order_values, labels, mode),
                    shape, F, mode, return_count)
    img = (img & 0xFFFFFFFF).to(torch.int32).view(shape)
    return img, None if cnt is None else cnt.view(shape)
