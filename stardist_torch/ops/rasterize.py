"""Label-image rasterization of star polygons and polyhedra (counterpart of
``stardist_tpu/ops/rasterize.py::rasterize_polygons`` / ``_raster2d_impl``
and ``rasterize_polyhedra`` / ``_raster3d_impl``).

Splatting: every polygon tests a fixed square window around its centre
and a max over the packed ``(order << 32) | label`` resolves the winner and
its label per pixel in one pass, so "later in the rendering order wins"
becomes a max (packed in int64, so the order values have no 2^15 limit).

In 2D, :func:`rasterize_polygons` launches the tile kernel on CUDA tensors
(:mod:`.raster_tiles`, ``csrc/raster_tiles.cu``: the wedge test by
cross-product signs of the reference's TPU kernel) and runs
:func:`rasterize_polygons_splat` on CPU tensors: the atan2-wedge inside test
of :func:`.polygon.points_in_polygons` and a scatter-max, as the
reference's ``_raster2d_impl`` does everywhere but on a TPU. The two tests
can differ only for a pixel lying exactly on a ray. Both draw the polygons
stretched by ``scale_dist`` per axis about their centres as the reference's
splat does: the pixel's offset from the centre times ``1 / scale_dist`` is
tested in the polygon's own frame.
In 3D the window is a cube and the inside test is the barycentric face test
of :func:`.polyhedron.points_in_polyhedra`, or the reference's "kernel"
(face half-spaces) or "bbox" test. :func:`rasterize_polyhedra` launches
one kernel per call on CUDA tensors (:mod:`.raster_polyhedra`,
``csrc/raster_polyhedra.cu``: a block per polyhedron, its faces in shared
memory, an atomic max of the packed value per voxel) and runs the plain
version on CPU tensors, in chunks of ``CHUNK_3D`` polyhedra (their voxel
sets, the inside test in plain torch and a scatter-max per chunk). The two
agree bit for bit.
"""
from __future__ import annotations

import torch

from ..core.profiling import span
from .polygon import points_in_polygons
from .polyhedron import _cross, points_in_polyhedra, polyhedron_face_inverses
from .raster_polyhedra import rasterize_polyhedra_cuda
from .raster_tiles import inv_scale, rasterize_polygons_tiles_cuda, tile_window, unpack_labels


CHUNK = 1024   # polygons per scatter step (bounds the (chunk, window^2) temporaries)
CHUNK_3D = 8   # polyhedra per scatter step (bounds the (chunk, window^3, 8) temporaries)


def raster_window(dmax, shape, scale_dist=(1, 1)):
    """Splat window: the tile kernel's window (2*ceil(max dist * max scale)
    + 4, capped by the image) rounded up to a multiple of 16."""
    return -(-tile_window(dmax, shape, scale_dist) // 16) * 16


def rasterize_polygons(dist, points, shape, order_values, labels=None,
                       out_dtype=torch.int32, scale_dist=(1, 1), *, value_bound=None):
    """Per pixel, the polygon with the largest positive order value wins.

    dist (N, R), points (N, 2), order_values (N,) int (0 = never drawn);
    all tensors on one device. Returns an (H, W) tensor of ``out_dtype``
    (torch.int32, or torch.uint16 when every pixel value fits, as the
    reference's device path ships it) on that device: the winner's
    ``labels[i] + 1`` (or its order value when ``labels`` is None), 0 for
    background. The polygons are stretched by ``scale_dist`` = (s_r, s_c),
    both positive, about their centres. CUDA tensors go through the tile
    kernel (``value_bound``,
    the caller's bound on the order values and labels + 1, lets it pack
    into 32 bits: :func:`.raster_tiles.rasterize_polygons_tiles_cuda`), CPU
    tensors through the splat."""
    if dist.is_cuda:
        return rasterize_polygons_tiles_cuda(dist, points, shape, order_values, labels,
                                             out_dtype=out_dtype, scale_dist=scale_dist,
                                             value_bound=value_bound)
    if dist.device.type != "cpu":
        raise RuntimeError(f"no raster for device {dist.device}")
    return rasterize_polygons_splat(dist, points, shape, order_values, labels, out_dtype,
                                    scale_dist)


def rasterize_polygons_splat(dist, points, shape, order_values, labels=None,
                             out_dtype=torch.int32, scale_dist=(1, 1)):
    """:func:`rasterize_polygons` with the atan2-wedge inside test and a
    scatter-max, in plain torch on any device."""
    dev = dist.device
    H, W = (int(s) for s in shape)
    N = dist.shape[0]
    inv = torch.tensor(inv_scale(scale_dist), dtype=torch.float32, device=dev)
    img = torch.zeros(H * W, dtype=torch.int64, device=dev)
    if N == 0:
        return unpack_labels(img, (H, W), out_dtype)
    dist = dist.to(torch.float32)
    points = points.to(torch.float32)
    order_values = order_values.to(dev, torch.int64)
    labs = order_values if labels is None else labels.to(dev, torch.int64) + 1
    packed = (order_values << 32) | labs
    window = raster_window(dist.max().item(), shape, scale_dist)
    ar = torch.arange(window, dtype=torch.int32, device=dev)
    for i0 in range(0, N, CHUNK):
        d = dist[i0:i0 + CHUNK]
        p = points[i0:i0 + CHUNK]
        v = order_values[i0:i0 + CHUNK]
        pk = packed[i0:i0 + CHUNK]
        n = d.shape[0]
        start = torch.round(p).to(torch.int32) - window // 2
        rr = start[:, 0:1] + ar[None]                     # (n, Wn)
        cc = start[:, 1:2] + ar[None]
        q = torch.stack(torch.broadcast_tensors(
            rr[:, :, None].float(), cc[:, None, :].float()), dim=-1).reshape(n, -1, 2)
        # the offsets in the polygons' own frame, about centres at 0
        q = (q - p[:, None, :]) * inv
        inside = points_in_polygons(d, torch.zeros_like(p), q) & (v > 0)[:, None]
        in_img = (((rr >= 0) & (rr < H))[:, :, None]
                  & ((cc >= 0) & (cc < W))[:, None, :]).reshape(n, -1)
        inside = inside & in_img
        flat = (rr.long()[:, :, None] * W + cc.long()[:, None, :]).reshape(n, -1)
        vals = pk[:, None].expand_as(flat)
        img.scatter_reduce_(0, flat[inside], vals[inside], reduce="amax")
    return unpack_labels(img, (H, W), out_dtype)


def _inside_kernel(d, p, q, ray_dirs, faces):
    """``mode="kernel"``: q (n, S, 3) on the inner side of every face plane
    of the polyhedra (d (n, R), centres p (n, 3)), within 1e-6; the face
    normals as the reference's ``jnp.cross`` (FMA) forms them."""
    tri = (d[..., None] * ray_dirs)[:, faces]                       # (n, F, 3, 3)
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    n = _cross(b - a, c - a)
    off = torch.sum(n * a, dim=-1)
    sgn = torch.where(off < 0, -1.0, 1.0)
    n, off = n * sgn[..., None], off * sgn
    u = q[:, :, None, :] - p[:, None, None, :]                      # (n, S, 1, 3)
    return torch.all(torch.sum(u * n[:, None], dim=-1) <= off[:, None] + 1e-6, dim=-1)


def _inside_bbox(d, p, q, ray_dirs):
    """``mode="bbox"``: q (n, S, 3) inside the polyhedra's bounding boxes."""
    v = d[..., None] * ray_dirs                                     # (n, R, 3)
    lo, hi = p + v.amin(dim=1), p + v.amax(dim=1)
    return torch.all((q >= lo[:, None]) & (q <= hi[:, None]), dim=-1)


def rasterize_polyhedra(dist, points, ray_dirs, faces, shape, order_values, labels=None,
                        return_count=False, mode="full"):
    """Per voxel, the polyhedron with the largest positive order value wins.

    dist (N, R), points (N, 3), ray_dirs (R, 3), faces (F, 3), order_values
    (N,) int (0 = never drawn); all tensors on one device. Each polyhedron
    tests the cube of side 2*ceil(max dist)+4 (capped by the volume) around
    its rounded centre. Returns (img, count): img int32 (D, H, W) on that
    device holding the winner's ``labels[i]`` (or its order value when
    ``labels`` is None), 0 for background; count, with ``return_count``,
    the int32 number of drawn polyhedra covering each voxel, else None.
    ``mode`` is the reference's: "full" the exact polyhedron, "kernel" the
    intersection of its faces' inner half-spaces, "bbox" its bounding
    box.

    CUDA tensors go through one launch of ``csrc/raster_polyhedra.cu``
    (:func:`.raster_polyhedra.rasterize_polyhedra_cuda`) inside one
    ``stardist.raster.inside`` span, which ends with a sync, so that its
    time is the draw's on the card; CPU tensors through the plain version,
    chunks of ``CHUNK_3D`` polyhedra, each an ``.inside`` and a
    ``.scatter`` span."""
    if mode not in ("full", "kernel", "bbox"):
        raise ValueError(f"unknown render mode {mode!r}")
    dev = dist.device
    if dist.is_cuda:
        with span("stardist.raster.inside"):
            out = rasterize_polyhedra_cuda(dist, points, ray_dirs, faces, shape, order_values,
                                           labels, return_count, mode)
            torch.cuda.synchronize(dev)
        return out
    if dev.type != "cpu":
        raise RuntimeError(f"no raster for device {dev}")
    D, H, W = (int(s) for s in shape)
    N = dist.shape[0]
    img = torch.zeros(D * H * W, dtype=torch.int64, device=dev)
    cnt = torch.zeros(D * H * W, dtype=torch.int32, device=dev) if return_count else None
    if N == 0:
        return img.view(D, H, W).to(torch.int32), None if cnt is None else cnt.view(D, H, W)
    dist = dist.to(torch.float32)
    points = points.to(torch.float32)
    order_values = order_values.to(dev, torch.int64)
    labs = order_values if labels is None else labels.to(dev, torch.int64)
    packed = (order_values << 32) | labs
    window = tile_window(dist.max().item(), shape)
    ar = torch.arange(window, dtype=torch.int64, device=dev)
    for i0 in range(0, N, CHUNK_3D):
        with span("stardist.raster.inside"):
            d = dist[i0:i0 + CHUNK_3D]
            p = points[i0:i0 + CHUNK_3D]
            n = d.shape[0]
            start = torch.round(p).to(torch.int64) - window // 2
            zz, yy, xx = (start[:, k:k + 1] + ar[None] for k in range(3))   # (n, Wn)
            q = torch.stack(torch.broadcast_tensors(
                zz[:, :, None, None].float(), yy[:, None, :, None].float(),
                xx[:, None, None, :].float()), dim=-1).reshape(n, -1, 3)
            if mode == "bbox":
                inside = _inside_bbox(d, p, q, ray_dirs)
            elif mode == "kernel":
                inside = _inside_kernel(d, p, q, ray_dirs, faces)
            else:
                inv, valid = polyhedron_face_inverses(d, ray_dirs, faces)
                inside = points_in_polyhedra(inv, valid, p, q)
            inside = inside & (order_values[i0:i0 + n] > 0)[:, None]
            in_img = (((zz >= 0) & (zz < D))[:, :, None, None]
                      & ((yy >= 0) & (yy < H))[:, None, :, None]
                      & ((xx >= 0) & (xx < W))[:, None, None, :]).reshape(n, -1)
            inside = inside & in_img
            flat = ((zz[:, :, None, None] * H + yy[:, None, :, None]) * W
                    + xx[:, None, None, :]).reshape(n, -1)[inside]
            vals = packed[i0:i0 + n, None].expand(inside.shape)[inside]
        with span("stardist.raster.scatter"):
            img.scatter_reduce_(0, flat, vals, reduce="amax")
            if cnt is not None:
                cnt.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    img = (img & 0xFFFFFFFF).to(torch.int32).view(D, H, W)
    return img, None if cnt is None else cnt.view(D, H, W)
