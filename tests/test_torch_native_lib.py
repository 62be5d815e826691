"""The port's copy of the native host library (stardist_torch/lib) against
the port's plain versions on the CPU (tests/test_native_lib.py's cases).

The library builds with g++ into build/stardist_torch/. The port's 2D and
3D star distances, 2D and 3D label rasters and 2D and 3D NMS keep flags
are exactly equal to it: the library is the port's oracle and its C
embedding ABI, and no model path calls it."""
import numpy as np
import pytest
import torch

from stardist_torch.geometry import star_dist, star_dist3D
from stardist_torch.lib import (BUILD_DIR, dist_to_volume_native, get_lib, nms2d_native,
                                nms3d_native, polygons_to_label_native,
                                polyhedra_to_label_native, star_dist2d_native,
                                star_dist3d_native)
from stardist_torch.ops.nms import nms_polygons, nms_polyhedra
from stardist_torch.ops.polyhedron import ray_tensors
from stardist_torch.ops.rasterize import rasterize_polygons, rasterize_polyhedra
from stardist_torch.rays3d import Rays_GoldenSpiral
from utils import random_image, synthetic_nuclei_2d, synthetic_nuclei_3d

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_lib_builds_into_the_build_dir():
    lib = get_lib()
    assert lib.sd_version() == 101
    assert any(BUILD_DIR.glob("libsd_native_*.so"))


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("image", ["random", "nuclei"])
def test_star_dist2d_equal(grid, image):
    lbl = (random_image((61, 63)) if image == "random"
           else synthetic_nuclei_2d((96, 80), seed=1)[1])
    a = star_dist(lbl, 16, grid=grid, device="cpu")
    b = star_dist2d_native(lbl, 16, grid=grid)
    assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("grid", [(1, 1, 1), (1, 2, 2)])
def test_star_dist3d_equal(grid):
    lbl = synthetic_nuclei_3d((15, 33, 31), seed=2)[1]
    rays = Rays_GoldenSpiral(12)
    a = star_dist3D(lbl, rays, grid=grid, device="cpu")
    b = star_dist3d_native(lbl, rays, grid=grid)
    assert a.shape == b.shape and np.array_equal(a, b)


def _polygons(N, R, seed, lo=5, hi=10, extent=(10, 120)):
    rng = np.random.RandomState(seed)
    dist = rng.uniform(lo, hi, (N, R)).astype(np.float32)
    points = np.round(rng.uniform(*extent, (N, 2))).astype(np.float32)
    return dist, points


@pytest.mark.parametrize("thresh", [0.3, 0.5])
def test_nms2d_keep_flags_equal(thresh):
    dist, points = _polygons(150, 16, 0)
    a = nms_polygons(torch.from_numpy(dist), torch.from_numpy(points), thresh=thresh).numpy()
    b = nms2d_native(dist, points, thresh=thresh)
    assert 0 < a.sum() < len(a) and np.array_equal(a, b)


@pytest.mark.parametrize("thresh", [0.1, 0.3])
def test_nms3d_keep_flags_equal(thresh):
    rays = Rays_GoldenSpiral(16)
    rng = np.random.RandomState(0)
    dist = rng.uniform(4, 7, (25, 16)).astype(np.float32)
    points = np.round(rng.uniform(8, 40, (25, 3))).astype(np.float32)
    dirs, faces = ray_tensors(rays, CPU)
    a = nms_polyhedra(torch.from_numpy(dist), torch.from_numpy(points), dirs, faces,
                      thresh=thresh).numpy()
    b = nms3d_native(dist, points, rays, thresh=thresh)
    assert 0 < a.sum() < len(a) and np.array_equal(a, b)


def test_raster2d_equal():
    dist, points = _polygons(40, 16, 1, 4, 9, (12, 52))
    order = np.arange(1, 41, dtype=np.int32)
    labels = np.random.RandomState(2).permutation(40).astype(np.int32)
    for lab in (None, labels):
        a = rasterize_polygons(torch.from_numpy(dist), torch.from_numpy(points), (64, 64),
                               torch.from_numpy(order),
                               None if lab is None else torch.from_numpy(lab)).numpy()
        b = polygons_to_label_native(dist, points, (64, 64), order, labels=lab)
        assert a.max() > 0 and np.array_equal(a, b)


def test_raster3d_equal():
    rays = Rays_GoldenSpiral(32)
    rng = np.random.RandomState(4)
    N = 15
    dist = rng.uniform(3, 7, (N, 32)).astype(np.float32)
    points = np.round(rng.uniform(10, 40, (N, 3))).astype(np.float32)
    order = np.arange(1, N + 1, dtype=np.int32)
    labels = rng.permutation(N).astype(np.int32) + 1
    dirs, faces = ray_tensors(rays, CPU)
    a, cnt_a = rasterize_polyhedra(torch.from_numpy(dist), torch.from_numpy(points), dirs, faces,
                                   (48, 48, 48), torch.from_numpy(order),
                                   labels=torch.from_numpy(labels), return_count=True)
    b, cnt_b = polyhedra_to_label_native(dist, points, rays, (48, 48, 48), order,
                                         return_count=True, labels=labels)
    assert np.array_equal(a.numpy(), b) and np.array_equal(cnt_a.numpy(), cnt_b)


def test_dist_to_volume_native():
    rays = Rays_GoldenSpiral(32)
    dist = np.random.RandomState(2).uniform(3, 8, (5, 7, 32)).astype(np.float32)
    v = dist_to_volume_native(dist, rays)
    assert v.shape == (5, 7) and np.allclose(v, rays.volume(dist), rtol=1e-4)
