"""The 3D raster's CUDA kernel (``stardist_torch/csrc/raster_polyhedra.cu``)
on the CPU: its inputs as the wrapper forms them (``ops/raster_polyhedra.py``)
and its per-voxel steps, written out in plain torch one polyhedron at a
time, against the plain version (``ops/rasterize.py::rasterize_polyhedra``
on CPU tensors) in every mode, with its constants against the wrapper's.
The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``). Imports no JAX."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import LATTICE_HI, LATTICE_LO, polyhedra_field, raster3d_rays
from stardist_torch.ops import raster_polyhedra as r3
from stardist_torch.ops.cuda_build import local_sources
from stardist_torch.ops.rasterize import _inside_kernel, rasterize_polyhedra

torch.set_num_threads(2)

CU = Path(r3.__file__).resolve().parents[1] / "csrc" / "raster_polyhedra.cu"
SHAPE = (19, 30, 26)


def _kernel_steps(dist, points, dirs, faces, shape, order, labels, mode):
    """The kernel's function in plain torch, as ``raster_polyhedra.cu``
    computes it: the window from the largest dist; per polyhedron with an
    order value above 0, its cube about rint(centre) clipped to the volume,
    each voxel's offset u = q - p, the mode's test on the wrapper's rows
    (each product and sum rounded on its own, in the kernel's order), and a
    max of the packed value and a count per voxel inside."""
    D, H, W = shape
    pts, tab, valid, orders, packed, dmax = r3.kernel_inputs(dist, points, dirs, faces, order,
                                                             labels, mode)
    img = torch.zeros(D * H * W, dtype=torch.int64)
    cnt = torch.zeros(D * H * W, dtype=torch.int32)
    cd = math.ceil(float(dmax[0]))
    window = 2 * cd + 4 if cd < max(shape) else 2 * max(shape) + 4
    lo_b, hi_b = torch.tensor(LATTICE_LO), torch.tensor(LATTICE_HI)
    for n in range(len(pts)):
        if orders[n] <= 0:
            continue
        start = torch.round(pts[n]).long() - window // 2
        lo, hi = start.clamp(min=0), torch.minimum(start + window, torch.tensor(shape))
        if (hi <= lo).any():
            continue
        z, y, x = torch.meshgrid(*(torch.arange(a, b) for a, b in zip(lo, hi)), indexing="ij")
        q = torch.stack([z, y, x], dim=-1).reshape(-1, 3).float()
        if mode == "bbox":
            inside = ((q >= tab[n, :3]) & (q <= tab[n, 3:])).all(dim=-1)
        else:
            u0, u1, u2 = ((q[:, k] - pts[n, k])[:, None] for k in range(3))   # (S, 1)

            def dot(r):                                                     # r (F, >= 3)
                return (r[:, 0] * u0 + r[:, 1] * u1) + r[:, 2] * u2          # (S, F)
            if mode == "full":
                b0, b1, b2 = (dot(tab[n, :, r]) for r in range(3))
                inside = ((b0 >= lo_b) & (b1 >= lo_b) & (b2 >= lo_b)
                          & ((b0 + b1) + b2 <= hi_b) & valid[n]).any(dim=-1)
            else:
                inside = (dot(tab[n]) <= tab[n, :, 3]).all(dim=-1)
        flat = ((z * H + y) * W + x).reshape(-1)[inside]
        img.scatter_reduce_(0, flat, packed[n].expand(flat.shape), reduce="amax")
        cnt[flat] += 1
    return (img & 0xFFFFFFFF).to(torch.int32).view(shape), cnt.view(shape)


@pytest.mark.parametrize("mode", ["full", "kernel", "bbox"])
@pytest.mark.parametrize("rays", ["golden32", "golden96", "octahedron"])
def test_kernel_steps_equal_the_plain_version(rays, mode):
    """Seeded overlapping polyhedra cut by the volume's edges, with
    degenerate faces, tied and zero order values: labels and counts of the
    kernel's steps exactly the plain version's, with and without labels."""
    dirs, faces = raster3d_rays(rays)
    dist, points, order, labels = polyhedra_field(dirs, 30, SHAPE, "cpu", seed=len(faces),
                                                  integer=rays == "octahedron")
    for lab in (labels, None):
        want, want_cnt = rasterize_polyhedra(dist, points, dirs, faces, SHAPE, order,
                                             labels=lab, return_count=True, mode=mode)
        got, cnt = _kernel_steps(dist, points, dirs, faces, SHAPE, order, lab, mode)
        assert torch.equal(got, want) and torch.equal(cnt, want_cnt)
        assert want.max() > 0 and want_cnt.max() > 1          # drawn, and overlapping


@pytest.mark.parametrize("rays", ["golden32", "golden96", "octahedron"])
def test_kernel_planes_decide_as_the_plain_version(rays):
    """"kernel" mode: the wrapper's planes, each offset summed in the
    kernel's order, decide every offset as the plain version's test."""
    dirs, faces = raster3d_rays(rays)
    dist, points, _, _ = polyhedra_field(dirs, 12, SHAPE, "cpu", seed=1,
                                         integer=rays == "octahedron")
    rng = np.random.RandomState(2)
    q = points[:, None, :] + torch.from_numpy(rng.randint(-10, 11, (12, 300, 3))).float()
    want = _inside_kernel(dist, points, q, dirs, faces)
    n, thr = r3.kernel_planes(dist, dirs, faces)
    u = q - points[:, None, :]
    dots = ((u[..., None, 0] * n[:, None, :, 0] + u[..., None, 1] * n[:, None, :, 1])
            + u[..., None, 2] * n[:, None, :, 2])
    assert torch.equal((dots <= thr[:, None, :]).all(dim=-1), want)
    assert 0 < want.float().mean() < 1


def test_kernel_inputs_of_an_empty_call():
    """No polyhedra: the inputs are empty, the largest dist 0, and the plain
    version draws nothing."""
    dirs, faces = raster3d_rays("golden32")
    dist, points = torch.zeros(0, 32), torch.zeros(0, 3)
    order = torch.zeros(0, dtype=torch.int64)
    for mode in r3.MODES:
        inputs = r3.kernel_inputs(dist, points, dirs, faces, order, None, mode)
        assert inputs[0].shape == (0, 3) and inputs[4].shape == (0,)
        assert torch.equal(inputs[5], torch.zeros(1))
        img, cnt = rasterize_polyhedra(dist, points, dirs, faces, SHAPE, order,
                                       return_count=True, mode=mode)
        assert img.shape == cnt.shape == SHAPE and not img.any() and not cnt.any()


def test_cuda_path_refuses_cpu_tensors_and_other_devices():
    """No fallback: the kernel's wrapper takes CUDA tensors only, and
    ``rasterize_polyhedra`` raises on a device that is neither the CPU nor
    CUDA."""
    dirs, faces = raster3d_rays("golden32")
    dist, points, order, labels = polyhedra_field(dirs, 6, SHAPE, "cpu", seed=0)
    with pytest.raises(ValueError, match="bad input"):
        r3.rasterize_polyhedra_cuda(dist, points, dirs, faces, SHAPE, order, labels)
    with pytest.raises(RuntimeError, match="no raster"):
        rasterize_polyhedra(*(t.to("meta") for t in (dist, points, dirs, faces)), SHAPE,
                            order.to("meta"))
    with pytest.raises(ValueError, match="render mode"):
        r3.rasterize_polyhedra_cuda(dist, points, dirs, faces, SHAPE, order, mode="hull")


def test_kernel_constants_are_the_wrappers():
    """The kernel's face limit and modes are the wrapper's, and its inside
    test's bounds the lattice kernel's (one header)."""
    src = "".join(path.read_text() for path in local_sources(CU))
    assert [p.name for p in local_sources(CU)] == ["raster_polyhedra.cu", "barycentric.cuh"]

    def const(name, kind="int"):
        return re.search(rf"constexpr {kind} {name} = ([^;]+);", src).group(1)
    rows, smem = int(const("ROWS")), int(const("SMEM_MAX"))
    assert smem // (rows * 16) == r3.F_MAX
    modes = re.search(r"enum Mode \{([^}]+)\}", src).group(1)
    assert {m.split("=")[0].strip().lower(): int(m.split("=")[1]) for m in modes.split(",")} \
        == r3.MODES
    assert np.float32(float.fromhex(const("LO", "float").rstrip("f"))) == LATTICE_LO
    assert np.float32(float.fromhex(const("HI", "float").rstrip("f"))) == LATTICE_HI
