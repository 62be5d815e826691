"""The 3D NMS's exact lattice counts (``stardist_torch/ops/lattice_overlap.py``)
on the CPU: the plain version against an independent numpy count, its
inside test at the f32 bounds the CUDA kernel copies, the NMS's lattice
counters, and the kernel's constants against the wrapper's. The kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``). Imports no JAX."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (LATTICE_HI, LATTICE_LO, lattice_bound_cases, lattice_pair_set,
                        octahedron_rays)
from stardist_torch.ops import lattice_overlap as tlk
from stardist_torch.ops.cuda_build import local_sources
from stardist_torch.ops import nms as tnms
from stardist_torch.ops.polyhedron import polyhedron_bboxes, ray_tensors
from stardist_torch.rays3d import Rays_GoldenSpiral

torch.set_num_threads(2)

CU = Path(tlk.__file__).resolve().parents[1] / "csrc" / "lattice_overlap.cu"


def _numpy_grid(lo, hi, i, j, S):
    """plo, phi, stride (P, 3) of the pairs' lattices, in numpy f32."""
    lo, hi, i, j = (np.asarray(a) for a in (lo, hi, i, j))
    plo = np.ceil(np.maximum(lo[i], lo[j]))
    phi = np.floor(np.minimum(hi[i], hi[j]))
    stride = np.maximum(np.ceil(np.maximum(phi - plo + 1, 0) / np.float32(S)), 1)
    return plo, phi, stride


def _numpy_counts(points, inv, valid, i, j, plo, phi, stride, S):
    """(P, 3) int: each pair's lattice points, points inside i and points
    inside both, by numpy in f32 (every point tested against both)."""
    points, inv, valid, i, j, plo, phi, stride = (
        np.asarray(a) for a in (points, inv, valid, i, j, plo, phi, stride))

    def inside(q, n):
        u = q - points[n]
        m = inv[n]
        b0, b1, b2 = ((m[None, :, r, 0] * u[:, 0, None] + m[None, :, r, 1] * u[:, 1, None])
                      + m[None, :, r, 2] * u[:, 2, None] for r in range(3))
        ok = ((b0 >= LATTICE_LO) & (b1 >= LATTICE_LO) & (b2 >= LATTICE_LO)
              & ((b0 + b1) + b2 <= LATTICE_HI) & valid[n][None])
        return ok.any(axis=1)

    out = np.zeros((len(i), 3), np.int64)
    for p, (a, b) in enumerate(zip(i, j)):
        axes = [plo[p, k] + stride[p, k] * np.arange(S, dtype=np.float32) for k in range(3)]
        axes = [ax[ax <= phi[p, k]] for k, ax in enumerate(axes)]
        q = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
        in_a = inside(q, a)
        out[p] = len(q), in_a.sum(), (in_a & inside(q, b)).sum()
    return out


def _field(n, seed, R=32):
    """n seeded polyhedra of R golden-spiral rays in clusters:
    (dist, points, ray_dirs, faces)."""
    rng = np.random.RandomState(seed)
    dirs, faces = ray_tensors(Rays_GoldenSpiral(R))
    centres = rng.uniform(8, 40, (max(1, n // 10), 3))
    points = centres[rng.randint(len(centres), size=n)] + rng.normal(0, 2.5, (n, 3))
    dist = rng.uniform(3, 7, (n, R))
    return (torch.from_numpy(dist.astype(np.float32)),
            torch.from_numpy(points.astype(np.float32)), dirs, faces)


@pytest.mark.parametrize("S", [3, 12])
def test_nms_lattice_counters_equal_a_numpy_count(monkeypatch, S):
    """``n_lattice_points`` and ``n_lattice_inside_first`` of a small 3D
    NMS are sums of a numpy count over the pairs the NMS tested exactly
    (lattices from the bboxes, in numpy too), and each pair's counts are
    the numpy count's."""
    dist, points, dirs, faces = _field(80, S)
    calls = []

    def record(*args):
        calls.append((args, tlk.lattice_counts(*args)))
        return calls[-1][1]
    monkeypatch.setattr(tnms, "lattice_counts", record)
    stats = {}
    keep = tnms.nms_polyhedra(dist, points, dirs, faces, thresh=0.3, stats=stats, samples=S)
    assert len(calls) == stats["n_rounds"] > 0 and 0 < int(keep.sum()) < len(keep)
    pts, inv, valid = calls[0][0][:3]
    i, j = (torch.cat([c[0][k] for c in calls]) for k in (3, 4))
    assert len(i) == stats["n_eval_pairs"]
    lo, hi = polyhedron_bboxes(dist, points, dirs)
    want = _numpy_counts(pts, inv, valid, i, j, *_numpy_grid(lo, hi, i, j, S), S)
    assert np.array_equal(torch.cat([c[1] for c in calls]).numpy(), want[:, 1:])
    assert stats["n_lattice_points"] == want[:, 0].sum() > 0
    assert stats["n_lattice_inside_first"] == want[:, 1].sum() > want[:, 2].sum() > 0


def test_nms_lattice_counters_of_a_trivial_call():
    dist, points, dirs, faces = _field(1, 0)
    stats = {}
    tnms.nms_polyhedra(dist, points, dirs, faces, stats=stats)
    assert stats["n_lattice_points"] == stats["n_lattice_inside_first"] == 0


@pytest.mark.parametrize("rays,S", [("octahedron", 2), ("octahedron", 5), ("octahedron", 24),
                                    ("golden32", 6), ("golden96", 2)])
def test_plain_counts_equal_a_numpy_count(rays, S):
    """Seeded pairs with degenerate faces and, at small S, strides above 1;
    octahedra with integer distances and centres, whose faces pass through
    lattice points (barycentric sums rounded to either side of 1)."""
    if rays == "octahedron":
        dirs, faces = octahedron_rays()
    else:
        dirs, faces = ray_tensors(Rays_GoldenSpiral(int(rays[6:])))
    args = lattice_pair_set(dirs, faces, 40, S, "cpu", seed=S, integer=rays == "octahedron")
    valid, i, stride = args[2], args[3], args[7]
    assert not valid.all() and len(i) > 20 and ((stride > 1).any() or S == 24)
    want = _numpy_counts(*args, S)
    assert np.array_equal(tlk.lattice_counts(*args, S).numpy(), want[:, 1:])
    assert np.array_equal(tlk.lattice_points(*args[5:], S).numpy(), want[:, 0])
    assert want[:, 2].sum() > 0


@pytest.mark.parametrize("F", [1, 8, 60])
def test_plain_inside_test_flips_at_the_f32_bounds(F):
    """A point whose barycentric coordinate is f32(-1e-7), or whose sum is
    f32(1 + 1e-7), is inside; one f32 ulp further out it is not; degenerate
    faces never pass; an empty lattice counts nothing. These are the
    bounds ``csrc/lattice_overlap.cu`` compares with."""
    args = lattice_bound_cases(F, "cpu")
    got = tlk.lattice_counts(*args[:8], 1)
    assert torch.equal(got, args[8])
    assert 0 < int(args[8][:, 1].sum()) < int(args[8][:, 0].sum()) < len(got)


def test_plain_counts_do_not_depend_on_the_step(monkeypatch):
    dirs, faces = ray_tensors(Rays_GoldenSpiral(32))
    args = lattice_pair_set(dirs, faces, 40, 12, "cpu", seed=3)
    want = tlk.lattice_counts(*args, 12)
    monkeypatch.setattr(tlk, "LATTICE_PAIRS", 1)
    assert torch.equal(tlk.lattice_counts(*args, 12), want)


def test_lattice_counts_raise_on_a_device_neither_cpu_nor_cuda():
    dirs, faces = ray_tensors(Rays_GoldenSpiral(32))
    args = lattice_pair_set(dirs, faces, 12, 12, "cpu", seed=0)
    with pytest.raises(RuntimeError, match="no lattice kernel"):
        tlk.lattice_counts(*(t.to("meta") for t in args), 12)


def test_kernel_constants_are_the_wrappers_and_torchs_bounds():
    """The kernel's limits are the wrapper's checks, and its bounds the f32
    values PyTorch compares an f32 tensor with for the Python floats
    -1e-7 and 1 + 1e-7 (the kernel's source with the headers it includes)."""
    src = "".join(path.read_text() for path in local_sources(CU))

    def const(name, kind="int"):
        pattern = rf"constexpr {kind} {name} = ([^;]+);"
        return re.search(pattern, src).group(1)
    warps, rows, smem = (int(const(n)) for n in ("WARPS", "ROWS", "SMEM_MAX"))
    assert smem // (warps * 2 * rows * 16) == tlk.F_MAX
    assert int(const("S_MAX")) == tlk.S_MAX and tlk.S_MAX ** 3 < 2 ** 31 <= (tlk.S_MAX + 1) ** 3
    lo, hi = (np.float32(float.fromhex(const(n, "float").rstrip("f"))) for n in ("LO", "HI"))
    assert lo == LATTICE_LO == np.float32(-1e-7) and hi == LATTICE_HI == np.float32(1 + 1e-7)
    t = torch.tensor([lo, hi, np.nextafter(lo, np.float32(-1)), np.nextafter(hi, np.float32(2))])
    assert (t >= -1e-7).tolist() == [True, True, False, True]
    assert (t <= 1 + 1e-7).tolist() == [True, True, True, False]
