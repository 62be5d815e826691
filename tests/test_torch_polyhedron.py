"""stardist_torch polyhedron geometry, rays and 3D rasterizer against
stardist_tpu on seeded polyhedra and query points."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stardist_tpu import rays3d as jrays
from stardist_tpu.ops import polyhedron as J
from stardist_tpu.ops.rasterize import rasterize_polyhedra as rasterize_jax
from stardist_torch import rays3d as trays
from stardist_torch.ops import polyhedron as T
from stardist_torch.ops.rasterize import rasterize_polyhedra

torch.set_num_threads(2)


def _polyhedra(n, R, seed, spread=40):
    """Seeded irregular star polyhedra on integer centres, and integer
    query points around them."""
    rng = np.random.RandomState(seed)
    d = (rng.uniform(3, 10, (n, 1)) * (1 + 0.2 * rng.randn(n, R))).clip(0.5).astype(np.float32)
    p = rng.randint(0, spread, (n, 3)).astype(np.float32)
    q = (p[:, None, :] + rng.randint(-12, 13, (n, 256, 3))).astype(np.float32)
    return d, p, q


@pytest.fixture(scope="module", params=[32, 96])
def rays(request):
    return jrays.Rays_GoldenSpiral(request.param)


def _tensors(rays):
    return T.ray_tensors(trays.rays_from_json(rays.to_json()))


def test_rays_are_a_copy_of_the_reference(rays):
    tr = trays.rays_from_json(rays.to_json())
    assert tr.to_json() == rays.to_json()
    assert np.array_equal(tr.vertices, rays.vertices) and np.array_equal(tr.faces, rays.faces)
    assert np.array_equal(tr.copy(scale=(2, 1, 0.5)).vertices,
                          rays.copy(scale=(2, 1, 0.5)).vertices)
    for cls in ("Rays_Octo", "Rays_Tetra", "Rays_Cartesian"):
        r0 = getattr(jrays, cls)()
        r1 = trays.rays_from_json(r0.to_json())
        assert np.array_equal(r0.vertices, r1.vertices) and np.array_equal(r0.faces, r1.faces)


def test_volumes_inverses_bboxes_radii(rays):
    d, p, _ = _polyhedra(200, len(rays), 0)
    dirs = jnp.asarray(np.asarray(rays.vertices, np.float32))
    faces = jnp.asarray(np.asarray(rays.faces, np.int32))
    td, tp = torch.from_numpy(d), torch.from_numpy(p)
    tdirs, tfaces = _tensors(rays)
    # f32 sums in another order: 1e-5 relative
    vol = T.polyhedron_volumes(td, tdirs, tfaces).numpy()
    vol_ref = np.asarray(J.polyhedron_volumes(jnp.asarray(d), dirs, faces))
    assert np.allclose(vol, vol_ref, rtol=1e-5, atol=0)
    inv, valid = T.polyhedron_face_inverses(td, tdirs, tfaces)
    inv_ref, valid_ref = J.polyhedron_face_inverses(jnp.asarray(d), dirs, faces)
    assert np.array_equal(valid.numpy(), np.asarray(valid_ref))
    assert np.abs(inv.numpy() - np.asarray(inv_ref)).max() <= 1e-5 * np.abs(inv_ref).max()
    rin = T.polyhedron_inner_radius(td, tdirs, tfaces).numpy()
    rin_ref = np.asarray(J.polyhedron_inner_radius(jnp.asarray(d), dirs, faces))
    assert np.allclose(rin, rin_ref, rtol=1e-5, atol=0)
    # the NMS reaches polyhedron_bboxes inside jit, where XLA:CPU fuses
    # centre + d * dir into one FMA; the port rounds it once the same way:
    # bitwise with the 3D_demo's 32 rays (the NMS tests' case). At 96 rays
    # XLA's fused loop rounds some vertices otherwise: one f32 rounding.
    lo, hi = T.polyhedron_bboxes(td, tp, tdirs)
    lo_ref, hi_ref = jax.jit(J.polyhedron_bboxes)(jnp.asarray(d), jnp.asarray(p), dirs)
    if len(rays) == 32:
        assert np.array_equal(lo.numpy(), np.asarray(lo_ref))
        assert np.array_equal(hi.numpy(), np.asarray(hi_ref))
    assert np.allclose(lo.numpy(), np.asarray(lo_ref), rtol=1e-6, atol=1e-6)
    assert np.allclose(hi.numpy(), np.asarray(hi_ref), rtol=1e-6, atol=1e-6)


def test_points_in_polyhedra_exact(rays):
    d, p, q = _polyhedra(150, len(rays), 1)
    dirs = jnp.asarray(np.asarray(rays.vertices, np.float32))
    faces = jnp.asarray(np.asarray(rays.faces, np.int32))
    inv_ref, valid_ref = J.polyhedron_face_inverses(jnp.asarray(d), dirs, faces)
    ref = np.asarray(J.points_in_polyhedra(inv_ref, valid_ref, jnp.asarray(p), jnp.asarray(q)))
    tdirs, tfaces = _tensors(rays)
    inv, valid = T.polyhedron_face_inverses(torch.from_numpy(d), tdirs, tfaces)
    got = T.points_in_polyhedra(inv, valid, torch.from_numpy(p), torch.from_numpy(q)).numpy()
    assert 0.05 < ref.mean() < 0.95                      # both sides of the surfaces
    # decisions: exactly equal
    assert np.array_equal(got, ref)
    # the flat-list form used by the NMS decides the same points
    idx = torch.arange(150).repeat_interleave(256)
    flat = T.points_in_indexed_polyhedra(inv, valid, torch.from_numpy(p), idx,
                                         torch.from_numpy(q.reshape(-1, 3))).numpy()
    assert np.array_equal(flat, ref.reshape(-1))


@pytest.mark.parametrize("shape", [(24, 40, 36), (17, 23, 29)])
def test_rasterize_polyhedra_matches_reference(rays, shape):
    rng = np.random.RandomState(shape[0])
    n = 12
    d = rng.uniform(2, 7, (n, len(rays))).astype(np.float32)
    p = np.stack([rng.randint(-3, s + 3, n) for s in shape], 1).astype(np.float32)
    order = rng.permutation(n).astype(np.int32) + 1
    order[:2] = 0                          # never drawn
    labels = rng.permutation(n).astype(np.int32) + 1
    ref, cnt_ref = rasterize_jax(d, p, rays, shape, order, labels=labels)
    tdirs, tfaces = _tensors(rays)
    got, cnt = rasterize_polyhedra(torch.from_numpy(d), torch.from_numpy(p), tdirs, tfaces,
                                   shape, torch.from_numpy(order),
                                   labels=torch.from_numpy(labels), return_count=True)
    assert ref.max() > 0
    # label volumes and overlap counts: exactly equal
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(cnt.numpy(), cnt_ref)
