"""The reference's NMS options in stardist_torch, against stardist_tpu:
``samples`` (the exact overlap test's resolution: the 2D cascade's fine
grid, the 3D lattice's points per axis) at every NMS entry, and the
scheduling options
(``dense_max``, ``row_block``, ``col_block``, ``device_nms``,
``dist_max``), which are taken and change nothing.

The pair function at any S is exactly the reference's Pallas kernel in
interpret mode (test_torch_pair_overlap.py's tolerance); keep flags,
survivors and label images are exactly equal. The options through the
models' entries: tests/test_torch_nms_samples_predict.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import stardist_tpu.nms as jnms
from stardist_tpu.ops.nms import _nms3d_banded_traced
from stardist_tpu.ops.nms import nms_polyhedra as nms_polyhedra_jax
from stardist_tpu.ops.pair_overlap import pair_frac as pair_frac_jax
from stardist_tpu.rays3d import Rays_GoldenSpiral as RaysJax
from stardist_torch import nms as tnms
from stardist_torch.ops import pair_overlap as tpo
from stardist_torch.ops.nms import DENSE_MAX
from stardist_torch.rays3d import Rays_GoldenSpiral
from tests.test_torch_pair_overlap import _pairs

torch.set_num_threads(2)

SCHEDULING = dict(dense_max=8, row_block=3, col_block=5, device_nms=True, dist_max=3.0)


def _polygons(n, seed=1, R=32):
    """n random star polygons over a field where about half overlap
    another, sorted by a random score; at seed 1 (n = 150 and 400) every
    tested S keeps other flags than S = 16."""
    rng = np.random.RandomState(seed)
    side = int(np.sqrt(n) * 9)
    p = (rng.rand(n, 2) * side).astype(np.float32)
    r = rng.uniform(5, 12, n)
    d = (r[:, None] * (1 + 0.2 * rng.randn(n, R))).clip(1, None).astype(np.float32)
    s = rng.rand(n).astype(np.float32)
    o = np.argsort(-s, kind="stable")
    return d[o], p[o], s[o]


def _polyhedra(n):
    """Clustered, overlapping polyhedra in descending-score order (the field
    of test_torch_predict3d_surface.py's keep-flag test)."""
    rng = np.random.RandomState(n)
    n_obj = n // 8
    centers = np.stack([rng.uniform(10, 50, n_obj), rng.uniform(10, 100, n_obj),
                        rng.uniform(10, 300, n_obj)], axis=1)
    obj = rng.randint(0, n_obj, n)
    points = np.round(centers[obj] + rng.normal(0, 1.5, (n, 3))).astype(np.float32)
    radii = rng.uniform(4, 7, n_obj)[obj]
    dist = (radii[:, None] * rng.uniform(0.85, 1.15, (n, 16))).astype(np.float32)
    return dist, points


@pytest.mark.parametrize("S", [5, 10, 12, 24])
@pytest.mark.parametrize("R", [32, 16])
def test_pair_frac_plain_matches_pallas_at_any_S(S, R):
    args = _pairs(1000, R, S + R)
    ref = np.asarray(pair_frac_jax(*map(jnp.asarray, args), S=S, interpret=True))
    got = tpo.pair_frac(*map(torch.from_numpy, args), S=S).numpy()
    # counts of 0/1 samples times f32(1 / S^2), as XLA computes the
    # kernel's mean: exact; an FMA of XLA:CPU could move a sample within
    # one rounding of an edge, a difference of exactly 1/S^2
    diff = np.abs(got - ref) * S * S
    assert np.all((diff == 0) | (diff == 1))
    assert np.count_nonzero(diff) <= len(ref) // 1000
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("S", [4, 10, 12, 20])
@pytest.mark.parametrize("n", [150, 400], ids=["dense", "bounded"])
def test_2d_keep_flags_equal_reference_at_samples(n, S):
    """Below DENSE_MAX the reference's dense path, above it its blocked
    path with bounds; both share the cascade with the fine grid S."""
    d, p, s = _polygons(n)
    assert (n <= DENSE_MAX) == (n == 150)
    ref = np.asarray(jnms.non_maximum_suppression_inds(d, p, s, thresh=0.4, samples=S,
                                                       verbose=False))
    stats = {}
    got = tnms.non_maximum_suppression_inds(d, p, s, thresh=0.4, samples=S, stats=stats,
                                            device="cpu")
    assert np.array_equal(got, ref)
    assert stats["n_fine_pairs"] > 0
    # the option reaches the criterion: S = 16, the default, keeps other flags
    assert not np.array_equal(got, tnms.non_maximum_suppression_inds(d, p, s, thresh=0.4,
                                                                     device="cpu"))


@pytest.mark.parametrize("S", [6, 10, 12])
def test_3d_keep_flags_equal_reference_at_samples(S):
    """The port's lattice at S against the reference's device NMS
    (_nms3d_banded_traced, which its 3D device path runs at S = 10) and its
    host NMS (nms_polyhedra with device_nms=False, S = 12 by default)."""
    n, thresh = 200, 0.3
    dist, points = _polyhedra(n)
    rays = RaysJax(16)
    Q = 64
    Npad = -(-n // Q) * Q
    d = np.full((Npad, 16), 1e-3, np.float32)
    d[:n] = dist
    p = np.zeros((Npad, 3), np.float32)
    p[:n] = points
    keep, flags, _ = _nms3d_banded_traced(
        jnp.asarray(d), jnp.asarray(p), jnp.asarray(rays.vertices, jnp.float32),
        jnp.asarray(rays.faces, jnp.int32), jnp.int32(n), jnp.float32(thresh), (1, 1, 1), 2,
        Q, Npad // Q, Q, Q * Q, S)
    assert all(bool(f) for f in flags)
    host = np.asarray(nms_polyhedra_jax(dist, points, rays, thresh=thresh, samples=S,
                                        device_nms=False))
    scores = np.arange(n, 0, -1).astype(np.float32)
    got = tnms.non_maximum_suppression_3d_inds(dist, points, Rays_GoldenSpiral(16), scores,
                                               thresh=thresh, samples=S, device="cpu")
    assert 0 < got.sum() < n // 2
    assert np.array_equal(got, np.asarray(keep)[:n]) and np.array_equal(got, host)


@pytest.mark.parametrize("entry", ["2d inds", "2d sparse", "2d dense", "3d inds", "3d sparse"])
def test_scheduling_options_change_nothing(entry):
    """The reference's scheduling options are taken by every NMS entry and
    change no flag; a name the reference does not take raises TypeError,
    and samples < 1 ValueError."""
    if entry.startswith("2d"):
        d, p, s = _polygons(400)
        fn = {"2d inds": lambda **kw: (tnms.non_maximum_suppression_inds(
                  d, p, s, 0.4, device="cpu", **kw),),
              "2d sparse": lambda **kw: tnms.non_maximum_suppression_sparse(
                  d, s, p, nms_thresh=0.4, device="cpu", **kw),
              "2d dense": lambda **kw: tnms.non_maximum_suppression(
                  d.reshape(20, 20, 32), s.reshape(20, 20), grid=(4, 4), nms_thresh=0.4,
                  prob_thresh=0.2, device="cpu", **kw)}[entry]
    else:
        dist, points = _polyhedra(120)
        rays = Rays_GoldenSpiral(16)
        scores = np.linspace(1, 0, len(dist)).astype(np.float32)
        fn = {"3d inds": lambda **kw: (tnms.non_maximum_suppression_3d_inds(
                  dist, points, rays, scores, 0.3, device="cpu", **kw),),
              "3d sparse": lambda **kw: tnms.non_maximum_suppression_3d_sparse(
                  dist, scores, points, rays, nms_thresh=0.3, device="cpu", **kw)}[entry]
    base = fn()
    assert 0 < len(base[0]) and np.asarray(base[0]).sum() > 0
    for kw in (SCHEDULING, dict(SCHEDULING, device_nms=False, dense_max=10 ** 6)):
        assert all(np.array_equal(a, b) for a, b in zip(fn(**kw), base))
    with pytest.raises(TypeError):
        fn(sample=12)
    with pytest.raises(ValueError):
        fn(samples=0)
