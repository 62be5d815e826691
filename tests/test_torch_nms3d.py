"""stardist_torch 3D polyhedron NMS against stardist_tpu's host path
(``nms_polyhedra(..., device_nms=False)``): keep flags exactly equal, on the
3D_demo model's own candidates and on seeded fields."""
import numpy as np
import pytest
import torch

from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_tpu.nms import non_maximum_suppression_3d_sparse as nms3d_sparse_jax
from stardist_tpu.ops.nms import nms_polyhedra as nms_polyhedra_jax
from stardist_tpu.rays3d import Rays_GoldenSpiral
from stardist_torch.nms import non_maximum_suppression_3d_sparse
from stardist_torch.ops import nms as ops_nms
from stardist_torch.ops.nms import nms_polyhedra
from stardist_torch.ops.polyhedron import ray_tensors
from tests.utils import synthetic_nuclei_3d

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def candidates():
    """The 3D_demo model's candidates on a synthetic field, sorted as the
    reference's NMS sorts them (descending prob, stable)."""
    jm = StarDist3DJax(None, "3D_demo", "models/examples")
    img, _ = synthetic_nuclei_3d((48, 64, 64), seed=0)
    prob, dist, points = jm.predict_sparse(img)
    o = np.argsort(prob, kind="stable")[::-1]
    return (prob[o], np.asarray(dist)[o].astype(np.float32), points[o].astype(np.float32),
            jm.rays, jm.thresholds.nms)


@pytest.fixture(scope="module")
def reference_keep(candidates):
    """The reference's host-path keep flags on ``candidates``."""
    _, d, p, rays, thresh = candidates
    return np.asarray(nms_polyhedra_jax(d, p, rays, thresh=thresh, device_nms=False))


def _port_keep(d, p, rays, thresh, stats=None):
    dirs, faces = ray_tensors(rays)
    return nms_polyhedra(torch.from_numpy(d), torch.from_numpy(p), dirs, faces,
                         thresh=thresh, stats=stats).numpy()


def test_keep_flags_equal_reference_on_model_candidates(candidates, reference_keep):
    _, d, p, rays, thresh = candidates
    assert len(d) > 1000                      # real NMS work (2364 candidates)
    stats = {}
    keep = _port_keep(d, p, rays, thresh, stats)
    # decisions: exactly equal
    assert np.array_equal(keep, reference_keep)
    assert stats["n_survivors"] == reference_keep.sum() and stats["n_eval_pairs"] > 0
    assert stats["n_candidates"] == len(d) and stats["exact_s"] > 0


@pytest.mark.parametrize("block", [16, 4096])
def test_keep_flags_do_not_depend_on_the_block_size(candidates, reference_keep, block,
                                                    monkeypatch):
    """The keep flags are the greedy's unique fixpoint, so any row block
    gives the reference's: 16 rows (a block and a pair search for each 16
    candidates not yet suppressed) and 4096 rows (all 2364 candidates in one block, the pairs searched
    once, as the 2D NMS does)."""
    _, d, p, rays, thresh = candidates
    calls = []
    search = ops_nms._candidate_pairs

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return search(*args, **kwargs)

    monkeypatch.setattr(ops_nms, "ROW_BLOCK", block)
    monkeypatch.setattr(ops_nms, "_candidate_pairs", counted)
    stats = {}
    keep = _port_keep(d, p, rays, thresh, stats)
    assert np.array_equal(keep, reference_keep)
    assert stats["n_survivors"] == reference_keep.sum()
    if block >= len(d):
        assert calls == [len(d)]
    else:
        assert len(calls) > 1


@pytest.mark.parametrize("n", [0, 1, 2, 20, 32])
def test_dense_branch_and_tiny_inputs(candidates, n):
    """N <= 32: the reference's dense branch (no bounds)."""
    _, d, p, rays, thresh = candidates
    sub = np.arange(0, 4 * n, 4)[:n]          # neighbours that overlap
    ref = np.asarray(nms_polyhedra_jax(d[sub], p[sub], rays, thresh=thresh, device_nms=False))
    keep = _port_keep(d[sub], p[sub], rays, thresh)
    assert keep.shape == (n,) and np.array_equal(keep, ref)
    if n >= 20:
        assert 0 < keep.sum() < n


def test_nms_3d_sparse_api_matches_reference(candidates):
    """The sparse API on an unsorted list with ties: both sorts of the
    reference (sparse, then inds) and the returned order."""
    prob, d, p, rays, thresh = candidates
    rng = np.random.RandomState(0)
    sub = rng.permutation(len(d))[:300]
    prob, d, p = prob[sub].copy(), d[sub], p[sub]
    prob[10:40] = prob[5]                     # ties
    ref = nms3d_sparse_jax(d, prob, p, rays, nms_thresh=thresh)
    got = non_maximum_suppression_3d_sparse(d, prob, p, rays, nms_thresh=thresh, device="cpu")
    assert len(ref[0]) > 1
    for a, b in zip(got, ref):
        assert np.array_equal(a, np.asarray(b))


def _field(n, seed, R=32):
    """Clustered polyhedra around random objects."""
    rng = np.random.RandomState(seed)
    n_obj = max(1, n // 12)
    size = int(np.cbrt(n_obj) * 24)
    c = rng.rand(n_obj, 3) * size
    r = rng.uniform(4, 9, n_obj)
    o = rng.randint(0, n_obj, n)
    pts = np.round(c[o] + rng.randn(n, 3) * 2).astype(np.float32)
    d = (r[o, None] * (1 + 0.15 * rng.randn(n, R))).clip(1, None).astype(np.float32)
    return d, pts


@pytest.mark.parametrize("n,thresh", [(120, 0.3), (120, 0.6), (200, 0.4)])
def test_keep_flags_equal_reference_on_seeded_fields(n, thresh):
    d, p = _field(n, n + int(10 * thresh))
    rays = Rays_GoldenSpiral(32)
    ref = np.asarray(nms_polyhedra_jax(d, p, rays, thresh=thresh, device_nms=False))
    keep = _port_keep(d, p, rays, thresh)
    assert 0 < ref.sum() < n
    assert np.array_equal(keep, ref)
