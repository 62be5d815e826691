"""stardist_torch NMS, polygon helpers and rasterizer against stardist_tpu."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stardist_tpu.ops import polygon as jpoly
from stardist_tpu.ops.nms import nms_polygons as nms_polygons_jax
from stardist_tpu.ops.rasterize import rasterize_polygons as rasterize_jax
from stardist_tpu.nms import non_maximum_suppression_sparse as nms_sparse_jax
from stardist_torch.nms import non_maximum_suppression_sparse
from stardist_torch.ops import polygon as tpoly
from stardist_torch.ops.nms import nms_polygons
from stardist_torch.ops.rasterize import rasterize_polygons

torch.set_num_threads(2)


def _field(n, seed, R=32):
    """Clustered candidates around random objects, sorted by a random score."""
    rng = np.random.RandomState(seed)
    n_obj = max(1, n // 15)
    size = int(np.sqrt(n_obj) * 30)
    c = rng.rand(n_obj, 2) * size
    r = rng.uniform(5, 12, n_obj)
    o = rng.randint(0, n_obj, n)
    pts = np.round(c[o] + rng.randn(n, 2) * 2.5).astype(np.float32)
    d = (r[o, None] * (1 + 0.15 * rng.randn(n, R))).clip(1, None).astype(np.float32)
    score = rng.rand(n).astype(np.float32)
    return d, pts, score


@pytest.mark.parametrize("n,thresh", [(100, 0.4), (300, 0.3), (300, 0.5), (3000, 0.4)])
def test_nms_keep_flags_equal_reference(n, thresh):
    d, p, s = _field(n, n)
    idx = np.argsort(-s, kind="stable")
    d, p = d[idx], p[idx]
    ref = np.asarray(nms_polygons_jax(d, p, thresh=thresh, device_nms=False))
    stats = {}
    keep = nms_polygons(torch.from_numpy(d), torch.from_numpy(p), thresh, stats=stats)
    # decisions: exactly equal
    assert np.array_equal(keep.numpy(), ref)
    assert stats["n_survivors"] == ref.sum() and stats["n_eval_pairs"] > 0


def test_nms_sparse_api_matches_reference():
    d, p, s = _field(400, 7)
    s[10:20] = s[5]                     # ties: descending index among them
    ref = nms_sparse_jax(d, s, p, nms_thresh=0.4)
    got = non_maximum_suppression_sparse(d, s, p, nms_thresh=0.4, device="cpu")
    for a, b in zip(got, ref):
        assert np.array_equal(a, np.asarray(b))


def test_polygon_helpers_match_reference():
    d, p, _ = _field(500, 3)
    lo, hi = tpoly.polygon_bboxes(torch.from_numpy(d), torch.from_numpy(p))
    # the NMS reaches polygon_bboxes inside jit, where XLA:CPU fuses
    # centre + d * dir into one FMA; the port rounds it once the same way
    lo_j, hi_j = jax.jit(jpoly.polygon_bboxes)(jnp.asarray(d), jnp.asarray(p))
    # bboxes: bitwise
    assert np.array_equal(lo.numpy(), np.asarray(lo_j))
    assert np.array_equal(hi.numpy(), np.asarray(hi_j))
    a = tpoly.polygon_areas(torch.from_numpy(d)).numpy()
    # areas: f32 sums in another order
    assert np.allclose(a, np.asarray(jpoly.polygon_areas(jnp.asarray(d))), rtol=1e-6)
    rng = np.random.RandomState(0)
    q = (p[:, None, :] + rng.randn(500, 64, 2) * 8).astype(np.float32)
    inside = tpoly.points_in_polygons(torch.from_numpy(d), torch.from_numpy(p),
                                      torch.from_numpy(q)).numpy()
    ref = np.asarray(jpoly.points_in_polygons(jnp.asarray(d), jnp.asarray(p), jnp.asarray(q)))
    assert np.array_equal(inside, ref)


@pytest.mark.parametrize("shape", [(96, 128), (40, 50)])
def test_rasterize_matches_reference(shape):
    rng = np.random.RandomState(shape[0])
    n = 30
    d = rng.uniform(3, 12, (n, 32)).astype(np.float32)
    p = np.stack([rng.randint(-5, shape[0] + 5, n), rng.randint(-5, shape[1] + 5, n)],
                 1).astype(np.float32)
    order = rng.permutation(n).astype(np.int32) + 1
    order[:3] = 0                          # never drawn
    labels = rng.permutation(n)
    ref, _ = rasterize_jax(d, p, shape, order, labels=labels)
    got = rasterize_polygons(torch.from_numpy(d), torch.from_numpy(p), shape,
                             torch.from_numpy(order), labels=torch.from_numpy(labels))
    # label images: exactly equal
    assert np.array_equal(got.numpy(), ref)
