"""The rest of stardist_torch's 2D predict surface against stardist_tpu on the
CPU: ``predict_instances(sparse=False)`` and ``scale``, the dense NMS, the
scaled and thresholded label rendering, ``polygons_to_label_coord``, the
legacy ``_old`` functions and ``max_candidates``. Decisions and label images
are exactly equal on the same inputs; the whole f32 pipeline agrees within
the tolerance of test_torch_predict.py."""
import numpy as np
import pytest
import torch

import stardist_tpu.geometry.geom2d as jgeom
import stardist_tpu.nms as jnms
from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_torch.geometry import geom2d as tgeom
from stardist_torch import nms as tnms
from stardist_torch.matching import matching
from stardist_torch.models import StarDist2D
from tests.utils import synthetic_nuclei_2d

torch.set_num_threads(2)

SCALES = [0.5, 2, (1.0, 0.5)]


@pytest.fixture(scope="module")
def setup():
    img, lbl = synthetic_nuclei_2d((128, 128), n=20, seed=6)
    jm = StarDist2DJax(None, "2D_demo", "models/examples")
    tm = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    prob, dist = (np.asarray(a) for a in jm.predict(img))
    return img, lbl, jm, tm, prob, dist


def _close(lab, det, lab_ref, det_ref):
    """test_torch_predict.py's tolerance for the whole f32 pipeline."""
    assert lab.dtype == np.int32 and lab.shape == lab_ref.shape
    assert abs(len(det["prob"]) - len(det_ref["prob"])) <= 1
    assert matching(lab_ref, lab, thresh=0.5).accuracy >= 0.98


def test_dense_nms_equals_reference(setup):
    """non_maximum_suppression on the JAX model's dense maps: survivors'
    points, probs and dists exactly the reference's, in its order."""
    *_, prob, dist = setup
    for kw in (dict(prob_thresh=0.4, nms_thresh=0.3), dict(prob_thresh=0.6, nms_thresh=0.5, b=4)):
        got = tnms.non_maximum_suppression(dist, prob, grid=(2, 2), device="cpu", **kw)
        want = jnms.non_maximum_suppression(dist, prob, grid=(2, 2), **kw)
        assert len(got[0]) > 5
        for a, r in zip(got, want):
            r = np.asarray(r)
            assert a.dtype == r.dtype and np.array_equal(a, r)


@pytest.mark.parametrize("b", [0, 2, 5, ((1, 3), (0, 7)), None])
def test_ind_prob_thresh_equals_reference(setup, b):
    *_, prob, _ = setup
    want = jnms._ind_prob_thresh(prob, 0.5, b)
    assert np.array_equal(tnms._ind_prob_thresh(prob, 0.5, b), want)
    assert np.array_equal(tnms._ind_prob_thresh(torch.from_numpy(prob), 0.5, b).numpy(), want)


@pytest.mark.parametrize("scale", [None] + SCALES)
def test_instances_from_dense_maps_equal_reference(setup, scale):
    """The dense branch of _instances_from_prediction on the same maps,
    unscaled and scaled back by ``scale``: labels, points, probs and coords
    exactly the reference's."""
    img, _, jm, tm, prob, dist = setup
    sc = None if scale is None else dict(zip("YX", np.broadcast_to(scale, 2).tolist()))
    lab_ref, det_ref = jm._instances_from_prediction(img.shape, prob, dist, scale=sc)
    lab, det = tm._instances_from_prediction(img.shape, torch.from_numpy(prob),
                                             torch.from_numpy(dist), None, scale=sc)
    assert lab.max() > 5
    np.testing.assert_array_equal(lab, lab_ref)
    for k in ("points", "prob", "coord"):
        np.testing.assert_array_equal(det[k], det_ref[k])
    assert det["points"].dtype == (np.int32 if scale is None else np.float64)


def test_sparse_false_equals_sparse_and_reference(setup):
    """The port's own sparse=True and sparse=False labels are exactly equal
    (tests/test_model2d.py::test_dense_vs_sparse); sparse=False agrees
    with the JAX call; return_predict gives the dense maps of predict."""
    img, lbl, jm, tm, *_ = setup
    lab_s, det_s = tm.predict_instances(img, prob_thresh=0.4)
    lab_d, det_d = tm.predict_instances(img, sparse=False, prob_thresh=0.4)
    np.testing.assert_array_equal(lab_s, lab_d)
    np.testing.assert_array_equal(np.sort(det_s["prob"]), np.sort(det_d["prob"]))
    assert set(det_d["timings_s"]) == {"forward", "nms", "raster"}
    _close(lab_d, det_d, *jm.predict_instances(img, sparse=False, prob_thresh=0.4))
    assert matching(lbl, lab_d, thresh=0.5).accuracy > 0.6       # it finds the nuclei
    with pytest.warns(UserWarning, match="Setting sparse to False"):
        (lab_r, _), (prob, dist) = tm.predict_instances(img, prob_thresh=0.4,
                                                        return_predict=True)
    np.testing.assert_array_equal(lab_r, lab_d)
    ref_prob, ref_dist = tm.predict(img)
    np.testing.assert_array_equal(prob, ref_prob)
    np.testing.assert_array_equal(dist, ref_dist)


@pytest.mark.parametrize("scale", SCALES)
def test_predict_instances_scale_agrees_with_reference(setup, scale):
    img, _, jm, tm, *_ = setup
    lab, det = tm.predict_instances(img, scale=scale)
    lab_ref, det_ref = jm.predict_instances(img, scale=scale)
    assert lab.shape == img.shape and lab.max() > 3
    _close(lab, det, lab_ref, det_ref)
    assert det["points"].dtype == np.float64


def test_scale_checks_like_the_reference(setup):
    img, _, _, tm, *_ = setup
    for bad in ((1, 2, 3), (0, 1), -1):
        with pytest.raises(ValueError):
            tm.predict_instances(img, scale=bad)
    with pytest.raises(ValueError):
        tm._rescale({"X": 2})


def _polygons(n=80, R=32, shape=(96, 80), seed=0):
    """Seeded polygons with non-integer centres, some across the border."""
    rng = np.random.RandomState(seed)
    d = (rng.uniform(3, 9, (n, 1)) * rng.uniform(0.85, 1.15, (n, R))).astype(np.float32)
    p = rng.uniform(-4, np.array(shape) + 4, (n, 2))
    prob = rng.uniform(0.3, 1, n).astype(np.float32)
    return d, p, prob


@pytest.mark.parametrize("scale_dist", [(1, 1), (0.5, 0.5), (2, 2), (1.0, 0.5), (2.0, 1.0),
                                        (1 / 0.7, 0.8)])
def test_scaled_rendering_equals_reference(scale_dist):
    """polygons_to_label and dist_to_coord with scale_dist, f64 and f32
    centres off the pixel grid: exactly the reference's."""
    d, p, prob = _polygons(seed=int(10 * scale_dist[1]))
    for points in (p, p.astype(np.float32)):
        got = tgeom.polygons_to_label(d, points, (96, 80), prob=prob, scale_dist=scale_dist,
                                      device="cpu")
        want = jgeom.polygons_to_label(d, points, (96, 80), prob=prob, scale_dist=scale_dist)
        assert got.max() > 20 and np.array_equal(got, want)
        got = tgeom.dist_to_coord(d, points, scale_dist=scale_dist)
        want = jgeom.dist_to_coord(d, points, scale_dist=scale_dist)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("thr", [-np.inf, 0.5, 0.9, 1.0])
def test_polygons_to_label_thr_equals_reference(thr):
    d, p, prob = _polygons(seed=3)
    got = tgeom.polygons_to_label(d, p, (96, 80), prob=prob, thr=thr, device="cpu")
    want = jgeom.polygons_to_label(d, p, (96, 80), prob=prob, thr=thr)
    assert np.array_equal(got, want)
    assert got.max() == np.count_nonzero(prob > thr)
    if thr == -np.inf:
        assert np.array_equal(got, tgeom.polygons_to_label(d, p, (96, 80), device="cpu",
                                                           prob=prob))


def test_polygons_to_label_coord_equals_reference():
    d, p, _ = _polygons(seed=4)
    coord = jgeom.dist_to_coord(d, p)
    labels = np.random.RandomState(1).permutation(len(d)) + 3
    for lab in (None, labels):
        got = tgeom.polygons_to_label_coord(coord, (96, 80), labels=lab, device="cpu")
        want = jgeom.polygons_to_label_coord(coord, (96, 80), labels=lab)
        assert got.dtype == np.int32 and got.max() > 20 and np.array_equal(got, want)
    assert tgeom.polygons_to_label_coord(coord[:0], (5, 6), device="cpu").shape == (5, 6)


def test_legacy_functions_equal_reference():
    """The _old trio on the reference's regression field
    (tests/test_api_surface.py::test_legacy_nms_matches_new): each equal to
    stardist_tpu's, and the old and the new route agree."""
    rng = np.random.RandomState(42)
    shape, n_rays, nms_thresh = (178, 149), 32, 0.3
    dist = 10.0 * (1 + 0.1 * rng.uniform(-1, 1, shape + (n_rays,)))
    prob = rng.uniform(0, 1, shape)

    coord = tgeom._dist_to_coord_old(dist)
    np.testing.assert_array_equal(coord, jgeom._dist_to_coord_old(dist))
    np.testing.assert_array_equal(tgeom._dist_to_coord_old(dist[None], grid=(2, 2)),
                                  jgeom._dist_to_coord_old(dist[None], grid=(2, 2)))
    points_old = tnms._non_maximum_suppression_old(coord, prob, prob_thresh=0.9,
                                                   nms_thresh=nms_thresh, device="cpu")
    np.testing.assert_array_equal(points_old, jnms._non_maximum_suppression_old(
        coord, prob, prob_thresh=0.9, nms_thresh=nms_thresh))
    img_old = tgeom._polygons_to_label_old(coord, prob, points_old, shape=shape, device="cpu")
    np.testing.assert_array_equal(img_old, jgeom._polygons_to_label_old(coord, prob, points_old,
                                                                        shape=shape))
    np.testing.assert_array_equal(
        tgeom._polygons_to_label_old(coord, prob, points_old, thr=0.95, device="cpu"),
        jgeom._polygons_to_label_old(coord, prob, points_old, thr=0.95))

    points_new, probi, disti = tnms.non_maximum_suppression(
        dist, prob, prob_thresh=0.9, nms_thresh=nms_thresh, device="cpu")
    assert len(points_old) == len(points_new) > 10
    assert np.allclose(np.sort(points_old, axis=0), np.sort(points_new, axis=0))
    img_new = tgeom.polygons_to_label(disti, points_new, shape=shape, device="cpu")
    assert np.allclose(img_old > 0, img_new > 0)


def test_max_candidates_with_tiles_keeps_the_top_k_of_each_tile(setup):
    """predict_sparse(max_candidates) in tiles: the reference's candidates
    (the top-K of each tile) and one warning per tile that has more."""
    img, _, jm, tm, *_ = setup
    kw = dict(n_tiles=(2, 1), max_candidates=30, prob_thresh=0.3)
    with pytest.warns(UserWarning, match="exceeds max_candidates") as rec:
        got = tm.predict_sparse(img, **kw)
    with pytest.warns(UserWarning, match="exceeds max_candidates") as rec_ref:
        want = [np.asarray(a) for a in jm.predict_sparse(img, **kw)]
    assert len(rec) == len(rec_ref) == 2
    assert len(got[0]) == len(want[0]) <= 60
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)


def test_max_candidates_on_a_padded_image_follows_the_device_dist_route(setup):
    """One padded tile (97^2 -> 104^2) with max_candidates: predict_sparse
    drops padding candidates after the top-K, predict_instances before it
    unless predict_kwargs set device_dist=False (reference
    base.py:1435-1446); each route keeps the reference's candidates and
    survivors, and here the two routes keep different ones."""
    _, _, jm, tm, *_ = setup
    img = synthetic_nuclei_2d((128, 128), n=40, seed=0)[0][:97, :97]
    kw = dict(prob_thresh=0.3, max_candidates=690)
    with pytest.warns(UserWarning, match="exceeds max_candidates"):
        got = tm.predict_sparse(img, **kw)
    with pytest.warns(UserWarning, match="exceeds max_candidates"):
        want = [np.asarray(a) for a in jm.predict_sparse(img, **kw)]
    assert 600 < len(got[0]) == len(want[0]) < 690
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    labels = []
    for device_dist in (False, True):
        kw = dict(prob_thresh=0.3, nms_thresh=0.7,
                  predict_kwargs=dict(device_dist=device_dist, max_candidates=690))
        with pytest.warns(UserWarning, match="exceeds max_candidates"):
            lab, det = tm.predict_instances(img, **kw)
        with pytest.warns(UserWarning, match="exceeds max_candidates"):
            lab_ref, det_ref = jm.predict_instances(img, **kw)
        np.testing.assert_array_equal(det["points"], det_ref["points"])
        _close(lab, det, lab_ref, det_ref)
        labels.append(lab)
    assert labels[0].max() < labels[1].max()
