"""stardist_torch's threshold search (``utils.optimize_threshold``,
``StarDistBase.optimize_thresholds``) and its prefix NMS (``_nms_keep``)
against stardist_tpu on the CPU: the same (prob_thresh, measure) on the same
dense predictions, keep flags exactly equal, and a ``thresholds.json`` that
both packages read."""
import json
import shutil

import numpy as np
import pytest
import torch

from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_tpu.utils import optimize_threshold as optimize_threshold_jax
from stardist_torch.models import StarDist2D, StarDist3D
from stardist_torch.nms import _ind_prob_thresh, descending_order
from stardist_torch.utils import optimize_threshold
from tests.utils import synthetic_nuclei_2d

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    return (StarDist2D(None, "2D_demo", "models/examples", device="cpu"),
            StarDist2DJax(None, "2D_demo", "models/examples"))


@pytest.fixture(scope="module")
def validation(models):
    """Two 128^2 synthetic fields, their labels, and the JAX model's dense
    predictions of them (the search's input, given to both packages)."""
    _, jm = models
    data = [synthetic_nuclei_2d((128, 128), n=20, seed=s) for s in (3, 4)]
    Yhat = [tuple(np.asarray(a) for a in jm.predict(x)[:2]) for x, _ in data]
    return [x for x, _ in data], [y for _, y in data], Yhat


def _candidates(prob, dist, thresh, grid=(2, 2)):
    """The search's sorted candidate list of one image's dense maps, as
    numpy (prob, dist, points), thresholded at ``thresh``; the order is held
    to the reference's ``np.argsort(prob, kind="stable")[::-1]``."""
    mask = _ind_prob_thresh(torch.from_numpy(prob), thresh)
    o = descending_order(torch.from_numpy(prob)[mask]).numpy()
    np.testing.assert_array_equal(o, np.argsort(prob[mask.numpy()], kind="stable")[::-1])
    points = np.stack(np.nonzero(mask.numpy()), 1)[o] * np.array(grid)
    return prob[mask.numpy()][o], dist[mask.numpy()][o], points.astype(np.float32)


@pytest.mark.parametrize("nms_thresh", [0.3, 0.5])
def test_optimize_threshold_equals_reference(models, validation, nms_thresh):
    """Given the same Yhat, the port's search probes the same thresholds
    and returns exactly the JAX function's (prob_thresh, measure)."""
    tm, jm = models
    _, Y, Yhat = validation
    timings = {}
    got = optimize_threshold(Y, Yhat, tm, nms_thresh, maxiter=6, timings=timings)
    want = optimize_threshold_jax(Y, Yhat, jm, nms_thresh, maxiter=6)
    assert got == want
    assert 0.3 < got[1] <= 1
    assert timings["probes"] >= 6
    assert set(timings) == {"extract", "nms", "render", "matching", "probes"}


def test_nms_keep_2d_equals_reference_and_is_prefix_exact(models, validation):
    """_nms_keep: exactly the JAX flags; and NMS on the first n candidates
    gives the first n flags, for n that cut through runs of tied probs."""
    tm, jm = models
    prob, dist = validation[2][0]
    # probs rounded to 1/64: runs of ties, as a coarse prob map has them
    prob, dist, points = _candidates(np.round(prob * 64) / np.float32(64), dist, 0.35)
    assert len(prob) > 300
    keep = tm._nms_keep(prob, dist, points, 0.3)
    assert keep.dtype == torch.bool
    keep = keep.numpy()
    np.testing.assert_array_equal(keep, np.asarray(jm._nms_keep(prob, dist, points, 0.3)))
    assert 0 < keep.sum() < len(keep)
    # ties: cut inside runs of equal probs
    _, first, counts = np.unique(-prob, return_index=True, return_counts=True)
    cuts = [int(f + c // 2) for f, c in zip(first, counts) if c > 2][:4]
    assert len(cuts) == 4
    for n in cuts + [1, len(prob) // 3, len(prob) - 1]:
        sub = tm._nms_keep(prob[:n], dist[:n], points[:n], 0.3).numpy()
        np.testing.assert_array_equal(sub, keep[:n])


def test_nms_keep_3d_equals_reference():
    """A tiny 3D candidate list (the lattice test is slow on the CPU)."""
    tm = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
    jm = StarDist3DJax(None, "3D_demo", "models/examples")
    rng = np.random.RandomState(0)
    n, R = 14, tm.config.n_rays
    points = rng.uniform(6, 26, (n, 3)).astype(np.float32)
    dist = (rng.uniform(3, 6, (n, 1)) * rng.uniform(0.9, 1.1, (n, R))).astype(np.float32)
    prob = np.sort(rng.uniform(0.5, 1, n).astype(np.float32))[::-1].copy()
    prob[3:6] = prob[3]                                  # a run of ties
    keep = tm._nms_keep(prob, dist, points, 0.3).numpy()
    want = np.asarray(jm._nms_keep(prob, dist, points, 0.3))
    np.testing.assert_array_equal(keep, want)
    assert 0 < keep.sum() < n


def test_probe_count_is_an_f64_comparison(models, validation, monkeypatch):
    """A probe's prefix is the count of prob > prob_thresh compared in f64,
    as the reference's np.searchsorted does: a prob equal to
    float32(prob_thresh) but above prob_thresh is in the prefix, one at
    nextafter below it is not (in f32 the first would be out too)."""
    import types
    import stardist_torch.utils as tutils
    tm, _ = models
    _, Y, Yhat = validation
    thr = 0.6000000001                          # f32(thr) = 0.6f > thr
    f = np.float32(thr)
    below = np.nextafter(f, np.float32(0))
    assert float(f) > thr and not f > np.float32(thr)
    prob, dist = Yhat[0][0].copy(), Yhat[0][1]
    flat = prob.reshape(-1)
    big = np.flatnonzero(flat > 0.7)[:2]
    flat[big] = f, below
    seen = []

    def render(shape, d, p, pr, *a, **k):
        seen.append(pr.numpy().copy())
        return np.zeros(shape, np.int32), {}

    def one_probe(fn, **kw):                   # the search, cut to one probe at thr
        return types.SimpleNamespace(x=thr, fun=fn(thr))
    monkeypatch.setattr(tm, "_render_survivors", render)
    monkeypatch.setattr(tm, "_nms_keep", lambda prob, *a: torch.ones(len(prob), dtype=bool))
    monkeypatch.setattr(tutils, "minimize_scalar", one_probe)
    optimize_threshold(Y[:1], [(prob, dist)], tm, 0.5, bracket=(0.5, 0.99), verbose=0)
    (drawn,) = seen                            # the whole prefix: every flag is set
    assert f in drawn and below not in drawn and (drawn.astype(np.float64) > thr).all()
    assert len(drawn) == np.count_nonzero(prob[2:-2, 2:-2].astype(np.float64) > thr)


def test_optimize_thresholds_end_to_end(models, tmp_path):
    """On one 128^2 field, the port's thresholds agree with the JAX
    package's within the search's tol; the written thresholds.json is read
    back by a fresh port model and by stardist_tpu."""
    for name in ("port", "jax"):
        shutil.copytree("models/examples/2D_demo", tmp_path / name)
    x, y = synthetic_nuclei_2d((128, 128), n=20, seed=5)
    tm = StarDist2D(None, "port", str(tmp_path), device="cpu")
    jm = StarDist2DJax(None, "jax", str(tmp_path))
    kw = dict(nms_threshs=(0.3, 0.5), optimize_kwargs=dict(maxiter=6))
    timings = {}
    got = tm.optimize_thresholds([x], [y], timings=timings, **kw)
    want = jm.optimize_thresholds([x], [y], **kw)
    assert got["nms"] == want["nms"]
    assert abs(got["prob"] - want["prob"]) <= 1e-2
    assert tm.thresholds.prob == got["prob"] and tm.thresholds.nms == got["nms"]
    assert timings["predict"] > 0 and timings["probes"] >= 12
    saved = json.loads((tmp_path / "port" / "thresholds.json").read_text())
    assert saved == got
    fresh = StarDist2D(None, "port", str(tmp_path), device="cpu")
    assert (fresh.thresholds.prob, fresh.thresholds.nms) == (got["prob"], got["nms"])
    shutil.copy(tmp_path / "port" / "thresholds.json", tmp_path / "jax" / "thresholds.json")
    reread = StarDist2DJax(None, "jax", str(tmp_path))
    assert (reread.thresholds.prob, reread.thresholds.nms) == (got["prob"], got["nms"])
