"""The port's public functions take the reference's parameters: the same
names, order and defaults of the positional parameters, the port's own
ones keyword-only. A reference parameter that is not ported yet raises when
it is set; one that only affects speed or printing is taken and changes
nothing. ``predict_sparse`` returns numpy, as the reference does. A float32
net sends its convs to the plain versions, by its type."""
import inspect

import numpy as np
import pytest
import torch

import stardist_tpu.geometry as jgeom
import stardist_tpu.nms as jnms
import stardist_tpu.utils as jutils
from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_torch import geometry as tgeom
from stardist_torch import nms as tnms
from stardist_torch import utils as tutils
from stardist_torch.models import StarDist2D, StarDist3D
from tests.utils import synthetic_nuclei_2d

torch.set_num_threads(2)

# the port's own parameters; each is keyword-only
PORT_ONLY = {"b", "stats", "device", "out_dtype", "timings", "fetch"}

PAIRS = {
    "StarDist2D.predict_instances": (StarDist2D.predict_instances, StarDist2DJax.predict_instances),
    "StarDist3D.predict_instances": (StarDist3D.predict_instances, StarDist3DJax.predict_instances),
    "StarDist2D.predict_sparse": (StarDist2D.predict_sparse, StarDist2DJax.predict_sparse),
    "StarDist3D.predict_sparse": (StarDist3D.predict_sparse, StarDist3DJax.predict_sparse),
    "StarDist2D.predict": (StarDist2D.predict, StarDist2DJax.predict),
    "StarDist3D.predict": (StarDist3D.predict, StarDist3DJax.predict),
    "StarDist2D.predict_instances_device": (StarDist2D.predict_instances_device,
                                            StarDist2DJax.predict_instances_device),
    "polygons_to_label": (tgeom.polygons_to_label, jgeom.polygons_to_label),
    "polyhedron_to_label": (tgeom.polyhedron_to_label, jgeom.polyhedron_to_label),
    "dist_to_coord": (tgeom.dist_to_coord, jgeom.dist_to_coord),
    "non_maximum_suppression_sparse": (tnms.non_maximum_suppression_sparse,
                                       jnms.non_maximum_suppression_sparse),
    "non_maximum_suppression_inds": (tnms.non_maximum_suppression_inds,
                                     jnms.non_maximum_suppression_inds),
    "non_maximum_suppression_3d_sparse": (tnms.non_maximum_suppression_3d_sparse,
                                          jnms.non_maximum_suppression_3d_sparse),
    "non_maximum_suppression_3d_inds": (tnms.non_maximum_suppression_3d_inds,
                                        jnms.non_maximum_suppression_3d_inds),
    "non_maximum_suppression": (tnms.non_maximum_suppression, jnms.non_maximum_suppression),
    "polygons_to_label_coord": (tgeom.polygons_to_label_coord, jgeom.polygons_to_label_coord),
    "StarDist2D.optimize_thresholds": (StarDist2D.optimize_thresholds,
                                       StarDist2DJax.optimize_thresholds),
    "optimize_threshold": (tutils.optimize_threshold, jutils.optimize_threshold),
}


def _positional(fn):
    """(name, default) of the parameters that a positional call can reach
    (the reference's ``predict*`` read through ``functools.wraps`` to their
    generators; ``**kwargs`` that only the generator takes drop out)."""
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_matches_reference(name):
    port, ref = PAIRS[name]
    got, want = _positional(port), _positional(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, d), (_, d_ref) in zip(got, want):
        assert d == d_ref or d is d_ref, f"{name}: default of {n}: {d!r} != {d_ref!r}"
    params = inspect.signature(port).parameters.values()
    assert not any(p.kind == p.VAR_POSITIONAL for p in params)
    extra = {p.name for p in params if p.kind == p.KEYWORD_ONLY}
    assert extra <= PORT_ONLY, extra


@pytest.fixture(scope="module")
def tm():
    return StarDist2D(None, "2D_demo", "models/examples", device="cpu")


@pytest.fixture(scope="module")
def img():
    return synthetic_nuclei_2d((96, 96), n=12, seed=4)[0]


def test_positional_call_reads_like_the_reference(tm, img):
    """``predict_instances(img, None, None, True)`` asks the reference for
    sparse prediction; the port gives what the keyword call gives (it once
    read the fourth argument as ``prob_thresh``)."""
    lab, det = tm.predict_instances(img)
    assert lab.max() > 3
    lab_pos, det_pos = tm.predict_instances(img, None, None, True)
    np.testing.assert_array_equal(lab_pos, lab)
    np.testing.assert_array_equal(det_pos["points"], det["points"])
    # prob_thresh, nms_thresh by position (5th and 6th, as in the reference)
    lab_t, _ = tm.predict_instances(img, None, None, True, 0.7, 0.3)
    lab_k, _ = tm.predict_instances(img, prob_thresh=0.7, nms_thresh=0.3)
    np.testing.assert_array_equal(lab_t, lab_k)


def _polygons(n=60, R=32, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.uniform(3, 9, (n, R)).astype(np.float32)
    p = rng.uniform(8, 56, (n, 2)).astype(np.float32)
    prob = rng.uniform(0.5, 1, n).astype(np.float32)
    return d, p, prob


def test_speed_and_printing_parameters_change_nothing():
    """use_bbox, use_kdtree and verbose, given by position where the
    reference has them, are taken and change nothing."""
    d, p, prob = _polygons()
    order = np.argsort(prob, kind="stable")[::-1]
    ref = tnms.non_maximum_suppression_inds(d[order], p[order], prob[order], 0.3, device="cpu")
    got = tnms.non_maximum_suppression_inds(d[order], p[order], prob[order], 0.3, False, False,
                                            0, device="cpu")
    np.testing.assert_array_equal(got, ref)
    ref = tnms.non_maximum_suppression_sparse(d, prob, p, 2, 0.3, device="cpu")
    got = tnms.non_maximum_suppression_sparse(d, prob, p, 2, 0.3, False, False, False,
                                              device="cpu")
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a, r)
    lab = tgeom.polygons_to_label(d, p, (64, 64), prob, -np.inf, (1, 1), device="cpu")
    np.testing.assert_array_equal(lab, tgeom.polygons_to_label(d, p, (64, 64), prob=prob,
                                                               device="cpu"))


UNPORTED = {
    "predict_instances(overlap_label)": ("predict_instances", dict(overlap_label=-1)),
    "predict_sparse(device_dist)": ("predict_sparse", dict(device_dist=True)),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_parameter_raises(tm, img, case):
    fn, kw = UNPORTED[case]
    call = {
        "predict_instances": lambda: tm.predict_instances(img, **kw),
        "predict_sparse": lambda: tm.predict_sparse(img, **kw),
    }[fn]
    with pytest.raises(NotImplementedError):
        call()


@pytest.fixture(scope="module")
def jm():
    return StarDist2DJax(None, "2D_demo", "models/examples")


PORTED = {
    "predict_instances(sparse=False)": ("predict_instances", dict(sparse=False)),
    "predict_instances(scale)": ("predict_instances", dict(scale=2)),
    "predict_instances(predict_kwargs)": ("predict_instances",
                                          dict(predict_kwargs={"max_candidates": 10})),
    "predict_instances(nms_kwargs)": ("predict_instances", dict(nms_kwargs={"use_bbox": False})),
    "predict_instances(return_predict)": ("predict_instances", dict(return_predict=True)),
    "predict_sparse(max_candidates)": ("predict_sparse", dict(max_candidates=10)),
    "polygons_to_label(thr)": ("polygons_to_label", dict(thr=0.6)),
    "polygons_to_label(scale_dist)": ("polygons_to_label", dict(scale_dist=(2, 1))),
    "dist_to_coord(scale_dist)": ("dist_to_coord", dict(scale_dist=(1, 0.5))),
}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_parameter_matches_reference(tm, jm, img, case):
    """The parameters that raised before they were ported, each against
    stardist_tpu's same call: the geometry exactly; the pipeline's labels
    within the tolerance of test_torch_predict.py (survivors within one,
    matching accuracy >= 0.98: the f32 convs differ in their last bits);
    max_candidates with the reference's warning and the same top-K."""
    import warnings
    from stardist_torch.matching import matching
    fn, kw = PORTED[case]
    d, p, prob = _polygons()
    if fn == "dist_to_coord":
        got, want = tgeom.dist_to_coord(d, p, **kw), jgeom.dist_to_coord(d, p, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert not np.array_equal(got, tgeom.dist_to_coord(d, p))
        return
    if fn == "polygons_to_label":
        got = tgeom.polygons_to_label(d, p, (64, 64), prob=prob, device="cpu", **kw)
        want = jgeom.polygons_to_label(d, p, (64, 64), prob=prob, **kw)
        assert np.array_equal(got, want) and got.max() > 10
        assert not np.array_equal(got, tgeom.polygons_to_label(d, p, (64, 64), prob=prob,
                                                                device="cpu"))
        return
    with warnings.catch_warnings():
        warnings.simplefilter("error" if "max_candidates" not in str(kw) else "ignore")
        warnings.filterwarnings("ignore", "Setting sparse to False")
        if fn == "predict_sparse":
            with pytest.warns(UserWarning, match="exceeds max_candidates"):
                got = tm.predict_sparse(img, **kw)
            with pytest.warns(UserWarning, match="exceeds max_candidates"):
                want = [np.asarray(a) for a in jm.predict_sparse(img, **kw)]
            assert len(got[0]) == len(want[0]) == 10
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
            return
        got, want = tm.predict_instances(img, **kw), jm.predict_instances(img, **kw)
    if kw.get("return_predict"):
        (got, (prob_d, dist_d)), (want, dense_ref) = got, want
        assert len(dense_ref) == 2
        for a, r in zip((prob_d, dist_d), dense_ref):
            r = np.asarray(r)
            assert isinstance(a, np.ndarray) and a.shape == r.shape and a.dtype == r.dtype
            np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-4)
    (lab, det), (lab_ref, det_ref) = got, want
    assert lab.shape == lab_ref.shape == img.shape and lab.dtype == np.int32
    assert abs(len(det["prob"]) - len(det_ref["prob"])) <= 1
    assert matching(lab_ref, lab, thresh=0.5).accuracy >= 0.98
    if "predict_kwargs" in kw:
        assert len(det["prob"]) <= 10
    else:
        assert lab.max() > 3


def test_predict_sparse_returns_numpy_like_the_reference(tm):
    """On 2D_demo, the reference's (prob, dist, points): numpy, the same
    types, shapes and candidates, in the same order; the values agree to
    the last bits of the f32 convs (XLA's and torch's sums differ in
    order)."""
    jm = StarDist2DJax(None, "2D_demo", "models/examples")
    img, _ = synthetic_nuclei_2d((128, 128), n=20, seed=2)
    got = tm.predict_sparse(img)
    ref = [np.asarray(a) for a in jm.predict_sparse(img)]
    for a, r in zip(got, ref):
        assert isinstance(a, np.ndarray) and a.dtype == r.dtype and a.shape == r.shape
    prob, dist, points = got
    assert len(prob) > 100
    np.testing.assert_array_equal(points, ref[2])
    np.testing.assert_allclose(prob, ref[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(dist, ref[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cls,shape", [(StarDist2D, (32, 32, 1)), (StarDist3D, (8, 16, 16, 1))])
def test_conv_route_follows_the_net_dtype(cls, shape, monkeypatch):
    """A float32 net calls every conv's plain version, never the kernel
    wrapper; a bfloat16 net calls the wrapper (which launches the kernel
    on a CUDA tensor and runs the plain version on a CPU one)."""
    name = "2D_demo" if cls is StarDist2D else "3D_demo"
    m = cls(None, name, "models/examples", device="cpu")
    assert m.inference_dtype is None and m.net.dtype == torch.float32
    calls = {"kernel": 0, "plain": 0}
    for blk in m.net.conv_blocks():
        for route in calls:
            fn = getattr(blk, route)

            def spy(*a, route=route, fn=fn):
                calls[route] += 1
                return fn(*a)
            monkeypatch.setattr(blk, route, spy)
    x = torch.rand(*shape, generator=torch.Generator().manual_seed(0))
    n = len(m.net.conv_blocks())
    prob32, _ = m.net(x)
    assert calls == {"kernel": 0, "plain": n}
    m.set_inference_precision("bfloat16")
    assert m.inference_dtype == "bfloat16" and m.net.dtype == torch.bfloat16
    prob16, _ = m.net(x)
    assert calls == {"kernel": n, "plain": n}
    assert (prob16 - prob32).abs().max() < 5e-2
    m.set_inference_precision("float32")
    assert m.inference_dtype is None and m.net.dtype == torch.float32
    m.net(x)
    assert calls == {"kernel": n, "plain": 2 * n}
    with pytest.raises(ValueError):
        m.set_inference_precision("float16")
