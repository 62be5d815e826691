"""The reference's NMS options through stardist_torch's models, against
stardist_tpu: ``predict_instances(nms_kwargs={"samples": S})`` of 2D_demo
and 3D_demo on the reference's forward (``reference_forward``) gives
exactly the reference's survivors and labels, and ``samples`` reaches the
NMS from every entry that takes NMS options (``predict_instances_big``,
the sharded and multi-process block-wise calls, the CLI's in-process
run). The NMS functions themselves: tests/test_torch_nms_samples.py."""
import functools

import numpy as np
import pytest
import torch

from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_torch import nms as tnms
from stardist_torch.models import StarDist2D, StarDist3D
from stardist_torch.parallel import predict_instances_big_multihost, predict_instances_big_sharded
from stardist_torch.scripts import predict2d
from tests.test_torch_multiclass import reference_forward
from tests.utils import synthetic_nuclei_2d, synthetic_nuclei_3d

torch.set_num_threads(2)

SCHEDULING = dict(dense_max=8, row_block=3, col_block=5, device_nms=True, dist_max=3.0)


@pytest.fixture(scope="module")
def demo2d():
    img = synthetic_nuclei_2d((160, 160), n=24, seed=4)[0]
    return (img, StarDist2DJax(None, "2D_demo", "models/examples"),
            StarDist2D(None, "2D_demo", "models/examples", device="cpu"))


@pytest.fixture(scope="module")
def demo3d():
    img = synthetic_nuclei_3d((16, 40, 40), n=8, seed=0)[0]
    return (img, StarDist3DJax(None, "3D_demo", "models/examples"),
            StarDist3D(None, "3D_demo", "models/examples", device="cpu"))


def _same(got, ref):
    (lt, dt), (lj, dj) = got, ref
    assert np.array_equal(lt, lj) and lt.max() > 3
    for k in ("points", "prob", "coord" if "coord" in dj else "dist"):
        assert np.array_equal(dt[k], np.asarray(dj[k])), k


@pytest.mark.parametrize("S", [10, 12])
def test_predict_instances_2d_at_samples_equals_reference(demo2d, S):
    """2D_demo on the reference's forward: survivors and labels with
    nms_kwargs={"samples": S} exactly the reference's."""
    img, jm, tm = demo2d
    kw = dict(nms_kwargs={"samples": S}, prob_thresh=0.3)
    ref = jm.predict_instances(img, **kw)
    with reference_forward(tm, jm):
        got = tm.predict_instances(img, **kw)
    _same(got, ref)
    assert got[1]["nms_counters"]["n_fine_pairs"] > 0


@pytest.mark.parametrize("S", [6, 10])
def test_predict_instances_3d_at_samples_equals_reference(demo3d, S):
    """3D_demo on the reference's forward: survivors and labels with
    nms_kwargs={"samples": S} exactly the reference's."""
    img, jm, tm = demo3d
    kw = dict(nms_kwargs={"samples": S}, nms_thresh=0.3)
    ref = jm.predict_instances(img, **kw)
    with reference_forward(tm, jm):
        got = tm.predict_instances(img, **kw)
    _same(got, ref)


@pytest.mark.parametrize("entry", ["predict_instances", "predict_instances_big", "sharded",
                                   "multihost", "cli"])
def test_samples_reach_the_nms_from_every_entry(entry, demo2d, monkeypatch, tmp_path):
    """nms_kwargs={"samples": 3} reaches the 2D NMS from predict_instances,
    predict_instances_big, the sharded and the multi-process block-wise
    calls (one process here) and the CLI's in-process run."""
    seen = []
    inner = tnms.nms_polygons

    def nms_polygons(*args, samples=16, **kw):
        seen.append(samples)
        return inner(*args, samples=samples, **kw)

    monkeypatch.setattr(tnms, "nms_polygons", nms_polygons)
    img, _, tm = demo2d
    big = dict(axes="YX", block_size=96, min_overlap=32, context=16, prob_thresh=0.3)
    if entry == "predict_instances":
        tm.predict_instances(img, prob_thresh=0.3, nms_kwargs={"samples": 3})
    elif entry == "predict_instances_big":
        tm.predict_instances_big(img, nms_kwargs={"samples": 3}, **big)
    elif entry == "sharded":
        predict_instances_big_sharded(tm, img, samples=3, **big)
    elif entry == "multihost":
        predict_instances_big_multihost(tm, img, nms_kwargs={"samples": 3}, **big)
    else:
        monkeypatch.setattr(predict2d, "_imread", lambda path, ndim=2: img)
        monkeypatch.setattr(predict2d, "_imwrite", lambda path, arr: None)
        args = predict2d.make_parser(2).parse_args(["-i", "x.tif", "-o", str(tmp_path), "-m",
                                                    "2D_demo", "--modeldir", "models/examples"])
        args.nms_kwargs = {"samples": 3}
        predict2d.run(args, functools.partial(StarDist2D, device="cpu"), 2)
    assert len(seen) > 0 and set(seen) == {3}


def test_scheduling_options_change_no_label(demo2d):
    """The reference's scheduling options in nms_kwargs leave the labels
    and survivors as they are; an unknown option raises TypeError."""
    img, _, tm = demo2d
    base = tm.predict_instances(img, prob_thresh=0.3)
    for kw in (SCHEDULING, dict(SCHEDULING, samples=16)):
        _same(tm.predict_instances(img, prob_thresh=0.3, nms_kwargs=kw), base)
    with pytest.raises(TypeError):
        tm.predict_instances(img, nms_kwargs={"sample": 12})
