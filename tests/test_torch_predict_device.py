"""stardist_torch StarDist2D.predict_instances_device against the port's own
predict_instances and against stardist_tpu's device path; the port's 2D NMS
keep flags against stardist_tpu's two-layout NMS (``_nms2d_v2``)."""
import shutil

import numpy as np
import pytest
import torch

from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.ops.nms2d_fast import nms2d_twolayout_host
from stardist_torch.matching import matching
from stardist_torch.models import StarDist2D
from stardist_torch.nms import descending_order
from stardist_torch.ops.nms import nms_polygons
from tests.utils import synthetic_nuclei_2d

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tm():
    return StarDist2D(None, "2D_demo", "models/examples", device="cpu")


@pytest.fixture(scope="module")
def jm(tmp_path_factory):
    # a copy of the model folder: the reference's device path saves its
    # buffer capacities (device_caps.json) next to the weights
    tmp = tmp_path_factory.mktemp("models")
    shutil.copytree("models/examples/2D_demo", tmp / "2D_demo")
    return StarDist2DJax(None, "2D_demo", str(tmp))


def _crop(shape, seed):
    img, _ = synthetic_nuclei_2d((160, 160), seed=seed)
    return img[:shape[0], :shape[1]]


@pytest.mark.parametrize("shape,seed", [((96, 96), 9), ((97, 101), 3)])
def test_device_path_equals_predict_instances(tm, shape, seed):
    """The same survivors and label image as predict_instances, exactly
    (tests/test_predict_paths.py's contract for the reference)."""
    img = _crop(shape, seed)
    ref_labels, ref = tm.predict_instances(img, prob_thresh=0.6)
    labels, det = tm.predict_instances_device(img, prob_thresh=0.6)
    assert labels.dtype == np.int32 and labels.shape == shape
    assert len(det["prob"]) == len(ref["prob"]) > 3
    np.testing.assert_array_equal(det["prob"], ref["prob"])
    np.testing.assert_array_equal(det["points"], ref["points"])
    assert det["points"].dtype == np.int32
    np.testing.assert_array_equal(det["coord"], ref["coord"])
    np.testing.assert_array_equal(labels, ref_labels)
    assert det["dist"].shape == (len(det["prob"]), 32)
    assert set(det["timings_s"]) == {"forward", "extract", "nms", "raster"}
    assert det["nms_counters"]["n_survivors"] == len(det["prob"])


def test_fetch_false_keeps_tensors_on_the_model_device(tm):
    img = _crop((96, 96), 9)
    labels_np, det_np = tm.predict_instances_device(img, prob_thresh=0.6)
    labels, det = tm.predict_instances_device(img, prob_thresh=0.6, fetch=False)
    assert isinstance(labels, torch.Tensor) and labels.device == tm.device
    assert labels.dtype == torch.uint16          # the label count fits 16 bits
    for k in ("dist", "points", "prob"):
        assert isinstance(det[k], torch.Tensor) and det[k].device == tm.device
    assert "coord" not in det
    np.testing.assert_array_equal(labels.numpy().astype(np.int32), labels_np)
    np.testing.assert_array_equal(det["prob"].numpy(), det_np["prob"])


def test_prestaged_tensor_equals_numpy_input(tm):
    img = _crop((96, 96), 9)
    ref_labels, ref = tm.predict_instances_device(img, prob_thresh=0.6)
    for x in (torch.from_numpy(img), torch.from_numpy(img[..., None])):
        labels, det = tm.predict_instances_device(x, prob_thresh=0.6)
        np.testing.assert_array_equal(labels, ref_labels)
        np.testing.assert_array_equal(det["points"], ref["points"])


@pytest.mark.parametrize("bad", ["normalizer", "axes", "shape", "channels", "device",
                                 "tiles"])
def test_prestaged_tensor_input_is_checked(tm, bad):
    from stardist_torch.core.normalize import PercentileNormalizer
    x = torch.zeros(96, 96)
    kw = {}
    if bad == "tiles":                 # a pre-staged tensor is one tile
        with pytest.raises(ValueError):
            tm.predict_sparse(x, n_tiles=(2, 2))
        return
    if bad == "normalizer":
        kw["normalizer"] = PercentileNormalizer()
    elif bad == "axes":
        kw["axes"] = "XY"
    elif bad == "shape":
        x = torch.zeros(97, 96)
    elif bad == "channels":
        x = torch.zeros(96, 96, 2)
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        tm.predict_instances_device(x, **kw)


def test_device_path_agrees_with_reference_device_path(tm, jm):
    """Against stardist_tpu's predict_instances_device (f32 on the CPU):
    last-bit differences between XLA's and torch's f32 convs can reorder
    near-tied probs and change a survivor."""
    img, lbl = synthetic_nuclei_2d((256, 256), seed=0)
    lab_ref, det_ref = jm.predict_instances_device(img)
    lab, det = tm.predict_instances_device(img)
    assert abs(len(det["prob"]) - len(det_ref["prob"])) <= 1
    assert matching(lab_ref, lab, thresh=0.5).accuracy >= 0.98
    assert matching(lbl, lab, thresh=0.5).accuracy > 0.8


@pytest.fixture(scope="module")
def reference_candidates(jm):
    img, _ = synthetic_nuclei_2d((256, 256), seed=0)
    prob, dist, points = jm.predict_sparse(img)
    order = descending_order(torch.from_numpy(np.asarray(prob))).numpy()
    return (np.asarray(dist)[order].astype(np.float32),
            np.asarray(points)[order].astype(np.float32))


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_keep_flags_equal_two_layout_nms(reference_candidates, thresh):
    """The device path's NMS (ops/nms.py::nms_polygons) keeps exactly the
    candidates that the reference's device path keeps (_nms2d_v2, called
    through nms2d_twolayout_host, jnp stages) on the 2D_demo model's own
    candidates."""
    dist, points = reference_candidates
    assert len(dist) > 1000
    ref = nms2d_twolayout_host(dist, points, thresh, S=16)
    assert ref is not None
    keep = nms_polygons(torch.from_numpy(dist), torch.from_numpy(points), thresh=thresh)
    np.testing.assert_array_equal(keep.numpy(), ref)
