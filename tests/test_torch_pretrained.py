"""The committed demo models through the port's registry, on the CPU
(tests/test_pretrained.py's cases on stardist_torch).

The goldens on the reference's bundled images (the DSB2018 nuclei and the
3D volume) skip while those images are absent, as the reference's do; the
rest runs on the committed models/examples and synthetic fields."""
from pathlib import Path

import numpy as np
import pytest
import torch

from stardist_torch.core.normalize import normalize
from stardist_torch.matching import matching
from stardist_torch.models import StarDist2D, StarDist3D, get_model_details, get_registered_models
# aliased so pytest does not collect the data loaders as test functions
from stardist_tpu.data import test_image_nuclei_2d as _image_nuclei_2d
from stardist_tpu.data import test_image_nuclei_3d as _image_nuclei_3d
from utils import synthetic_nuclei_2d

torch.set_num_threads(2)
EXAMPLES = Path(__file__).resolve().parents[1] / "models" / "examples"


@pytest.fixture(scope="module")
def model2d():
    return StarDist2D(None, name="2D_demo", basedir=str(EXAMPLES), device="cpu")


@pytest.fixture(scope="module")
def model3d():
    return StarDist3D(None, name="3D_demo", basedir=str(EXAMPLES), device="cpu")


def _real_2d():
    img, mask = _image_nuclei_2d(return_mask=True)
    if img.shape != (512, 512):
        pytest.skip("real bundled DSB image unavailable")
    return normalize(img.astype(np.float32), 1, 99.8), mask.astype(np.int32)


def _real_3d():
    img, mask = _image_nuclei_3d(return_mask=True)
    if img.shape != (31, 61, 57):
        pytest.skip("real bundled 3D volume unavailable")
    return normalize(img.astype(np.float32), 1, 99.8), mask.astype(np.int32)


def test_golden_2d(model2d):
    """The reference's goldens on the real DSB2018 image."""
    img, lbl = _real_2d()
    labels, _ = model2d.predict_instances(img)
    assert int(labels.max()) == 118
    assert abs(int(np.count_nonzero(labels)) - 41734) <= 50
    m = matching(lbl, labels, thresh=0.5)
    assert (m.tp, m.fp, m.fn) == (109, 9, 16)


def test_golden_3d(model3d):
    img, lbl = _real_3d()
    labels, _ = model3d.predict_instances(img)
    assert int(labels.max()) == 46
    assert abs(int(np.count_nonzero(labels)) - 31961) <= 80
    m = matching(lbl, labels, thresh=0.5)
    assert (m.tp, m.fp, m.fn) == (38, 8, 13)


def test_thresholds_optimized_2d(model2d):
    assert abs(model2d.thresholds.prob - 0.49198) < 2e-3
    assert model2d.thresholds.nms == 0.3


@pytest.mark.parametrize("cls, key, alias", [(StarDist2D, "2D_demo", "Demo 2D"),
                                             (StarDist3D, "3D_demo", "Demo 3D")])
def test_from_pretrained_registry(cls, key, alias):
    models, aliases = get_registered_models(cls)
    assert key in models and aliases[alias] == key
    assert get_model_details(cls, alias) == (key, models[key])
    m = cls.from_pretrained(alias, device="cpu")
    folder = cls(None, key, str(EXAMPLES), device="cpu")
    assert m.config.n_rays == folder.config.n_rays and m.thresholds == folder.thresholds
    for k, v in folder.net.state_dict().items():
        assert torch.equal(m.net.state_dict()[k], v), k
    with pytest.raises(ValueError):
        cls.from_pretrained("no such model", device="cpu")


def test_from_pretrained_defaults_to_the_card():
    """Without ``device`` the model goes to the card, and without a card that
    raises: it never moves to the CPU by itself."""
    if torch.cuda.is_available():
        assert StarDist2D.from_pretrained("2D_demo").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StarDist2D.from_pretrained("2D_demo")


def test_from_pretrained_predicts_as_the_folder(model2d):
    img = synthetic_nuclei_2d((128, 128), seed=3)[0]
    a, _ = StarDist2D.from_pretrained("2D_demo", device="cpu").predict_instances(img)
    b, _ = model2d.predict_instances(img)
    assert a.max() > 5 and np.array_equal(a, b)


def test_dense_sparse_same_on_pretrained(model2d):
    img, _ = _real_2d()
    a, _ = model2d.predict_instances(img, sparse=True)
    b, _ = model2d.predict_instances(img, sparse=False)
    assert np.array_equal(a, b)


def test_big_equals_monolithic_pretrained(model2d):
    img, _ = _real_2d()
    ref, _ = model2d.predict_instances(img)
    res, _ = model2d.predict_instances_big(img, axes="YX", block_size=288, min_overlap=64,
                                           context=64, show_progress=False)
    assert matching(ref, res, thresh=0.99).accuracy == 1.0
