"""stardist_torch's tiled 3D prediction (``n_tiles``) against stardist_tpu's
tile overlap and against the port's own untiled path."""
import pytest
import torch

from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_torch.matching import matching
from stardist_torch.models import StarDist3D
from tests.utils import synthetic_nuclei_3d

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models3d():
    return (StarDist3D(None, "3D_demo", "models/examples", device="cpu"),
            StarDist3DJax(None, "3D_demo", "models/examples"))


def test_axes_tile_overlap_equals_reference(models3d):
    tm, jm = models3d
    axes = tm.config.axes
    assert tm._axes_tile_overlap(axes) == tuple(int(v) for v in jm._axes_tile_overlap(axes))
    assert min(tm._axes_tile_overlap(axes)[:3]) > 0


def test_tiled_predict_instances_3d(models3d):
    tm, _ = models3d
    vol, lbl = synthetic_nuclei_3d((32, 64, 64), seed=0)
    lab1, _ = tm.predict_instances(vol)
    lab, res = tm.predict_instances(vol, n_tiles=(1, 2, 2))
    assert lab.shape == vol.shape and lab.max() > 5
    assert matching(lab1, lab, thresh=0.5).accuracy >= 0.99
