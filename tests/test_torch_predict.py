"""stardist_torch StarDist2D.predict_instances against stardist_tpu on the
2D_demo model and a synthetic nuclei image."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_torch.matching import matching
from stardist_torch.models import StarDist2D
from stardist_torch.models.base import StarDistPadAndCropResizer
from tests.utils import synthetic_nuclei_2d

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    img, lbl = synthetic_nuclei_2d((256, 256), seed=0)
    jm = StarDist2DJax(None, "2D_demo", "models/examples")
    tm = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    return img, lbl, jm, tm


def test_nms_and_raster_on_reference_candidates_are_exact(setup):
    """The JAX model's own candidates through the port's NMS and raster:
    survivors and label image exactly equal to stardist_tpu's."""
    img, _, jm, tm = setup
    prob, dist, points = jm.predict_sparse(img)
    dist = np.asarray(dist)
    assert len(prob) > 1000                       # real NMS work
    lab_ref, res_ref = jm._instances_from_prediction(img.shape, prob, dist, points=points)
    lab, res = tm._instances_from_prediction(
        img.shape, torch.from_numpy(prob), torch.from_numpy(dist), torch.from_numpy(points))
    assert np.array_equal(res["points"], res_ref["points"])
    assert np.array_equal(res["prob"], res_ref["prob"])
    assert np.array_equal(res["coord"], res_ref["coord"])
    assert np.array_equal(lab, lab_ref)


def test_predict_instances_agrees_with_reference(setup):
    """The whole f32 path. Not exact: last-bit differences between XLA's and
    torch's f32 convs can reorder near-tied probs and change a survivor."""
    img, lbl, jm, tm = setup
    lab_ref, res_ref = jm.predict_instances(img)
    lab, res = tm.predict_instances(img)
    assert lab.dtype == np.int32 and lab.shape == img.shape
    assert abs(len(res["prob"]) - len(res_ref["prob"])) <= 1
    assert matching(lab_ref, lab, thresh=0.5).accuracy >= 0.98
    assert set(res["timings_s"]) == {"forward", "extract", "nms", "raster"}
    assert res["nms_counters"]["n_candidates"] > 1000
    # and it finds the synthetic nuclei
    assert matching(lbl, lab, thresh=0.5).accuracy > 0.8


def test_predict_sparse_candidates_match_reference(setup):
    img, _, jm, tm = setup
    prob_ref, _, points_ref = jm.predict_sparse(img)
    prob, dist, points = tm.predict_sparse(img)
    assert all(isinstance(a, np.ndarray) for a in (prob, dist, points))
    assert len(prob) == len(prob_ref)
    assert np.all(prob[:-1] >= prob[1:])                  # descending
    assert np.all(dist >= 1e-3)
    # the same candidate set (positions), in full-resolution pixels
    key = lambda p: np.sort(p[:, 0] * 100000 + p[:, 1])  # noqa: E731
    assert np.array_equal(key(points), key(points_ref))


def test_ragged_image_and_border(setup):
    _, _, _, tm = setup
    img, _ = synthetic_nuclei_2d((90, 110), seed=1)
    lab, res = tm.predict_instances(img, prob_thresh=0.3)
    assert lab.shape == (90, 110)
    pts = res["points"]
    assert len(pts) == 0 or (pts.min() >= 0 and (pts < [90, 110]).all())


def test_resizer_filter_points():
    r = StarDistPadAndCropResizer(grid={"Y": 2, "X": 2})
    x = np.zeros((30, 41, 1), np.float32)
    xp = r.before(x, "YXC", (8, 8, 1))
    assert xp.shape == (32, 48, 1)
    pts = np.array([[29, 40], [30, 40], [29, 41]])
    assert np.array_equal(r.filter_points(3, pts, "YXC")[0], [0])


def test_port_imports_no_jax():
    """Importing stardist_torch with its whole flat namespace and the
    interop modules (the CLI, profiling, bioimage.io, the TF export) and
    predicting (predict_instances, tiled and untiled,
    predict_instances_device, the CLI's run) leave jax, flax and
    stardist_tpu out of sys.modules."""
    code = textwrap.dedent("""
        import functools
        import sys
        import tempfile
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from stardist_torch import *  # noqa: F401,F403
        from stardist_torch import StarDist2D
        from stardist_torch.core import profiling  # noqa: F401
        from stardist_torch.models import export_tf  # noqa: F401
        from stardist_torch import bioimageio_utils  # noqa: F401
        from stardist_torch.scripts import predict2d, predict3d  # noqa: F401
        m = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
        img = np.random.RandomState(0).rand(64, 64).astype(np.float32)
        m.predict_instances(img)
        m.predict_instances(img, n_tiles=(2, 2))
        m.predict_instances_device(img)
        d = tempfile.mkdtemp()
        predict2d._imwrite(d + "/in.tif", (img * 1000).astype(np.uint16))
        args = predict2d.make_parser(2).parse_args(
            ["-i", d + "/in.tif", "-o", d, "-m", "2D_demo", "--modeldir", "models/examples"])
        predict2d.run(args, functools.partial(StarDist2D, device="cpu"), 2)
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "flax", "stardist_tpu")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")

