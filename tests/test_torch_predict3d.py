"""stardist_torch StarDist3D.predict_instances against stardist_tpu on the
3D_demo model and a synthetic nuclei volume.

The 3D_demo model detects the synthetic nuclei (AP@0.1) but draws them too
large (AP@0.5 is 0 for the reference too), so the port is held against the
reference and against ground truth at IoU 0.1."""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_torch.matching import matching
from stardist_torch.models import StarDist3D
from stardist_torch.models.base import StarDistBase
from stardist_torch.nms import descending_order
from tests.utils import synthetic_nuclei_3d

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    img, lbl = synthetic_nuclei_3d((32, 48, 48), seed=0)
    jm = StarDist3DJax(None, "3D_demo", "models/examples")
    tm = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
    prob, dist, points = jm.predict_sparse(img)
    dist = np.asarray(dist)
    lab_ref, res_ref = jm._instances_from_prediction(img.shape, prob, dist, points=points)
    return img, lbl, jm, tm, (prob, dist, points), (lab_ref, res_ref)


@pytest.fixture(scope="module")
def predicted(setup):
    img, _, _, tm, _, _ = setup
    return tm.predict_instances(img)


def test_nms_and_raster_on_reference_candidates_are_exact(setup):
    """(i) The JAX model's own candidates through the port's NMS and raster:
    survivors and label volume exactly equal to stardist_tpu's."""
    img, _, _, tm, (prob, dist, points), (lab_ref, res_ref) = setup
    assert len(prob) > 1000                       # real NMS work
    lab, res = tm._instances_from_prediction(
        img.shape, torch.from_numpy(prob), torch.from_numpy(dist), torch.from_numpy(points))
    for k in ("points", "prob", "dist", "rays_vertices", "rays_faces"):
        assert np.array_equal(res[k], np.asarray(res_ref[k])), k
    assert lab.dtype == lab_ref.dtype == np.int32
    assert np.array_equal(lab, lab_ref)
    assert res["nms_counters"]["n_survivors"] == len(res_ref["prob"]) > 1


def test_predict_instances_agrees_with_reference(setup, predicted):
    """(ii) The whole f32 path. Not exact: last-bit differences between
    XLA's and torch's f32 convs can reorder near-tied probs and change a
    survivor."""
    img, _, _, _, _, (lab_ref, res_ref) = setup
    lab, res = predicted
    assert lab.dtype == np.int32 and lab.shape == img.shape
    assert abs(len(res["prob"]) - len(res_ref["prob"])) <= 1
    assert matching(lab_ref, lab, thresh=0.5).accuracy >= 0.9
    assert set(res["timings_s"]) == {"forward", "extract", "nms", "raster"}
    assert res["nms_counters"]["n_candidates"] > 1000
    assert set(res) >= {"dist", "points", "prob", "rays_vertices", "rays_faces",
                        "nms_counters", "timings_s"}


def test_predict_instances_detects_nuclei(setup, predicted):
    """(iii) AP@0.1 against the synthetic field's ground truth."""
    _, lbl, _, _, _, _ = setup
    lab, _ = predicted
    assert matching(lbl, lab, thresh=0.1).accuracy >= 0.8


def test_predict_sparse_candidates_match_reference(setup):
    img, _, _, tm, (prob_ref, _, points_ref), _ = setup
    prob, dist, points = tm.predict_sparse(img)
    assert all(isinstance(a, np.ndarray) for a in (prob, dist, points))
    assert len(prob) == len(prob_ref)
    assert np.all(prob[:-1] >= prob[1:]) and np.all(dist >= 1e-3)
    # the same candidate set (positions), in full-resolution voxels
    key = lambda p: np.sort((p[:, 0] * 1000 + p[:, 1]) * 1000 + p[:, 2])  # noqa: E731
    assert np.array_equal(key(points), key(points_ref))


def test_ragged_volume_and_border(setup):
    """(iv) A volume that is no multiple of the net's divisor (pads, then
    drops candidates in the padding) and the border exclusion b."""
    _, _, jm, tm, _, _ = setup
    img, _ = synthetic_nuclei_3d((21, 37, 45), n=6, seed=2)
    lab, res = tm.predict_instances(img)
    assert lab.shape == (21, 37, 45) and lab.max() == len(res["prob"])
    pts = res["points"]
    assert len(pts) == 0 or (pts.min() >= 0 and (pts < [21, 37, 45]).all())
    # the border key (padding + b) is the reference's
    from stardist_tpu.models.base import StarDistPadAndCropResizer as ResizerJax
    from stardist_torch.models.base import StarDistPadAndCropResizer
    for b in (2, 0, ((1, 3), (0, 2), (4, 1))):
        x, axes, r, n_tiles = tm._predict_setup(img, None, None, None)
        assert n_tiles == (1, 1, 1, 1)
        rj = ResizerJax(grid=dict(zip("ZYX", jm.config.grid)))
        xj = rj.before(img[..., None], "ZYXC", tm._axes_div_by("ZYXC"))
        assert np.array_equal(x, xj)
        assert tm._border_key(b, x, axes, r) == jm._device_border_key(b, xj, axes, rj)
        assert isinstance(r, StarDistPadAndCropResizer)
    # candidates of a border-excluded call stay inside the border
    _, _, p_b = tm.predict_sparse(img, b=((1, 3), (0, 2), (4, 1)), prob_thresh=0.1)
    g = np.array(tm.config.grid)
    p_out = p_b // g
    shape_out = np.array(x.shape[:3]) // g
    assert (p_out >= [1, 0, 4]).all() and (p_out < shape_out - [3, 2, 1]).all()


@pytest.mark.parametrize("nd", [2, 3])
def test_candidate_tie_order_matches_reference(nd):
    """The extracted list is in lax.top_k's order (descending prob, ties in
    ascending flat index), and the NMS order after the sparse API's sort is
    the reference's (ties in descending flat index)."""
    rng = np.random.RandomState(nd)
    shape = (6, 7, 5)[:nd]
    prob = rng.choice(np.float32([0.3, 0.6, 0.7, 0.9]), size=shape).astype(np.float32)
    dist = rng.rand(4, *shape).astype(np.float32)
    vals, d, pts = StarDistBase._extract(torch.from_numpy(prob), torch.from_numpy(dist), 0.5,
                                         ((1, 0),) + ((-1, -1),) * (nd - 1))
    mask = prob > 0.5
    mask[0] = False
    score = jnp.where(jnp.asarray(mask), jnp.asarray(prob), -1.0)
    ref_vals, ref_idx = jax.lax.top_k(score.ravel(), int(mask.sum()))
    ref_pts = np.stack(np.unravel_index(np.asarray(ref_idx), shape), 1)
    assert np.array_equal(vals.numpy(), np.asarray(ref_vals))
    assert np.array_equal(pts.numpy(), ref_pts)
    nms_order = pts[descending_order(vals)].numpy()
    ref_order = ref_pts[np.argsort(np.asarray(ref_vals), kind="stable")[::-1]]
    assert np.array_equal(nms_order, ref_order)


def test_port_imports_no_jax():
    """(v) Importing stardist_torch and predicting in 2D and 3D leave jax,
    flax and stardist_tpu out of sys.modules."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from stardist_torch import StarDist2D, StarDist3D
        m = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
        m.predict_instances(np.random.RandomState(0).rand(64, 64).astype(np.float32))
        m = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
        lab, _ = m.predict_instances(np.random.RandomState(0).rand(16, 32, 32).astype(np.float32))
        assert lab.shape == (16, 32, 32)
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "flax", "stardist_tpu")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
