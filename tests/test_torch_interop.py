"""The port's interop helpers against stardist_tpu on the CPU: the path
helpers of utils, the bundled test images (procedural and read from a
folder of tiffs), the plotting helpers, profiling, and
predict_sparse(device_dist=True)."""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import stardist_tpu.data as jdata
import stardist_tpu.plot as jplot
import stardist_tpu.utils as jutils
import stardist_torch.data as tdata
import stardist_torch.plot as tplot
import stardist_torch.utils as tutils
from stardist_torch.core.profiling import Timer, device_sync, trace
from stardist_torch.models import StarDist2D
from tests.utils import synthetic_nuclei_2d

torch.set_num_threads(2)

IMAGES = ("test_image_nuclei_2d", "test_image_he_2d", "test_image_nuclei_3d")


def test_utils_path_helpers_follow_the_reference(tmp_path):
    """abspath as the reference's; path_absolute under the port's own
    package; gputools_available False, as in the reference."""
    (tmp_path / "f.txt").write_text("x")
    for root in (tmp_path, tmp_path / "f.txt"):
        assert tutils.abspath(root, "a/b.json") == jutils.abspath(root, "a/b.json")
    assert tutils.abspath(tmp_path, "a") == str(tmp_path / "a")
    here = tutils.path_absolute("models")
    assert here == os.path.join(os.path.dirname(os.path.abspath(tutils.__file__)), "models")
    assert os.path.isdir(here)
    assert os.path.relpath(here, os.path.dirname(tutils.__file__)) == os.path.relpath(
        jutils.path_absolute("models"), os.path.dirname(jutils.__file__))
    assert tutils.gputools_available() is jutils.gputools_available() is False


@pytest.mark.parametrize("name", IMAGES)
def test_procedural_images_equal_the_reference(name, monkeypatch):
    """Without assets, each image (and its mask) is the JAX package's, bit
    for bit: the same seeded draws and filters in the same order."""
    monkeypatch.delenv("STARDIST_TORCH_DATA_DIR", raising=False)
    kw = {} if name == "test_image_he_2d" else dict(return_mask=True)
    got, want = getattr(tdata, name)(**kw), getattr(jdata, name)(**kw)
    got, want = (got, want) if kw else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert got[-1].max() > 5


def test_images_read_from_each_packages_own_folder(tmp_path, monkeypatch):
    """A folder of tiffs and a jpg, named by each package's own environment
    variable: both packages read the same arrays, and not the procedural
    ones."""
    import imageio
    import imageio.v2 as iio
    rng = np.random.RandomState(7)
    img2 = rng.randint(0, 4000, (40, 52)).astype(np.uint16)
    mask2 = rng.randint(0, 9, (40, 52)).astype(np.uint16)
    img3 = rng.randint(0, 4000, (6, 20, 24)).astype(np.uint16)
    mask3 = rng.randint(0, 9, (6, 20, 24)).astype(np.uint16)
    histo = rng.randint(0, 255, (24, 32, 3)).astype(np.uint8)
    iio.imwrite(tmp_path / "img2d.tif", img2)
    iio.imwrite(tmp_path / "mask2d.tif", mask2)
    imageio.volwrite(tmp_path / "img3d.tif", img3)
    imageio.volwrite(tmp_path / "mask3d.tif", mask3)
    iio.imwrite(tmp_path / "histo.jpg", histo)
    monkeypatch.setenv("STARDIST_TORCH_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("STARDIST_TPU_DATA_DIR", str(tmp_path))
    ref = importlib.reload(jdata)           # the reference reads its variable at import
    try:
        for name in IMAGES:
            kw = {} if name == "test_image_he_2d" else dict(return_mask=True)
            got, want = getattr(tdata, name)(**kw), getattr(ref, name)(**kw)
            got, want = (got, want) if kw else ((got,), (want,))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(tdata.test_image_nuclei_2d(), img2)
        assert np.array_equal(tdata.test_image_nuclei_3d(return_mask=True)[1], mask3)
        assert tdata.test_image_he_2d().shape == histo.shape
    finally:
        monkeypatch.undo()
        importlib.reload(jdata)


@pytest.fixture(scope="module")
def labels():
    img, lbl = synthetic_nuclei_2d((64, 72), n=10, seed=5)
    return img, lbl.astype(np.int32)


@pytest.mark.parametrize("case", ["render_label", "render_label_img", "render_label_tuple",
                                  "render_label_pred", "render_label_pred_img"])
def test_render_equals_the_reference(labels, case):
    """render_label (its random colormap drawn from the same seed) and
    render_label_pred exactly the JAX package's."""
    img, lbl = labels
    pred = np.roll(lbl, 3, axis=1)
    out = []
    for pkg in (tplot, jplot):
        np.random.seed(11)
        if case == "render_label":
            out.append(pkg.render_label(lbl))
        elif case == "render_label_img":
            out.append(pkg.render_label(lbl, img=img, alpha=0.4, alpha_boundary=0.9))
        elif case == "render_label_tuple":
            out.append(pkg.render_label(lbl, img=img, cmap=(0.2, 0.3, 0.9)))
        elif case == "render_label_pred":
            out.append(pkg.render_label_pred(lbl, pred))
        else:
            out.append(pkg.render_label_pred(lbl, pred, img=img))
    assert out[0].shape == lbl.shape + (4,)
    assert out[0].dtype == out[1].dtype and np.array_equal(out[0], out[1])


def test_random_label_cmap_equals_the_reference():
    got, want = [], []
    for pkg, out in ((tplot, got), (jplot, want)):
        np.random.seed(3)
        cmap = pkg.random_label_cmap(64)
        out.append(cmap(range(64)))
        out.append(cmap.N)
    assert got[1] == want[1] == 64
    assert np.array_equal(got[0], want[0]) and np.all(got[0][0, :3] == 0)


def test_draw_polygons_runs_as_the_reference(labels):
    """draw_polygons draws one dashed line per polygon on the current axes,
    as the reference's."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    coord = np.random.RandomState(0).uniform(5, 50, (4, 2, 16))
    lines = []
    for pkg in (tplot, jplot):
        plt.figure()
        pkg.draw_polygons(coord, score=np.ones(4), show_dist=True)
        lines.append([ln.get_xydata().copy() for ln in plt.gca().get_lines()])
        plt.close()
    assert len(lines[0]) == len(lines[1]) == 4 * 16 + 4
    assert all(np.array_equal(a, b) for a, b in zip(*lines))


def test_timer_laps_and_device_sync():
    t = Timer()
    for _ in range(2):
        with t("forward") as box:
            box.append(torch.ones(3) * 2)
    with t("other", sync={"a": [torch.zeros(2)]}):
        pass
    assert set(t.laps) == {"forward", "other"} and len(t.laps["forward"]) == 2
    assert t.report()["forward"][0] == 2 and t.total("forward") == sum(t.laps["forward"]) > 0
    assert t.total("missing") == 0
    tree = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": np.ones(2), "c": None}
    assert device_sync(tree) is tree


def test_trace_writes_a_chrome_trace_of_a_prediction(tmp_path, capsys):
    m = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    img = synthetic_nuclei_2d((64, 64), n=6, seed=1)[0]
    with trace(tmp_path / "tr", create_perfetto_link=True):
        m.predict_instances(img)
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1 and str(files[0]) in capsys.readouterr().out
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names), sorted(names)[:20]


@pytest.fixture(scope="module")
def demo():
    from stardist_tpu.models import StarDist2D as StarDist2DJax
    # 120 x 136: not a multiple of the net's 16, so one tile is padded
    img = synthetic_nuclei_2d((120, 136), n=14, seed=8)[0]
    return img, StarDist2D(None, "2D_demo", "models/examples", device="cpu"), \
        StarDist2DJax(None, "2D_demo", "models/examples")


def test_predict_sparse_device_dist_rows(demo):
    """device_dist=True in one tile: dist a tensor on the model's device
    (here the CPU) whose rows, with prob and points, are exactly
    device_dist=False's; tiled, all numpy and equal to the tiled call."""
    img, tm, _ = demo
    prob, dist, points = tm.predict_sparse(img, device_dist=True)
    prob0, dist0, points0 = tm.predict_sparse(img)
    assert isinstance(dist, torch.Tensor) and dist.device == tm.device
    assert isinstance(prob, np.ndarray) and isinstance(points, np.ndarray)
    assert len(prob) > 50
    assert np.array_equal(dist.numpy(), dist0) and np.array_equal(prob, prob0)
    assert np.array_equal(points, points0)
    tiled = tm.predict_sparse(img, n_tiles=(2, 2), device_dist=True)
    assert all(isinstance(a, np.ndarray) for a in tiled)
    for a, b in zip(tiled, tm.predict_sparse(img, n_tiles=(2, 2))):
        assert np.array_equal(a, b)


def test_predict_sparse_device_dist_matches_reference(demo):
    """Against stardist_tpu's predict_sparse(device_dist=True): the same
    candidate set as test_torch_predict.py requires, and the rows of dist
    within the f32 tolerance of test_torch_api.py (XLA's and torch's f32
    convs differ in their last bits)."""
    img, tm, jm = demo
    prob, dist, points = tm.predict_sparse(img, device_dist=True)
    prob_r, dist_r, points_r = (np.asarray(a) for a in jm.predict_sparse(img, device_dist=True))
    assert len(prob) == len(prob_r) and np.all(prob[:-1] >= prob[1:])
    key = lambda p: p[:, 0] * 100000 + p[:, 1]  # noqa: E731
    o, o_r = np.argsort(key(points)), np.argsort(key(points_r))
    assert np.array_equal(points[o], points_r[o_r])
    np.testing.assert_allclose(prob[o], prob_r[o_r], rtol=0, atol=1e-5)
    np.testing.assert_allclose(dist.numpy()[o], dist_r[o_r], rtol=1e-4, atol=1e-4)
