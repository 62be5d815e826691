"""stardist_torch's training targets against the JAX package's on the same
inputs: the star-distance march, the min-plus EDT, the fused targets of the
training step and the host path's batches (StarDistData2D), the public
star_dist and relabel_image_stardist.

Tolerances: star distances exactly equal; the EDT prob within 1e-6 (both
are the same float32 operations; they come out equal here); the host
path's scipy prob exactly equal (the same numpy code)."""
import numpy as np
import pytest
import torch

from stardist_torch.geometry import relabel_image_stardist, star_dist
from stardist_torch.models import Config2D, StarDist2D
from stardist_torch.models.model2d import StarDistData2D
from stardist_torch.ops import edt as tedt
from stardist_torch.ops import stardist2d as tsd
from stardist_tpu.geometry.geom2d import relabel_image_stardist as relabel_jax
from stardist_tpu.models import Config2D as Config2DJax, StarDist2D as StarDist2DJax
from stardist_tpu.models.model2d import StarDistData2D as StarDistData2DJax
from stardist_tpu.ops.edt import edt_prob_core as edt_prob_core_jax
from stardist_tpu.ops.stardist2d import star_dist2d_batch, star_dist2d_jax
from utils import circle_image, random_image, synthetic_nuclei_2d

torch.set_num_threads(2)
PROB_TOL = 1e-6


def _fields(n=3, shape=(96, 96), seed=0):
    out = [synthetic_nuclei_2d(shape, seed=seed + i) for i in range(n)]
    return [x for x, _ in out], [y.astype(np.int32) for _, y in out]


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
@pytest.mark.parametrize("n_rays", [8, 32])
def test_star_dist_equals_numpy_oracle_and_jax(n_rays, grid):
    np.random.seed(n_rays + grid[0])
    img = random_image((41, 45)).astype(np.int32)
    a = tsd.star_dist2d(torch.from_numpy(img), n_rays, grid).numpy()
    assert a.dtype == np.float32
    assert np.array_equal(a, tsd.star_dist2d_numpy(img, n_rays, grid))
    assert np.array_equal(a, star_dist2d_jax(img, n_rays, grid))
    # the march bounded by march_steps (no host sync) gives the same
    b = tsd.star_dist2d(torch.from_numpy(img), n_rays, grid, n_steps=tsd.march_steps(img))
    assert np.array_equal(a, b.numpy())


def test_star_dist_batch_equals_jax_with_the_bound_and_chunks(monkeypatch):
    _, lbls = _fields(n=3, shape=(64, 80), seed=4)
    y = np.stack(lbls)
    ref = star_dist2d_batch(y, 16, grid=(2, 2))
    t = torch.from_numpy(y)
    assert np.array_equal(tsd.star_dist2d(t, 16, (2, 2), n_steps=tsd.march_steps(y)).numpy(), ref)
    # several gathers per step range and over the start pixels
    monkeypatch.setattr(tsd, "_BUDGET", 3000)
    assert np.array_equal(tsd.star_dist2d(t, 16, (2, 2)).numpy(), ref)


@pytest.mark.parametrize("extent", [1, 2, 7, 30])
def test_march_steps_bounds_every_ray(extent):
    """Thin lines and squares (the longest rays for their box) end within
    the bound: the bounded march equals the unbounded one."""
    lbl = np.zeros((80, 80), np.int32)
    lbl[5, 5:5 + extent] = 1                              # a row
    lbl[10:10 + extent, 60] = 2                           # a column
    idx = np.arange(extent)
    lbl[40 + idx, 40 + idx] = 3                           # a diagonal
    lbl[45:45 + extent, 5:5 + extent][lbl[45:45 + extent, 5:5 + extent] == 0] = 4
    n = tsd.march_steps(lbl)
    a = tsd.star_dist2d(torch.from_numpy(lbl), 32, n_steps=n).numpy()
    assert np.array_equal(a, tsd.star_dist2d_numpy(lbl, 32))


@pytest.mark.parametrize("shape", [(64, 67), (33, 35)])
def test_edt_prob_core_equals_jax(shape):
    np.random.seed(shape[0])
    lbl = random_image(shape).astype(np.int32)
    labels = np.concatenate([np.unique(lbl[lbl > 0]), np.zeros(3)]).astype(np.int32)
    a = tedt.edt_prob_core(torch.from_numpy(lbl), torch.from_numpy(labels)).numpy()
    b = np.asarray(edt_prob_core_jax(lbl, labels, (1.0, 1.0)))
    assert np.abs(a - b).max() <= PROB_TOL


def test_edt_chunks_change_no_value(monkeypatch):
    _, lbls = _fields(n=2, shape=(48, 40), seed=2)
    y = torch.from_numpy(np.stack(lbls))
    labels = torch.from_numpy(np.stack([np.arange(1, 30), np.arange(1, 30)]).astype(np.int32))
    a = tedt.edt_prob_batch(y, labels)
    monkeypatch.setattr(tedt, "_BUDGET", 1)             # one label per chunk
    assert torch.equal(a, tedt.edt_prob_batch(y, labels))


def _models(grid, n_rays=16, patch=(64, 64), batch=3):
    kw = dict(n_rays=n_rays, grid=grid, unet_n_depth=1, unet_n_filter_base=8,
              net_conv_after_unet=8, train_patch_size=patch, train_batch_size=batch)
    jm = StarDist2DJax(Config2DJax(**kw), name="t", basedir=None)
    jm.prepare_for_training()
    tm = StarDist2D(Config2D(**kw), name="t", basedir=None, device="cpu")
    tm.prepare_for_training()
    return jm, tm


@pytest.mark.parametrize("grid,negative", [((1, 1), False), ((2, 2), False), ((2, 2), True)])
def test_fused_targets_equal_jax(grid, negative):
    imgs, lbls = _fields(seed=5)
    if negative:
        lbls[0][:40, :40] = -1                          # losses off there
    jm, tm = _models(grid)
    kw = dict(batch_size=3, n_rays=16, length=4, patch_size=(64, 64), grid=grid)
    jdata, tdata = StarDistData2DJax(imgs, lbls, **kw), StarDistData2D(imgs, lbls, **kw)
    jfn = jm._device_targets_fn()
    for i in range(2):
        np.random.seed(100 + i)
        jraw = jdata.raw_item(i)
        np.random.seed(100 + i)
        traw = tdata.raw_item(i)
        assert np.array_equal(jraw["x"], traw["x"]) and np.array_equal(jraw["y"], traw["y"])
        # the port sizes the label list from the real count, the JAX package to a power of 2
        n = max(1, max(len(np.unique(y[y > 0])) for y in traw["y"]))
        assert traw["labels"].shape == (3, n)
        assert np.array_equal(jraw["labels"][:, :n], traw["labels"])
        ref = {k: np.asarray(v) for k, v in jfn({k: np.asarray(v) for k, v in jraw.items()}).items()}
        out = {k: v.numpy() for k, v in tm._targets_fn(tm._put_batch(traw)).items()}
        assert np.array_equal(out["x"], ref["x"])
        assert np.array_equal(out["dist"][..., :-1], ref["dist"][..., :-1])
        assert np.abs(out["dist"][..., -1] - ref["dist"][..., -1]).max() <= PROB_TOL
        assert np.abs(out["prob"] - ref["prob"]).max() <= PROB_TOL
        assert (out["prob"] == -1).any() == negative


@pytest.mark.parametrize("shape_completion", [False, True])
def test_host_batches_equal_jax(shape_completion):
    """StarDistData2D[i] (the validation batch's path) under the same
    np.random seed."""
    imgs, lbls = _fields(seed=11)
    lbls[1][50:70, :30] = -1
    kw = dict(batch_size=2, n_rays=8, length=4, patch_size=(64, 64), grid=(2, 2),
              shape_completion=shape_completion, b=8, foreground_prob=0.9)
    jdata = StarDistData2DJax(imgs, lbls, **kw)
    tdata = StarDistData2D(imgs, lbls, **kw, device="cpu")
    for i in range(3):
        np.random.seed(7 + i)
        (xj,), (pj, dj) = jdata[i]
        np.random.seed(7 + i)
        (xt,), (pt, dt) = tdata[i]
        assert np.array_equal(xj, xt) and np.array_equal(pj, pt) and np.array_equal(dj, dt)


def test_star_dist_public_api():
    np.random.seed(3)
    img = random_image((33, 30))
    for mode in ("torch", "jax", "cpp"):
        d = star_dist(img, 8, grid=(2, 1), mode=mode, device="cpu")
        assert isinstance(d, np.ndarray) and d.dtype == np.float32 and d.shape == (17, 30, 8)
        assert np.array_equal(d, star_dist2d_jax(img.astype(np.int32), 8, (2, 1)))
    assert np.array_equal(star_dist(img, 8, mode="numpy"), tsd.star_dist2d_numpy(img, 8))
    t = star_dist(torch.from_numpy(img.astype(np.int32)), 8)     # a tensor: on its device
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), star_dist(img, 8, device="cpu"))
    with pytest.raises(ValueError):
        star_dist(img, 2, device="cpu")
    with pytest.raises(ValueError):
        star_dist(img, 8, mode="opengl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):                  # numpy goes to the card by default
            star_dist(img, 8)


@pytest.mark.parametrize("n_rays", [16, 32])
def test_relabel_image_stardist_equals_jax(n_rays):
    np.random.seed(n_rays)
    for lbl in (random_image((70, 64)), circle_image((64, 70))):
        a = relabel_image_stardist(lbl, n_rays, device="cpu")
        b = relabel_jax(lbl, n_rays)
        assert a.dtype == np.int32 and np.array_equal(a, b)
