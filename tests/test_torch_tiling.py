"""stardist_torch's tiled and dense prediction (``n_tiles``, ``predict``,
``core/tiling.py``) against stardist_tpu and against its own untiled path."""
import itertools

import numpy as np
import pytest
import torch

from stardist_tpu.core import tiling as jax_tiling
from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_torch.core import tiling
from stardist_torch.matching import matching
from stardist_torch.models import Config2D, StarDist2D
from stardist_torch.models.base import StarDistPadAndCropResizer
from tests.utils import synthetic_nuclei_2d

torch.set_num_threads(2)

SWEEP = [((64, 96, 1), (2, 3, 1), (8, 8, 1), (1, 2, 0)),
         ((64, 96, 1), (4, 1, 1), (16, 8, 1), (3, 0, 0)),
         ((40, 48, 3), (3, 5, 1), (4, 4, 1), (2, 1, 0)),
         ((32, 64, 64, 1), (1, 2, 2, 1), (2, 4, 4, 1), (6, 6, 6, 0)),
         ((24, 16), (7, 1), (4, 2), (0, 1))]


@pytest.mark.parametrize("equal_tiles", [True, False])
@pytest.mark.parametrize("shape,n_tiles,blocks,overlaps", SWEEP)
def test_tile_iterator_equals_reference(shape, n_tiles, blocks, overlaps, equal_tiles):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = list(tiling.tile_iterator(x, n_tiles, blocks, overlaps, equal_tiles=equal_tiles))
    ref = list(jax_tiling.tile_iterator(x, n_tiles, blocks, overlaps, equal_tiles=equal_tiles))
    assert len(got) == len(ref) == tiling.total_n_tiles(x, n_tiles, blocks, overlaps) \
        == jax_tiling.total_n_tiles(x, n_tiles, blocks, overlaps)
    for (t, s_src, s_dst), (tr, s_src_r, s_dst_r) in zip(got, ref):
        assert np.array_equal(t, tr) and s_src == s_src_r and s_dst == s_dst_r
    # the cores cover the array once
    cover = np.zeros(shape, int)
    for t, s_src, s_dst in got:
        cover[s_dst] += 1
        assert np.array_equal(x[s_dst], t[s_src])
    assert (cover == 1).all()


@pytest.fixture(scope="module")
def models2d():
    return (StarDist2D(None, "2D_demo", "models/examples", device="cpu"),
            StarDist2DJax(None, "2D_demo", "models/examples"))


def test_axes_tile_overlap_equals_reference(models2d):
    tm, jm = models2d
    assert tm._axes_tile_overlap("YXC") == tuple(int(v) for v in jm._axes_tile_overlap("YXC"))
    assert tm._axes_tile_overlap("YXC")[0] > 0


def test_receptive_field_of_zero_weights_falls_back_to_a_fresh_net():
    m = StarDist2D(Config2D(n_rays=8, grid=(2, 2), unet_n_depth=1, unet_n_filter_base=4,
                            net_conv_after_unet=8), basedir=None, device="cpu")
    with torch.no_grad():
        for p in m.net.parameters():
            p.zero_()
    rf = m._compute_receptive_field()
    assert len(rf) == 2 and all(lo > 0 and hi > 0 for lo, hi in rf)
    assert not any(b.weight.any() for b in m.net.conv_blocks())   # the model is untouched


def test_guess_n_tiles(models2d):
    tm, jm = models2d
    img = np.zeros((1000, 700), np.float32)
    assert tm._guess_n_tiles(img) == jm._guess_n_tiles(img)


def test_resizer_after_crops_the_padding():
    r = StarDistPadAndCropResizer(grid={"Y": 2, "X": 2})
    x = r.before(np.zeros((30, 41, 1), np.float32), "YXC", (8, 8, 1))
    assert x.shape == (32, 48, 1)
    assert r.after(np.zeros((16, 24, 5)), "YXC").shape == (15, 21, 5)


def test_tiled_predict_agrees_with_reference(models2d):
    tm, jm = models2d
    img, _ = synthetic_nuclei_2d((200, 232), seed=0)
    prob, dist = tm.predict(img, n_tiles=(2, 2))
    prob_ref, dist_ref = jm.predict(img, n_tiles=(2, 2))
    assert prob.shape == prob_ref.shape == (100, 116)
    assert dist.shape == dist_ref.shape == (100, 116, 32)
    # f32 convs summed in another order
    assert np.abs(prob - prob_ref).max() < 1e-4
    assert np.abs(dist - dist_ref).max() / np.abs(dist_ref).max() < 1e-3
    assert dist.min() >= 1e-3
    prob1, dist1 = tm.predict(img)
    assert np.abs(prob - prob1).max() < 1e-4


def test_tiled_predict_sparse_gives_the_reference_candidates(models2d):
    tm, jm = models2d
    img, _ = synthetic_nuclei_2d((256, 256), seed=0)
    prob, dist, points = tm.predict_sparse(img, n_tiles=(2, 2))
    prob_ref, _, points_ref = jm.predict_sparse(img, n_tiles=(2, 2))
    assert len(prob) == len(prob_ref) > 1000
    key = lambda p: np.sort(p[:, 0] * 100000 + p[:, 1])  # noqa: E731
    assert np.array_equal(key(points), key(points_ref))


@pytest.mark.parametrize("n_tiles", [(2, 2), (3, 1)])
def test_tiled_predict_instances_agrees_with_untiled(models2d, n_tiles):
    tm, _ = models2d
    img, lbl = synthetic_nuclei_2d((256, 256), seed=0)
    lab1, res1 = tm.predict_instances(img)
    lab, res = tm.predict_instances(img, n_tiles=n_tiles, show_tile_progress=False)
    assert lab.shape == img.shape
    assert matching(lab1, lab, thresh=0.5).accuracy >= 0.99
    assert matching(lbl, lab, thresh=0.5).accuracy > 0.8


@pytest.mark.parametrize("n_tiles", [(2,), (2, 2, 1), (0, 2), (2.5, 1)])
def test_bad_n_tiles_are_refused(models2d, n_tiles):
    tm, _ = models2d
    with pytest.raises(ValueError):
        tm.predict(np.zeros((64, 64), np.float32), n_tiles=n_tiles)


def test_channel_axis_cannot_be_tiled(models2d):
    tm, _ = models2d
    with pytest.raises(ValueError, match="only allowed"):
        tm.predict(np.zeros((64, 64, 1), np.float32), axes="YXC", n_tiles=(2, 2, 2))


def test_tile_counts_cover_every_combination():
    x = np.zeros((64, 64, 1))
    n = list(itertools.product(*[range(1, 4)] * 2))
    for a, b in n:
        assert tiling.total_n_tiles(x, (a, b, 1), (8, 8, 1), (1, 1, 0)) == a * b
