"""stardist_torch.big and StarDistBase.predict_instances_big against
stardist_tpu's, on the CPU.

The block covers are the reference's exactly (each block's read, crop and
write slices), and block-wise reassembly gives back the label image, on
the cases of tests/test_big.py. ``predict_instances_big`` in 2D and 3D,
with and without a class branch, is held exactly against the reference's
on the same image, with the port's net answering with the reference's own
f32 forward (``reference_forward``, tests/test_torch_multiclass.py): the
blocks, each block's extraction, NMS, raster, ownership filter and
relabelling, and the joined object keys are the port's code on the
reference's numbers."""
import numpy as np
import pytest
import torch

from stardist_torch.big import OBJECT_KEYS, Block, BlockND
from stardist_torch.matching import matching
from stardist_torch.models import StarDist2D
from stardist_torch.utils import calculate_extents
from stardist_tpu.big import Block as BlockJax, BlockND as BlockNDJax
from stardist_tpu.models import StarDist2D as StarDist2DJax
from test_big import repeat
from test_torch_multiclass import _grafted, reference_forward
from utils import synthetic_nuclei_2d, synthetic_nuclei_3d

torch.set_num_threads(2)


def _same_cover(blocks, ref):
    assert len(blocks) == len(ref)
    for b, r in zip(blocks, ref):
        for f in ("slice_read", "slice_crop_context", "slice_write"):
            assert getattr(b, f)() == getattr(r, f)(), f


def _reassemble(lbl, axes, block_size, min_overlap, context, grid):
    blocks = BlockND.cover(lbl.shape, axes=axes, block_size=block_size,
                           min_overlap=min_overlap, context=context, grid=grid)
    _same_cover(blocks, BlockNDJax.cover(lbl.shape, axes=axes, block_size=block_size,
                                         min_overlap=min_overlap, context=context, grid=grid))
    result = np.zeros_like(lbl)
    for block in blocks:
        x = block.crop_context(block.read(lbl))
        block.write(result, block.filter_objects(x, polys=None))
    assert np.array_equal(lbl, result)


@pytest.mark.parametrize("grid", [1, 3, 6])
@pytest.mark.parametrize("block_size, context", [(40, 0), (55, 3), (80, 10), (128, 17)])
def test_cover2d_equals_reference(block_size, context, grid):
    lbl = synthetic_nuclei_2d((100, 100), r_range=(3, 6), seed=1)[1].astype(np.int32)
    min_overlap = tuple(1 + int(v) for v in calculate_extents(lbl, func=np.max))
    _reassemble(repeat(lbl, 3), "YX", block_size, min_overlap, context, grid)


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("block_size, context", [((33, 48, 48), 3), ((30, 62, 60), (0, 11, 9))])
def test_cover3d_equals_reference(block_size, context, grid):
    lbl = synthetic_nuclei_3d((40, 56, 56), r_range=(3, 6), seed=1)[1].astype(np.int32)
    min_overlap = tuple(1 + int(v) for v in calculate_extents(lbl, func=np.max))
    _reassemble(repeat(lbl, (1, 2, 2)), "ZYX", block_size, min_overlap, context, grid)


def test_edgecases_equal_reference():
    """The extra context that keeps non-neighbouring write regions apart,
    for every size from 7800 to 7999 (the reference's sweep)."""
    for size in range(7800, 8000):
        got = Block.cover(size=size, block_size=4096, min_overlap=128, context=128, grid=16)
        want = BlockJax.cover(size=size, block_size=4096, min_overlap=128, context=128, grid=16,
                              verbose=False)
        assert [(b.slice_read, b.slice_write) for b in got] == \
            [(b.slice_read, b.slice_write) for b in want]


def test_object_filter_keeps_class_rows():
    """filter_objects keeps the rows of every object key, class_prob and
    class_id too, and moves the coordinates into the whole image."""
    lbl = repeat(synthetic_nuclei_2d((60, 60), r_range=(3, 6), seed=2)[1].astype(np.int32), 2)
    n = int(lbl.max())
    polys = {"prob": np.arange(n, dtype=np.float32), "points": np.zeros((n, 2), np.int64),
             "coord": np.zeros((n, 2, 8), np.float32), "class_prob": np.eye(3)[np.arange(n) % 3],
             "class_id": np.arange(n) % 3, "rays": "kept as it is"}
    assert {"class_prob", "class_id"} <= OBJECT_KEYS
    block = BlockND.cover(lbl.shape, "YX", 64, 20, 4)[-1]
    x = block.crop_context(block.read(lbl))
    labels, out = block.filter_objects(x, polys)
    ids = np.unique(labels[labels > 0]) - 1
    assert np.array_equal(out["class_id"], polys["class_id"][ids])
    assert np.array_equal(out["class_prob"], polys["class_prob"][ids])
    assert out["rays"] == polys["rays"]
    start = [s.start for s in block.slice_read()]
    assert np.array_equal(out["points"], np.tile(start, (len(ids), 1)))


@pytest.fixture(scope="module")
def demos():
    return {"2D": _grafted("2D_demo", 3), "3D": _grafted("3D_demo", 2)}


def _big(m, img, nd, **kw):
    if nd == 2:
        return m.predict_instances_big(img, "YX", block_size=160, min_overlap=48, context=24, **kw)
    return m.predict_instances_big(img, "ZYX", block_size=(20, 64, 64), min_overlap=(4, 24, 24),
                                   context=(0, 8, 8), prob_thresh=0.7, **kw)


@pytest.mark.parametrize("case", ["2D", "2D-multiclass", "3D-multiclass"])
def test_predict_instances_big_equals_reference(demos, case):
    """Labels and every key exactly the reference's, block for block."""
    nd = int(case[0])
    if case == "2D":
        jm = StarDist2DJax(None, "2D_demo", "models/examples")
        tm = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    else:
        jm, tm = demos[case[:2]]
    img = (synthetic_nuclei_2d((300, 280), n=60, seed=8)[0] if nd == 2
           else synthetic_nuclei_3d((20, 88, 88), n=40, r_range=(3, 5), seed=4)[0])
    lj, dj = _big(jm, img, nd)
    with reference_forward(tm, jm):
        lt, dt = _big(tm, img, nd)
    assert lt.dtype == np.int32 and np.array_equal(lt, lj)
    assert len(dj["prob"]) >= (20 if nd == 2 else 4)
    assert set(dt) >= set(dj)
    assert np.array_equal(np.unique(lt)[1:], np.arange(1, len(dt["prob"]) + 1))
    for k in set(dj) & OBJECT_KEYS:
        assert dt[k].shape == dj[k].shape and np.array_equal(dt[k], dj[k]), k
    assert ("class_id" in dt) == ("multiclass" in case)


def test_predict_instances_big_agrees_with_one_call():
    """Block-wise against one predict_instances of the whole image (the
    port's own forward): the same objects, up to those near a block's
    seams whose neighbourhood differs."""
    tm = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    img = synthetic_nuclei_2d((300, 280), n=60, seed=8)[0]
    lab, det = tm.predict_instances(img)
    lab_b, det_b = _big(tm, img, 2, labels_out_dtype=np.uint16)
    assert lab_b.dtype == np.uint16
    assert matching(lab, lab_b, thresh=0.5).accuracy >= 0.98
    assert tm.predict_instances_big(img, "YX", 160, 48, 24, labels_out=False)[0] is None
