"""stardist_torch.parallel on the CPU: the block-sharded big-image
prediction against stardist_tpu's, and the process-group helpers without a
process group.

``predict_instances_big_sharded`` on three CPU slots (so that the last
batch is a partial one) against the reference's on its eight virtual CPU
devices: labels and every object key exactly equal, with the port's net
answering with the forward the reference's sharded path runs (a jitted
``net.apply`` on one block, :func:`sharded_forward`), so that everything
after the forward (the crop of the padded edge blocks, the candidates, the
NMS, labels and stitch) is the port's code on the reference's numbers.
With the port's own forward: matching accuracy 1.0 at IoU 0.99 against
the port's ``predict_instances_big`` and the same object count (the
reference's check, tests/test_parallel.py:50-67); the zarr-like input and
output are read and written once per block (tests/test_parallel.py:103)."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from _torch_rank_workers import BIG_2D
from stardist_torch.big import OBJECT_KEYS
from stardist_torch.matching import matching
from stardist_torch.models import StarDist2D
from stardist_torch.parallel import data_parallel_slice, predict_instances_big_sharded, world
from stardist_torch.parallel.bigpredict import _devices
from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.parallel.bigpredict import \
    predict_instances_big_sharded as predict_instances_big_sharded_jax
from test_parallel import _LazyImage, _LazyOut
from utils import synthetic_nuclei_2d

torch.set_num_threads(2)


@contextlib.contextmanager
def sharded_forward(tm, jm):
    """The port's net answers with the reference sharded path's forward on
    one block (``net.apply(..., train=False)``, jitted), as the port's
    forward lays it out: prob (sp'), dist (R, sp')."""
    fwd = jax.jit(lambda params, x: jm.net.apply({**jm._extra_vars, "params": params}, x,
                                                 train=False))

    def forward(x, plain=False):
        prob, dist = fwd(jm.params, x.numpy()[None])[:2]
        return (torch.from_numpy(np.array(prob[0, ..., 0])),
                torch.from_numpy(np.moveaxis(np.array(dist[0]), -1, 0).copy()))
    tm.net.forward = forward
    try:
        yield
    finally:
        del tm.net.forward


@pytest.fixture(scope="module")
def models():
    return (StarDist2D(None, "2D_demo", "models/examples", device="cpu"),
            StarDist2DJax(None, "2D_demo", "models/examples"))


@pytest.fixture(scope="module")
def img():
    return synthetic_nuclei_2d((176, 176), n=40, r_range=(4, 8), seed=8)[0]


KW = {k: v for k, v in BIG_2D.items() if k != "axes"}


def test_sharded_equals_reference(models, img):
    tm, jm = models
    assert len(jax.devices()) == 8
    lj, dj = predict_instances_big_sharded_jax(jm, img, "YX", **KW)
    timings = {}
    with sharded_forward(tm, jm):
        lt, dt = predict_instances_big_sharded(tm, img, "YX", devices=["cpu"] * 3,
                                               timings=timings, **KW)
    assert timings["blocks"] == 4 and timings["batches"] == 2     # 3 + a partial batch of 1
    assert len(dj["prob"]) >= 20
    assert lt.dtype == lj.dtype and np.array_equal(lt, lj)
    assert set(dj) & OBJECT_KEYS <= set(dt)
    for k in set(dj) & OBJECT_KEYS:
        assert dt[k].dtype == dj[k].dtype and np.array_equal(dt[k], dj[k]), k


def test_sharded_agrees_with_block_wise(models, img):
    tm, _ = models
    want, dw = tm.predict_instances_big(img, "YX", **KW)
    for devices in (None, ["cpu"], ["cpu"] * 3):
        got, dg = predict_instances_big_sharded(tm, img, "YX", devices=devices, **KW)
        assert matching(want, got, thresh=0.99).accuracy == 1.0
        assert len(dg["prob"]) == len(dw["prob"]) >= 20


def test_sharded_streams_zarr_like(models, img):
    tm, _ = models
    want, dw = predict_instances_big_sharded(tm, img, "YX", devices=["cpu"] * 2, **KW)
    lazy_in, lazy_out = _LazyImage(img), _LazyOut(img.shape)
    out, polys = predict_instances_big_sharded(tm, lazy_in, "YX", labels_out=lazy_out,
                                               devices=["cpu"] * 2, **KW)
    assert out is lazy_out
    assert lazy_in.reads == lazy_out.writes == 4
    assert np.array_equal(lazy_out[...], want) and len(polys["prob"]) == len(dw["prob"])
    assert predict_instances_big_sharded(tm, img, "YX", labels_out=False, **KW)[0] is None


def test_devices_never_become_another_kind(models):
    """The default is the model's device on the CPU; a list that mixes the
    CPU and CUDA raises, and a CUDA entry is never swapped for the CPU."""
    tm, _ = models
    assert _devices(tm, None) == [torch.device("cpu")]
    assert _devices(tm, ["cpu", torch.device("cpu")]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        _devices(tm, ["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        _devices(tm, [])


def test_no_process_group():
    """Without a process group: rank 0 of 1, and no batch is split."""
    assert world() == (0, 1, None)
    assert data_parallel_slice(4) is None and data_parallel_slice(3) is None
