"""stardist_torch.parallel.predict_instances_big_multihost on two gloo
ranks spawned on the CPU, against the port's one-process
predict_instances_big on the same image (the reference's contract,
tests/test_multihost.py): in 2D and 3D, with and without a class branch,
both stitch modes. Replicated: each rank's labels exactly the one-process
labels. Partitioned: the ranks' writes into one shared memmap exactly the
one-process labels. Both modes: every object key of the one-process result
(all but ``nms_counters`` and ``timings_s``, each rank's own) with its
dtype and values, on every rank. Each spawn has a file:// rendezvous in
tmp_path and a 120 s limit, past which the ranks are killed and the test
fails."""
import numpy as np
import pytest
import torch

from _torch_rank_workers import BIG_2D, BIG_3D, demo_model, multihost_rank
from stardist_torch.big import BlockND
from stardist_torch.parallel import run_ranks, world
from utils import synthetic_nuclei_2d, synthetic_nuclei_3d

torch.set_num_threads(2)


def _same_objects(got, want):
    assert set(got) == set(want) - {"nms_counters", "timings_s"}
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            g = got[k]
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


@pytest.mark.parametrize("kind", ["2D", "2D-mc", "3D", "3D-mc"])
def test_two_ranks_equal_one_process(tmp_path, kind):
    if kind.startswith("2D"):
        img = synthetic_nuclei_2d((176, 176), n=40, r_range=(4, 8), seed=8)[0]
        kw = dict(BIG_2D)
    else:
        img = synthetic_nuclei_3d((16, 64, 96), n=24, r_range=(3, 5), seed=4)[0]
        kw = dict(BIG_3D)
    model = demo_model(kind)
    axes = kw.pop("axes")
    n_blocks = len(BlockND.cover(img.shape, axes, kw["block_size"], kw["min_overlap"],
                                 kw["context"], model._axes_div_by(axes)))
    want, details = model.predict_instances_big(img, axes, **kw)
    assert int(want.max()) >= (20 if kind.startswith("2D") else 10)
    assert ("class_prob" in details) == kind.endswith("-mc")

    shared = tmp_path / "labels.i32"
    np.memmap(shared, dtype=np.int32, mode="w+", shape=img.shape).flush()
    ranks = run_ranks(multihost_rank, 2, (kind, img, str(shared)), threads=2, timeout=120,
                      tmp_dir=tmp_path)
    assert np.array_equal(np.memmap(shared, dtype=np.int32, mode="r", shape=img.shape), want)
    blocks = []
    for r in ranks:
        assert r["labels"].dtype == want.dtype and np.array_equal(r["labels"], want)
        _same_objects(r["polys"], details)
        _same_objects(r["polys_partitioned"], details)
        replicated, partitioned = r["stats"]
        blocks.append(replicated["blocks"])
        assert replicated["bytes"] > 0 and partitioned["bytes"] > replicated["bytes"]
    assert sum(blocks) == n_blocks and min(blocks) >= 1


def test_one_process_is_the_single_process_path():
    """Without a process group: rank 0 of 1, and multi-process prediction
    is one-process block-wise prediction, in both stitch modes."""
    from stardist_torch.parallel import predict_instances_big_multihost
    assert world() == (0, 1, None)
    img = synthetic_nuclei_2d((176, 176), n=40, r_range=(4, 8), seed=8)[0]
    model = demo_model("2D")
    kw = dict(BIG_2D)
    want, details = model.predict_instances_big(img, **kw)
    for stitch in ("replicated", "partitioned"):
        stats = {}
        got, polys = predict_instances_big_multihost(model, img, stitch=stitch, stats=stats, **kw)
        assert np.array_equal(got, want)
        _same_objects(polys, details)
        assert stats["bytes"] == 0
