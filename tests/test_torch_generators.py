"""The prediction generators of stardist_torch against stardist_tpu's:
``_predict_generator``, ``_predict_sparse_generator`` and
``_predict_instances_generator`` yield what the reference's yield (None
after each tile; ``"predict"``, ``"tile"`` per tile and ``"nms"`` before
the instances' result) and end in the same result; ``predict``,
``predict_sparse`` and ``predict_instances`` run them to their end.

Both packages' nets answer with the reference's f32 forward
(``reference_forward``), so the results are exactly equal. The 3D device
path runs the reference's device lattice (S = 10) and equals the
reference's instances at S = 10."""
import shutil
import time

import numpy as np
import pytest
import torch

from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_torch.models import StarDist2D, StarDist3D
from stardist_torch.models.model3d import DEVICE_LATTICE_S
from tests.test_torch_multiclass import _grafted, reference_forward
from tests.utils import synthetic_nuclei_2d, synthetic_nuclei_3d

torch.set_num_threads(2)

TILES = {"2d": (2, 2), "3d": (1, 2, 2)}
THRESH = {"2d": None, "3d": 0.7}       # fewer 3D candidates: its NMS is slow on the CPU
N_TILES = 4


@pytest.fixture(scope="module")
def models():
    return {"2d": (synthetic_nuclei_2d((160, 160), n=20, seed=1)[0],
                   StarDist2DJax(None, "2D_demo", "models/examples"),
                   StarDist2D(None, "2D_demo", "models/examples", device="cpu")),
            "3d": (synthetic_nuclei_3d((16, 40, 40), n=8, seed=0)[0],
                   StarDist3DJax(None, "3D_demo", "models/examples"),
                   StarDist3D(None, "3D_demo", "models/examples", device="cpu"))}


def _run(gen):
    """(every yield but the last, the last)."""
    out = list(gen)
    return out[:-1], out[-1]


def _same_instances(got, ref, n_min=3):
    (lt, dt), (lj, dj) = got, ref
    assert np.array_equal(lt, lj) and len(dj["prob"]) >= n_min
    for k in ("points", "prob", "coord" if "coord" in dj else "dist", "class_prob", "class_id"):
        if k in dj:
            assert np.array_equal(dt[k], np.asarray(dj[k])), k


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("nd", ["2d", "3d"])
def test_instances_generator_equals_reference(models, nd, sparse, tiled):
    img, jm, tm = models[nd]
    kw = dict(sparse=sparse, n_tiles=TILES[nd] if tiled else None, prob_thresh=THRESH[nd])
    steps_j, res_j = _run(jm._predict_instances_generator(img, **kw))
    with reference_forward(tm, jm):
        steps_t, res_t = _run(tm._predict_instances_generator(img, **kw))
        drained = tm.predict_instances(img, **kw)
    assert steps_t == steps_j == ["predict"] + ["tile"] * (N_TILES if tiled else 0) + ["nms"]
    _same_instances(res_t, res_j)
    _same_instances(drained, res_j)
    assert set(res_t[1]["timings_s"]) == set(drained[1]["timings_s"])


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
@pytest.mark.parametrize("nd", ["2d", "3d"])
@pytest.mark.parametrize("kind", ["predict", "predict_sparse"])
def test_predict_generators_equal_reference(models, kind, nd, tiled):
    img, jm, tm = models[nd]
    kw = dict(n_tiles=TILES[nd] if tiled else None)
    steps_j, res_j = _run(getattr(jm, f"_{kind}_generator")(img, **kw))
    with reference_forward(tm, jm):
        steps_t, res_t = _run(getattr(tm, f"_{kind}_generator")(img, **kw))
        drained = getattr(tm, kind)(img, **kw)
    assert steps_t == steps_j == [None] * (N_TILES if tiled else 0)
    assert len(res_t) == len(res_j) == len(drained)
    for a, b, c in zip(res_t, res_j, drained):
        assert isinstance(a, np.ndarray) and a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b)) and np.array_equal(c, a)
    assert len(res_t[0]) > 10


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_multiclass_instances_generator_equals_reference(sparse):
    """The 2D_demo with a grafted three-class branch, tiled: the same
    yields, and the survivors' class rows exactly the reference's."""
    jm, tm = _grafted("2D_demo", 3)
    img = synthetic_nuclei_2d((160, 160), n=20, seed=1)[0]
    kw = dict(sparse=sparse, n_tiles=(2, 2))
    steps_j, res_j = _run(jm._predict_instances_generator(img, **kw))
    with reference_forward(tm, jm):
        steps_t, res_t = _run(tm._predict_instances_generator(img, **kw))
        steps_s, res_s = _run(tm._predict_sparse_generator(img, n_tiles=(2, 2)))
    assert steps_t == steps_j == ["predict"] + ["tile"] * N_TILES + ["nms"]
    _same_instances(res_t, res_j)
    assert steps_s == [None] * N_TILES and len(res_s) == 4     # prob, dist, prob_class, points
    assert res_s[2].shape == (len(res_s[0]), 4)


@pytest.mark.parametrize("kind", ["predict", "predict_sparse"])
def test_extra_predict_keywords_are_taken(models, kind):
    """predict(img, foo=1) and predict_sparse(img, foo=1) run as in the
    reference, which takes **predict_kwargs and ignores them."""
    img, jm, tm = models["2d"]
    got = getattr(tm, kind)(img, foo=1)
    want = getattr(tm, kind)(img)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    getattr(jm, kind)(img, foo=1)


def test_a_generator_runs_only_when_iterated(models):
    """Made and never run, a generator does nothing; its first yield,
    "predict", comes before the forward."""
    img, _, tm = models["2d"]
    calls = []
    inner = tm.net.forward
    tm.net.forward = lambda x, plain=False: (calls.append(x.shape), inner(x))[1]
    try:
        gen = tm._predict_instances_generator(img, n_tiles=(2, 2))
        tm._predict_generator(img)
        tm._predict_sparse_generator(img)
        assert calls == []
        assert next(gen) == "predict" and calls == []
        assert next(gen) == "tile" and len(calls) == 1
        gen.close()
    finally:
        del tm.net.forward
    assert len(calls) == 1


def test_interleaved_generators_keep_their_own_state(models):
    """Two generators on one model, stepped in turn (one tiled and dense,
    one sparse with other thresholds), end in the results of two separate
    calls."""
    img, _, tm = models["2d"]
    kw1 = dict(n_tiles=(2, 2), sparse=False)
    kw2 = dict(prob_thresh=0.6, nms_thresh=0.2)
    g1 = tm._predict_instances_generator(img, **kw1)
    g2 = tm._predict_instances_generator(img[:128, :96], **kw2)
    out1 = out2 = None
    while out1 is None or out2 is None:
        for g, slot in ((g1, 1), (g2, 2)):
            try:
                r = next(g)
            except StopIteration:
                continue
            if isinstance(r, tuple):
                if slot == 1:
                    out1 = r
                else:
                    out2 = r
    _same_instances(out1, tm.predict_instances(img, **kw1))
    _same_instances(out2, tm.predict_instances(img[:128, :96], **kw2), n_min=1)


class _PausedClock:
    """``time`` for models/base.py whose perf_counter jumps by ``pause``
    seconds each time the test calls :meth:`hold`: a caller that holds a
    yield that long, without the wait."""

    def __init__(self, pause):
        self.pause, self.offset = pause, 0.0

    def hold(self):
        self.offset += self.pause

    def perf_counter(self):
        return time.perf_counter() + self.offset

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_stage_times_leave_out_the_callers_time(models, monkeypatch, sparse):
    """timings_s counts no time that the caller holds a yield: with 1000 s
    held at each "tile" of a tiled call (the dense forward is timed across
    its yields) and at "nms", every stage stays far below it."""
    from stardist_torch.models import base
    img, _, tm = models["2d"]
    clock = _PausedClock(1000.0)
    monkeypatch.setattr(base, "time", clock)
    steps = []
    for step in tm._predict_instances_generator(img, n_tiles=(2, 2), sparse=sparse):
        if isinstance(step, tuple):
            t = step[1]["timings_s"]
            break
        steps.append(step)
        clock.hold()
    assert steps == ["predict"] + ["tile"] * N_TILES + ["nms"]
    assert clock.offset == 6000.0 and all(v < 100.0 for v in t.values()), t


def test_3d_device_path_runs_the_reference_device_lattice(models, tmp_path):
    """The 3D predict_instances_device is predict_instances with
    nms_kwargs={"samples": 10}, the reference's device lattice
    (model3d.py:554), with fetch=True and fetch=False. On the same forward
    it equals the reference's predict_instances at S = 10 and the
    reference's own predict_instances_device (one fused jit on the CPU,
    which writes device_caps.json into its model folder: a copy here; at
    prob_thresh 0.75 its capacities settle in two rounds)."""
    img, jm, tm = models["3d"]
    assert DEVICE_LATTICE_S == 10
    shutil.copytree("models/examples/3D_demo", tmp_path / "3D_demo")
    jm_dev = StarDist3DJax(None, "3D_demo", str(tmp_path))
    kw = dict(prob_thresh=0.75)
    ref_dev = jm_dev.predict_instances_device(img, **kw)
    ref = jm.predict_instances(img, nms_kwargs={"samples": 10}, **kw)
    with reference_forward(tm, jm):
        dev = tm.predict_instances_device(img, **kw)
        dev_t = tm.predict_instances_device(img, fetch=False, **kw)
        at10 = tm.predict_instances(img, nms_kwargs={"samples": 10}, **kw)
    _same_instances(dev, ref_dev)
    _same_instances(dev, ref)
    _same_instances(dev, at10)
    assert isinstance(dev_t[0], torch.Tensor) and np.array_equal(dev_t[0].numpy(), dev[0])
    for k in ("points", "prob", "dist"):
        assert np.array_equal(dev_t[1][k].numpy(), dev[1][k])
