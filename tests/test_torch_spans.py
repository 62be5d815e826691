"""The prediction path's spans (``stardist_torch.core.profiling.span``):
under a torch profiler one ``predict_instances`` call records its root once
and every stage inside it, the sub-spans inside their stage; with no
profiler no ``record_function`` is entered and ``timings_s`` keeps its
keys; no span stays open across a yield of the prediction generators, so
a generator dropped mid-way leaves none open and a caller's time at a
yield counts in no stage; ``trace(logdir)`` writes the spans' names."""
import gc
import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stardist_torch.core import profiling
from stardist_torch.core.profiling import span, trace
from stardist_torch.models import Config3D, StarDist2D, StarDist3D
from stardist_torch.ops.rasterize import CHUNK_3D
from stardist_torch.rays3d import Rays_GoldenSpiral
from tests.utils import synthetic_nuclei_2d, synthetic_nuclei_3d

torch.set_num_threads(2)

ROOT = "stardist.predict_instances"
STAGES_2D = ("stardist.forward", "stardist.upload", "stardist.extract", "stardist.nms",
             "stardist.nms.sort", "stardist.nms.geometry", "stardist.nms.pairs",
             "stardist.nms.bounds", "stardist.raster", "stardist.raster.draw",
             "stardist.raster.fetch", "stardist.raster.astype", "stardist.raster.details")
PARENT = {"stardist.upload": "stardist.forward", "stardist.nms.round": "stardist.nms",
          "stardist.nms.fixpoint": "stardist.nms.round",
          "stardist.nms.cascade": "stardist.nms.round",
          "stardist.nms.exact": "stardist.nms.round", "stardist.nms.block": "stardist.nms",
          "stardist.nms.sort": "stardist.nms", "stardist.nms.geometry": "stardist.nms",
          "stardist.nms.pairs": "stardist.nms", "stardist.nms.bounds": "stardist.nms",
          "stardist.raster.draw": "stardist.raster", "stardist.raster.fetch": "stardist.raster",
          "stardist.raster.astype": "stardist.raster",
          "stardist.raster.details": "stardist.raster",
          "stardist.forward.stem": "stardist.forward",
          "stardist.forward.block": "stardist.forward",
          "stardist.forward.head": "stardist.forward",
          "stardist.raster.inside": "stardist.raster.draw",
          "stardist.raster.scatter": "stardist.raster.draw"}


@pytest.fixture(scope="module")
def models():
    return {"2d": (synthetic_nuclei_2d((256, 256), n=40, seed=1)[0],
                   StarDist2D(None, "2D_demo", "models/examples", device="cpu")),
            "3d": (synthetic_nuclei_3d((16, 40, 40), n=8, seed=0)[0],
                   StarDist3D(None, "3D_demo", "models/examples", device="cpu"))}


@pytest.fixture(scope="module")
def resnet():
    """upstream's 3D notebook model (a ResNet with 96 anisotropic rays) with
    the port's seeded weights, its dist head shifted so that every ray is
    positive, on a small volume, and a prob threshold that leaves a few
    dozen candidates, so that the raster draws more than one chunk."""
    conf = Config3D(backbone="resnet", rays=Rays_GoldenSpiral(96, (2, 1, 1)), grid=(1, 2, 2),
                    anisotropy=(2, 1, 1))
    m = StarDist3D(conf, basedir=None, device="cpu")
    with torch.no_grad():
        m.net.head_dist.weight.mul_(0.25)
        m.net.head_dist.bias.fill_(4.0)
    vol = synthetic_nuclei_3d((12, 40, 40), n=6, seed=2)[0]
    prob, _ = m.net.forward(torch.from_numpy(vol)[..., None])
    thr = float(torch.quantile(prob[2:-2, 2:-2, 2:-2].flatten(), 0.95))
    return vol, m, dict(prob_thresh=thr, nms_thresh=0.3)


def traced(fn):
    """(fn's result, the program's spans: (name, start, end) in ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("stardist.")), key=lambda s: s[1])
    return out, spans


def count(spans, name):
    return sum(1 for n, _, _ in spans if n == name)


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def check_nesting(spans):
    """Every span lies inside the one root and inside a span of its
    parent's name."""
    roots = [s for s in spans if s[0] == ROOT]
    assert len(roots) == 1
    for s in spans:
        assert inside(s, roots[0]), s
        if s[0] in PARENT:
            assert any(inside(s, p) for p in spans if p[0] == PARENT[s[0]]), s


def test_2d_call_records_its_root_and_every_stage_once(models):
    img, m = models["2d"]
    (_, det), spans = traced(lambda: m.predict_instances(img))
    check_nesting(spans)
    for name in STAGES_2D:
        assert count(spans, name) == 1, name
    assert det["nms_counters"]["n_eval_pairs"] > 0
    for name in ("stardist.nms.round", "stardist.nms.fixpoint", "stardist.nms.cascade"):
        assert count(spans, name) >= 1, name
    # the host's set-up, before and after the "predict" step, comes first
    prepare = [s for s in spans if s[0] == "stardist.prepare"]
    forward = next(s for s in spans if s[0] == "stardist.forward")
    assert len(prepare) == 2 and all(p[2] <= forward[1] for p in prepare)
    stages = [next(s for s in spans if s[0] == f"stardist.{k}")
              for k in ("forward", "extract", "nms", "raster")]
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    assert set(det["timings_s"]) == {"forward", "extract", "nms", "raster"}


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_2d_tiled_call_records_a_forward_per_tile(models, sparse):
    """Tiled: one forward (and its upload) per tile, every one inside the
    root; the dense prediction's last step, which gives the maps, is a
    forward span too."""
    img, m = models["2d"]
    (_, det), spans = traced(lambda: m.predict_instances(img, n_tiles=(2, 2), sparse=sparse))
    check_nesting(spans)
    assert count(spans, "stardist.upload") == 4
    assert count(spans, "stardist.forward") == (4 if sparse else 5)
    assert count(spans, "stardist.extract") == (5 if sparse else 0)
    assert count(spans, "stardist.nms") == count(spans, "stardist.raster") == 1
    assert set(det["timings_s"]) == ({"forward", "extract", "nms", "raster"} if sparse
                                     else {"forward", "nms", "raster"})


def test_2d_device_path_on_staged_input_has_no_upload_or_fetch(models):
    """A pre-staged input with fetch=False (the device path) uploads
    nothing and leaves the labels on the device: the root and the draw,
    no upload, fetch, astype or details span."""
    img, m = models["2d"]
    x = torch.from_numpy(img[:256, :256].copy())
    (labels, _), spans = traced(lambda: m.predict_instances_device(x, fetch=False))
    check_nesting(spans)
    assert isinstance(labels, torch.Tensor) and count(spans, "stardist.raster.draw") == 1
    for name in ("stardist.upload", "stardist.raster.fetch", "stardist.raster.astype",
                 "stardist.raster.details"):
        assert count(spans, name) == 0, name


def test_3d_call_records_blocks_and_the_exact_lattice_test(models):
    vol, m = models["3d"]
    (_, det), spans = traced(lambda: m.predict_instances(vol, prob_thresh=0.7))
    check_nesting(spans)
    counters = det["nms_counters"]
    assert counters["n_eval_pairs"] > 0
    exact = [s for s in spans if s[0] == "stardist.nms.exact"]
    assert len(exact) >= 1 and counters["exact_s"] > 0
    assert all(any(inside(s, b) for b in spans if b[0] == "stardist.nms.block")
               for s in exact)
    assert count(spans, "stardist.nms.block") >= 1
    for name in ("stardist.forward", "stardist.upload", "stardist.extract", "stardist.nms",
                 "stardist.raster", "stardist.raster.draw", "stardist.raster.fetch",
                 "stardist.raster.details"):
        assert count(spans, name) == 1, name
    assert count(spans, "stardist.raster.astype") == 0


def test_3d_resnet_call_records_its_convs_and_raster_chunks(resnet):
    """A ResNet's forward records its stem, one span per residual block and
    its head inside ``stardist.forward``; the 3D raster one inside test and
    one scatter per chunk inside ``stardist.raster.draw``; the labels are
    those of a call without a profiler."""
    vol, m, kw = resnet
    labels0, det0 = m.predict_instances(vol, **kw)
    (labels, det), spans = traced(lambda: m.predict_instances(vol, **kw))
    check_nesting(spans)
    assert count(spans, "stardist.forward") == 1
    assert count(spans, "stardist.forward.stem") == count(spans, "stardist.forward.head") == 1
    assert count(spans, "stardist.forward.block") == len(m.net.blocks) == 4
    n = len(det["prob"])
    chunks = math.ceil(n / CHUNK_3D)
    assert chunks >= 2, n
    assert count(spans, "stardist.raster.inside") == count(spans, "stardist.raster.scatter") \
        == chunks
    # each chunk's inside test comes before its scatter
    chunk_spans = [s for s in spans if s[0] in ("stardist.raster.inside",
                                                "stardist.raster.scatter")]
    assert [s[0] for s in chunk_spans] == ["stardist.raster.inside",
                                           "stardist.raster.scatter"] * chunks
    assert np.array_equal(labels, labels0) and np.array_equal(det["points"], det0["points"])
    assert set(det["timings_s"]) == {"forward", "extract", "nms", "raster"}


def test_3d_resnet_without_profiler_enters_no_record_function(resnet, monkeypatch):
    vol, m, kw = resnet
    rec = _Counting()
    monkeypatch.setattr(profiling, "record_function", rec)
    m.predict_instances(vol, **kw)
    assert rec.entered == 0
    monkeypatch.setattr(profiling, "_recording", lambda: True)
    m.predict_instances(vol, **kw)
    assert rec.open == []
    for name in ("stardist.forward.stem", "stardist.forward.block", "stardist.forward.head",
                 "stardist.raster.inside", "stardist.raster.scatter"):
        assert name in rec.names, name


class _Counting:
    """A stand-in for ``record_function``: counts the spans entered and
    keeps the names of those open."""

    def __init__(self):
        self.entered, self.open, self.names = 0, [], []

    def __call__(self, name):
        rec = self

        class _Range:
            def __enter__(self):
                rec.entered += 1
                rec.open.append(name)
                rec.names.append(name)
                return self

            def __exit__(self, *exc):
                rec.open.remove(name)
        return _Range()


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_no_profiler_enters_no_record_function(models, monkeypatch, sparse):
    img, m = models["2d"]
    rec = _Counting()
    monkeypatch.setattr(profiling, "record_function", rec)
    _, det = m.predict_instances(img, sparse=sparse)
    assert rec.entered == 0
    assert set(det["timings_s"]) == ({"forward", "extract", "nms", "raster"} if sparse
                                     else {"forward", "nms", "raster"})
    monkeypatch.setattr(profiling, "_recording", lambda: True)
    m.predict_instances(img, sparse=sparse)
    assert rec.entered > 10 and rec.open == []


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_a_dropped_generator_leaves_no_span_open(models, monkeypatch, sparse):
    """Driven step by step, the generator holds no span at any yield (so
    a caller-driven generator has no root), and dropped after its second
    tile it leaves none open."""
    img, m = models["2d"]
    rec = _Counting()
    monkeypatch.setattr(profiling, "record_function", rec)
    monkeypatch.setattr(profiling, "_recording", lambda: True)
    gen = m._predict_instances_generator(img, n_tiles=(2, 2), sparse=sparse)
    steps = []
    for step in gen:
        assert rec.open == [], (step, rec.open)
        steps.append(step)
        if steps.count("tile") == 2:
            break
    del gen
    gc.collect()
    assert steps == ["predict", "tile", "tile"] and rec.open == [] and rec.entered > 4
    assert ROOT not in rec.names


class _PausedClock:
    """``time`` for core/profiling.py whose perf_counter jumps by ``pause``
    seconds each time the test calls :meth:`hold`."""

    def __init__(self, pause):
        import time
        self._time, self.pause, self.offset = time, pause, 0.0

    def hold(self):
        self.offset += self.pause

    def perf_counter(self):
        return self._time.perf_counter() + self.offset


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_span_clock_leaves_out_the_callers_time(models, monkeypatch, sparse):
    """The stage spans take ``timings_s`` on their own clock: with 1000 s
    held at every yield of a tiled call, no stage counts any of it."""
    img, m = models["2d"]
    clock = _PausedClock(1000.0)
    monkeypatch.setattr(profiling, "time", clock)
    for step in m._predict_instances_generator(img, n_tiles=(2, 2), sparse=sparse):
        if isinstance(step, tuple):
            t = step[1]["timings_s"]
            break
        clock.hold()
    assert clock.offset == 6000.0 and all(v < 100.0 for v in t.values()), t


def test_span_adds_its_time_and_closes_on_an_exception(monkeypatch):
    clock = _PausedClock(2.0)
    monkeypatch.setattr(profiling, "time", clock)
    t = {"forward": 1.0}
    with span("stardist.forward", t, "forward"):
        clock.hold()
    with span("stardist.extract", t, "extract"):
        clock.hold()
        clock.hold()
    with span("stardist.upload"):
        clock.hold()
    assert t["forward"] == pytest.approx(3.0, abs=0.01)
    assert t["extract"] == pytest.approx(4.0, abs=0.01) and set(t) == {"forward", "extract"}
    with pytest.raises(ValueError), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("stardist.outer"):
            with span("stardist.inner", t, "inner"):
                raise ValueError("in a span")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("stardist.outer") == names.count("stardist.inner") == 1
    assert "inner" in t


def test_trace_holds_the_spans(models, tmp_path):
    img, m = models["2d"]
    with trace(tmp_path / "tr"):
        m.predict_instances(img[:128, :128])
    (path,) = (tmp_path / "tr").glob("*.json")
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert {ROOT, "stardist.forward", "stardist.nms", "stardist.raster.astype"} <= names
