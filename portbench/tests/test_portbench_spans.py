"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that use it) on synthetic traces: stage times, sync counts and the
call's unstaged time per completed traced call, and None where a span is
absent."""
import json
import sys

import pytest

from portbench import manifest
from portbench.trace import CALL, WINDOW, Trace
from portbench.window import Call

sys.path.insert(0, str(manifest.HERE))
import run  # noqa: E402

ROOT = "stardist.predict_instances"


def one_call(t, staged=False):
    """Host events of a 2D call starting at ``t`` (seconds): a root of 10
    with stage spans over 9.5 of it, NMS sub-spans and three syncs, two of
    them inside the NMS."""
    ev = [(CALL, False, t, t + 10.5), (ROOT, False, t, t + 10),
          ("stardist.prepare", False, t + 0.2, t + 0.5),
          ("stardist.forward", False, t + 0.5, t + 3),
          ("stardist.extract", False, t + 3, t + 3.5),
          ("stardist.nms", False, t + 3.5, t + 7),
          ("stardist.nms.sort", False, t + 3.6, t + 4),
          ("stardist.nms.round", False, t + 4, t + 6),
          ("stardist.nms.fixpoint", False, t + 4.1, t + 4.5),
          ("cudaStreamSynchronize", False, t + 4.2, t + 4.4),
          ("cudaDeviceSynchronize", False, t + 6.5, t + 6.6),
          ("aten::nonzero", False, t + 6.4, t + 6.8),
          ("stardist.raster", False, t + 7, t + 9.8),
          ("stardist.raster.draw", False, t + 7, t + 7.5),
          ("cudaStreamSynchronize", False, t + 7.6, t + 7.7),
          ("conv_kernel<1>", True, t + 0.6, t + 2.5),
          ("stardist.forward", True, t + 0.6, t + 2.5)]
    if not staged:
        ev += [("stardist.upload", False, t + 0.5, t + 1.5),
               ("stardist.raster.fetch", False, t + 7.5, t + 8.5),
               ("stardist.raster.astype", False, t + 8.5, t + 9.5)]
    return ev


def ctx_of(events, n_calls, cfg="2D_demo", shape=(256, 256), failed=0):
    man = manifest.load(manifest.HERE.parent)
    _, model_dir = manifest.config(man, cfg, manifest.HERE.parent)
    conf = json.loads((model_dir / "config.json").read_text())
    calls = [Call(0.0, 1.0, 0, 5) for _ in range(n_calls)] + [Call(0.0, 1.0, 0)] * failed
    tr = None if events is None else Trace(events)
    return run.Ctx(conf, shape, 1.0, calls, traced=calls if tr else (), trace=tr)


def read(name, ctx):
    return manifest.reader(name)(ctx)


def test_stage_syncs_and_self_time_per_call():
    ev = [(WINDOW, False, 0.0, 40.0)] + one_call(1.0) + one_call(15.0)
    ctx = ctx_of(ev, 2, failed=1)      # a failed call counts for nothing
    assert read("prepare_ms.2d", ctx) == pytest.approx(300.0)
    assert read("upload_ms.2d", ctx) == pytest.approx(1000.0)
    assert read("label_fetch_ms.2d", ctx) == pytest.approx(1000.0)
    assert read("label_astype_ms.2d", ctx) == pytest.approx(1000.0)
    assert read("nms_syncs.2d", ctx) == pytest.approx(2.0)
    assert read("nms_sync_ms.2d", ctx) == pytest.approx(300.0)
    # the root's 10 s less its stages' union (0.2-9.8): 0.4 s a call
    assert read("call_self_ms.2d", ctx) == pytest.approx(400.0)
    assert read("nms_exact_ms.3d", ctx) is None


def test_spans_are_clipped_to_the_window_and_merged():
    """A span left half outside the window counts only inside it; a span
    nested in one of its own name counts once."""
    ev = [(WINDOW, False, 0.0, 12.0)] + one_call(1.0) + one_call(11.0)
    ev += [("stardist.prepare", False, 1.25, 1.35)]
    ctx = ctx_of(ev, 2)
    # first call 0.3 s; the second 0.2-0.5 after 11 s: 0.3 s, all inside 12 s
    assert read("prepare_ms.2d", ctx) == pytest.approx(300.0)
    # the second call's upload (11.5-12.5) is cut at 12: 0.5 s
    assert read("upload_ms.2d", ctx) == pytest.approx(750.0)


def test_readers_give_none_where_the_span_is_absent():
    """The staged device path has no upload and no label fetch; a program
    without spans gives none of the metrics; an untraced run has no
    trace; a 3D cell reads none of the 2D ones."""
    staged = ctx_of([(WINDOW, False, 0.0, 40.0)] + one_call(1.0, staged=True), 1)
    for name in ("upload_ms.2d", "label_fetch_ms.2d", "label_astype_ms.2d"):
        assert read(name, staged) is None, name
    assert read("nms_syncs.2d", staged) == pytest.approx(2.0)
    bare = [(WINDOW, False, 0.0, 40.0)] + [e for e in one_call(1.0)
                                           if not e[0].startswith("stardist.")]
    names = ("prepare_ms.2d", "upload_ms.2d", "label_fetch_ms.2d", "label_astype_ms.2d",
             "nms_sync_ms.2d", "nms_syncs.2d", "call_self_ms.2d")
    for name in names:
        assert read(name, ctx_of(bare, 1)) is None, name
        assert read(name, ctx_of(None, 1)) is None, name
        assert read(name, ctx_of([(WINDOW, False, 0.0, 40.0)] + one_call(1.0), 0)) is None
    vol = ctx_of([(WINDOW, False, 0.0, 40.0)] + one_call(1.0), 1, "3D_demo", (32, 64, 64))
    for name in names:
        assert read(name, vol) is None, name


def test_exact_lattice_time_3d():
    ev = [(WINDOW, False, 0.0, 40.0), (ROOT, False, 1.0, 9.0),
          ("stardist.nms", False, 2.0, 8.0), ("stardist.nms.block", False, 2.0, 8.0),
          ("stardist.nms.exact", False, 3.0, 4.5), ("stardist.nms.exact", False, 5.0, 7.0)]
    vol = ctx_of(ev, 2, "3D_demo", (32, 64, 64))
    assert read("nms_exact_ms.3d", vol) == pytest.approx(1750.0)
    assert read("nms_exact_ms.3d", ctx_of(ev[:4], 2, "3D_demo", (32, 64, 64))) is None
