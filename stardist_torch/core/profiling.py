"""Profiling helpers: a torch.profiler trace context, the prediction
path's spans and device-synced timing (the counterpart of
stardist_tpu/core/profiling.py).

- :func:`trace` records a region with ``torch.profiler`` (the host's
  activity, and the card's where CUDA is available) and writes it as a
  Chrome trace into ``logdir``, a file that TensorBoard's profiler plugin
  and Perfetto (ui.perfetto.dev) both open;
- :class:`span` marks a stretch of the prediction path in that trace (a
  ``record_function`` of the profiler's own clock, so a span lines up with
  the card's activity it launches). It enters ``record_function`` only
  while a profiler records; otherwise a span costs one check. With a
  ``timings`` dict it also adds its host-clock seconds to one key: the
  stage times ``timings_s`` of ``predict_instances`` are these spans;
- :func:`device_sync` waits for the card's work on every CUDA tensor of a
  nested list, tuple or dict and returns the tree;
- :class:`Timer` measures wall time around device work with that sync.

The spans of one ``predict_instances`` call (``predict``, ``predict_sparse``
have their own roots), each inside the root and closed before any yield
of the prediction generators, so a caller-driven generator records its
stages but no root:

- ``stardist.predict_instances``, the root, around the whole call;
- ``stardist.prepare``: the host's set-up (axes, zoom, normalizer,
  padding; on each side of the generator's ``"predict"`` step);
- ``stardist.forward`` (``timings_s["forward"]``; one per tile in tiled
  calls), with ``stardist.upload``, the input's copy to the card, and in
  a ResNet (``models/unet.py``; its training forward records them too)
  ``stardist.forward.stem`` (the 7^3 and 3^3 stem convs), one
  ``stardist.forward.block`` per residual block (its convs, their pads,
  the shortcut and the add) and ``stardist.forward.head`` (the feature
  conv and the fused heads): they name the forward's idle gaps and show
  which launches are cuDNN's; the U-Net's forward has no sub-spans;
- ``stardist.extract`` (``timings_s["extract"]``), the candidates;
- ``stardist.nms`` (``timings_s["nms"]``) with ``stardist.nms.sort``,
  ``.geometry`` (areas or volumes, boxes), ``.pairs`` (the pairs whose
  boxes meet), ``.bounds``, one ``.round`` per greedy round with a
  ``.fixpoint`` for each fixpoint and the exact test, ``.cascade`` (2D,
  the pair kernel) or ``.exact`` (3D, the lattice test; its seconds are
  ``nms_counters["exact_s"]``); in 3D one ``.block`` per block of rows
  around its pairs, bounds and rounds;
- ``stardist.raster`` (``timings_s["raster"]``) with
  ``stardist.raster.draw``, ``.fetch`` (the labels to the host),
  ``.astype`` (2D's int32 copy) and ``.details`` (the survivors to the
  host); in 3D (``ops/rasterize.py::rasterize_polyhedra``), inside
  ``.draw``, ``stardist.raster.inside``: on the card one per call (the
  face geometry and the one launch of ``csrc/raster_polyhedra.cu``, ended
  by a sync, so its host time holds the draw's device time); on the CPU
  one per chunk of polyhedra (the face geometry, the inside test, the
  in-image mask and the masked selections), each followed by a
  ``stardist.raster.scatter`` (the scatter-max and the count's
  scatter-add), which only the CPU's chunks record.

A host sync has no span of its own: the profiler records the CUDA
runtime's ``cudaStreamSynchronize`` (and device and event syncs), and the
innermost span around one is its site.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.profiler import record_function

_recording = torch._C._autograd._profiler_enabled   # whether a torch profiler records


@contextlib.contextmanager
def trace(logdir, create_perfetto_link=False):
    """Profile a region with torch.profiler; the trace is written to
    ``logdir/trace_<ns>.pt.trace.json`` when the region ends (and its
    path printed with ``create_perfetto_link``, to open in Perfetto).

    >>> with trace("/tmp/torch-trace"):
    ...     model.predict_instances(img)
    """
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = logdir / f"trace_{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    if create_perfetto_link:
        print(f"trace written to {path}; open it at https://ui.perfetto.dev")


class span:
    """A named stretch of the prediction path (a context manager): a
    ``record_function(name)`` in the trace while a torch profiler records,
    nothing but that check otherwise. With ``timings`` (a dict) its
    host-clock seconds are added to ``timings[key]``.

    >>> t = {}
    >>> with span("stardist.forward", t, "forward"):
    ...     outs = model.net(x)
    """

    __slots__ = ("name", "timings", "key", "_rf", "_t0")

    def __init__(self, name, timings=None, key=None):
        self.name, self.timings, self.key = name, timings, key

    def __enter__(self):
        self._rf = record_function(self.name).__enter__() if _recording() else None
        if self.timings is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timings is not None:
            self.timings[self.key] = (self.timings.get(self.key, 0.0)
                                      + time.perf_counter() - self._t0)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def device_sync(tree):
    """Wait for the device work of every CUDA tensor in ``tree`` (nested
    lists, tuples and dicts); returns ``tree``."""
    devices = {t.device for t in _leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


class Timer:
    """Wall-clock timer with device sync; accumulates named laps.

    >>> t = Timer()
    >>> with t("forward") as box:
    ...     box.append(model.net(x))
    >>> t.laps  # {"forward": [0.0123]}
    """

    def __init__(self):
        self.laps = {}

    @contextlib.contextmanager
    def __call__(self, tag, sync=None):
        t0 = time.perf_counter()
        box = []
        try:
            yield box
        finally:
            if box:
                device_sync(box)
            elif sync is not None:
                device_sync(sync)
            self.laps.setdefault(tag, []).append(time.perf_counter() - t0)

    def total(self, tag):
        return sum(self.laps.get(tag, []))

    def report(self):
        return {k: (len(v), sum(v)) for k, v in self.laps.items()}
