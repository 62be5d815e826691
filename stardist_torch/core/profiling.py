"""Profiling helpers: a torch.profiler trace context and device-synced
timing (the counterpart of stardist_tpu/core/profiling.py).

- :func:`trace` records a region with ``torch.profiler`` (the host's
  activity, and the card's where CUDA is available) and writes it as a
  Chrome trace into ``logdir``, a file that TensorBoard's profiler plugin
  and Perfetto (ui.perfetto.dev) both open;
- :func:`device_sync` waits for the card's work on every CUDA tensor of a
  nested list, tuple or dict and returns the tree;
- :class:`Timer` measures wall time around device work with that sync.

Per-stage counters of a prediction are separate: ``predict_instances``
returns them in its details (``timings_s``, ``nms_counters``).
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


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
