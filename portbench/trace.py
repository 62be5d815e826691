"""Reading a torch.profiler trace of the window: the device's busy time
(the union of its kernels, copies and sets), its idle gaps named by what
the host was doing, and the device time of each kernel by name."""
from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "portbench.window"
CALL = "portbench.call"


def union(intervals, lo, hi):
    """Merged (start, end) of ``intervals`` clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(merged, lo, hi):
    """The stretches of [lo, hi] that ``merged`` leaves uncovered."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def name_gaps(idle, host, scan=200):
    """Seconds of idle time by the innermost host event (name, start, end)
    running at each gap's midpoint ("no op" where none is found)."""
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    total = defaultdict(float)
    for s, e in idle:
        mid = 0.5 * (s + e)
        k = bisect.bisect_right(starts, mid) - 1
        name = "no op"
        for h in host[max(0, k - scan):k + 1][::-1]:
            if h[2] >= mid:
                name = h[0]
                break
        total[name] += e - s
    return total


class Trace:
    """``events``: (name, is_device, start, end) with times in seconds."""

    def __init__(self, events):
        windows = [(s, e) for n, dev, s, e in events if n == WINDOW and not dev]
        if not windows:
            raise ValueError("the trace holds no window span")
        self.lo, self.hi = windows[0]
        self.device = [(n, s, e) for n, dev, s, e in events if dev]
        self.host = [(n, s, e) for n, dev, s, e in events
                     if not dev and n not in (WINDOW, CALL)]
        self.merged = union([(s, e) for _, s, e in self.device], self.lo, self.hi)

    @classmethod
    def from_profiler(cls, prof):
        """From the profiler's raw events (the device's user annotations,
        the GPU twins of ``record_function`` spans, left out)."""
        from torch.autograd import DeviceType
        events = []
        for e in prof.profiler.kineto_results.events():
            dev = e.device_type() == DeviceType.CUDA
            if dev and (e.is_user_annotation() or e.name().startswith("portbench.")):
                continue
            s = e.start_ns() * 1e-9
            events.append((e.name(), dev, s, s + e.duration_ns() * 1e-9))
        return cls(events)

    @property
    def window_s(self):
        return self.hi - self.lo

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.merged)

    def kernel_s(self, match):
        """Device seconds of the events whose name contains ``match``."""
        return sum(min(e, self.hi) - max(s, self.lo) for n, s, e in self.device
                   if match in n and e > self.lo and s < self.hi)

    def summary(self):
        """A line on the trace's device events and the port's kernels."""
        if not self.device:
            return "trace: no device events"
        first = min(s for _, s, _ in self.device) - self.lo
        last = max(e for _, _, e in self.device) - self.hi
        kernels = ", ".join(f"{k} {self.kernel_s(k):.6f} s" for k in
                            ("conv_kernel", "pair_kernel", "raster_kernel"))
        return (f"trace: {len(self.device)} device events, the first {first:.3f} s after the "
                f"window's start, the last {last:.3f} s after its end, "
                f"{sum(e - s for _, s, e in self.device):.3f} s in all; {kernels}")

    def top_device_ops(self, n=10):
        total = defaultdict(float)
        for name, s, e in self.device:
            if e > self.lo and s < self.hi:
                total[name] += min(e, self.hi) - max(s, self.lo)
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]

    def top_idle(self, n=10):
        idle = gaps(self.merged, self.lo, self.hi)
        total = name_gaps(idle, self.host)
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]
