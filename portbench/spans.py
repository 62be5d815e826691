"""The program's spans in a traced window: the ``stardist.*`` ranges that
stardist_torch opens with ``record_function`` while a profiler records
(``stardist_torch/core/profiling.py``), read from the ``Trace``'s host
events, per completed call of the traced part. Every reader returns None
where the trace holds no such span (a program without them, or a path
that does not run the stage)."""
from __future__ import annotations

import bisect

from portbench.trace import union

ROOT = "stardist.predict_instances"
PREFIX = "stardist."
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def merged(trace, match):
    """The union of the host events for which ``match(name)`` holds,
    clipped to the window: [start, end] lists in time order."""
    return union([(s, e) for n, s, e in trace.host if match(n)], trace.lo, trace.hi)


def covered(intervals, starts, lo, hi):
    """Seconds of [lo, hi] that the ordered, disjoint ``intervals`` (their
    starts ``starts``) cover."""
    total, k = 0.0, max(bisect.bisect_right(starts, lo) - 1, 0)
    while k < len(intervals) and intervals[k][0] < hi:
        s, e = intervals[k]
        total += max(0.0, min(e, hi) - max(s, lo))
        k += 1
    return total


def _calls(ctx):
    n = ctx.done(ctx.traced) if ctx.trace is not None else 0
    return n or None


def span_ms(ctx, name):
    """Milliseconds per call inside spans ``name``."""
    n = _calls(ctx)
    spans = merged(ctx.trace, lambda x: x == name) if n else []
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / n


def syncs_in(ctx, name):
    """(count, milliseconds) per call of the CUDA runtime's sync events
    that start inside spans ``name``."""
    n = _calls(ctx)
    spans = merged(ctx.trace, lambda x: x == name) if n else []
    if not spans:
        return None
    starts = [s for s, _ in spans]
    count, seconds = 0, 0.0
    for x, s, e in ctx.trace.host:
        if x in SYNCS:
            k = bisect.bisect_right(starts, s) - 1
            if k >= 0 and s < spans[k][1]:
                count += 1
                seconds += e - s
    return count / n, 1e3 * seconds / n


def self_ms(ctx, root=ROOT):
    """Milliseconds per call of the root spans that no other program span
    covers: the call's host time outside every stage."""
    n = _calls(ctx)
    roots = merged(ctx.trace, lambda x: x == root) if n else []
    if not roots:
        return None
    inner = merged(ctx.trace, lambda x: x.startswith(PREFIX) and x != root)
    starts = [s for s, _ in inner]
    return 1e3 * sum(e - s - covered(inner, starts, s, e) for s, e in roots) / n
