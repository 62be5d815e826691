"""The measured window: a closed loop of whole calls, and its arithmetic.

A run starts calls until ``seconds`` have passed; the window ends when the
last call that started before that deadline returns. A rate is the work of
all the window's calls over the time from the first call's start to the
last call's end, so a stall inside the window counts; a tail is the tail of
all the calls' latencies.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Call:
    start: float
    end: float
    item: int                 # which input of the mix
    n_objects: int = -1       # survivors of the call; -1 for a failed call
    timings: dict = field(default_factory=dict)

    @property
    def seconds(self):
        return self.end - self.start


def closed_loop(call, n_items, seconds, sync, keep=None, clock=time.perf_counter, first=0):
    """Calls ``call(item)`` on items first, first + 1, ... modulo n_items
    one at a time, each ended by ``sync()``, until ``seconds`` have passed
    since the first started. ``call`` returns (n_objects, timings, output);
    ``keep(i, item, output)`` sees each output. A call that raises counts
    as failed. Returns the calls."""
    calls, t0, i = [], None, first
    while True:
        start = clock()
        if t0 is None:
            t0 = start
        elif start - t0 >= seconds:
            return calls
        item = i % n_items
        try:
            n, timings, out = call(item)
            sync()
        except Exception as exc:                      # counted, reported, judged
            print(f"call {i} on item {item} failed: {exc!r}", flush=True)
            calls.append(Call(start, clock(), item))
        else:
            calls.append(Call(start, clock(), item, int(n), dict(timings)))
            if keep is not None:
                keep(i, item, out)
        i += 1


def span(calls):
    """Seconds from the first call's start to the last call's end."""
    return calls[-1].end - calls[0].start


def rate(calls, work_per_call):
    """Work of the completed calls per second of the window."""
    done = sum(1 for c in calls if c.n_objects >= 0)
    return done * work_per_call / span(calls)


def p95_ms(calls):
    """The 95th percentile of all the calls' latencies, failed ones too."""
    return float(np.percentile([c.seconds for c in calls], 95) * 1e3)


def stage_ms(calls, stage):
    """Mean milliseconds of a stage of ``timings`` per call (the sum over
    the calls that report it over their count), or None."""
    vals = [c.timings[stage] for c in calls if stage in c.timings]
    return float(np.mean(vals) * 1e3) if vals else None
