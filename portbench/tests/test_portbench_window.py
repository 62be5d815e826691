"""The window's arithmetic: whole calls, a stall counted, the tail over
every call."""
import numpy as np
import pytest

from portbench import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run(durations, seconds, fail=(), first=0):
    clock = Clock()
    seen = []

    def call(item):
        k = len(seen)
        seen.append(item)
        clock.t += durations[k]
        if k in fail:
            raise RuntimeError("broken")
        return 3, {"forward": durations[k] / 2}, None
    return window.closed_loop(call, 2, seconds, lambda: None, clock=clock, first=first), seen


def test_whole_calls_until_the_deadline():
    calls, seen = run([1.0] * 10, 3.5)
    assert len(calls) == 4                      # starts at 0, 1, 2, 3 s; the 4th ends at 4 s
    assert seen == [0, 1, 0, 1]
    assert window.span(calls) == pytest.approx(4.0)
    assert window.rate(calls, 2.0) == pytest.approx(4 * 2.0 / 4.0)


def test_a_second_part_goes_on_with_the_next_item():
    calls, seen = run([1.0] * 10, 1.5, first=3)
    assert seen == [1, 0] and [c.item for c in calls] == [1, 0]


def test_a_stall_counts():
    calls, _ = run([1.0, 1.0, 5.0, 1.0, 1.0], 3.5)
    assert len(calls) == 3                      # the stalled call ends at 7 s
    assert window.rate(calls, 1.0) == pytest.approx(3 / 7.0)
    assert window.p95_ms(calls) == pytest.approx(np.percentile([1, 1, 5], 95) * 1e3)


def test_p95_over_every_call_and_failures():
    durations = [0.01] * 99 + [1.0]
    calls, _ = run(durations, 1.5, fail={3})
    assert len(calls) == 100
    assert sum(c.n_objects < 0 for c in calls) == 1
    assert window.p95_ms(calls) == pytest.approx(np.percentile(durations, 95) * 1e3)
    assert window.rate(calls, 1.0) == pytest.approx(99 / window.span(calls))
    assert window.stage_ms(calls, "forward") == pytest.approx(
        np.mean([d / 2 for k, d in enumerate(durations) if k != 3]) * 1e3)
    assert window.stage_ms(calls, "nms") is None
