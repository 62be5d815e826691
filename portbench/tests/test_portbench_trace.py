"""The idle share is the window less the union of the device intervals;
idle gaps are named by the innermost host event at their midpoint."""
import pytest

from portbench.trace import CALL, WINDOW, Trace, gaps, name_gaps, union


def test_union_and_gaps():
    merged = union([(1, 3), (2, 4), (6, 7), (-1, 0.5), (9, 12)], 0, 10)
    assert merged == [[0, 0.5], [1, 4], [6, 7], [9, 10]]
    assert gaps(merged, 0, 10) == [(0.5, 1), (4, 6), (7, 9)]


def test_trace_busy_idle_and_names():
    ev = [(WINDOW, False, 0.0, 10.0), (CALL, False, 0.0, 10.0),
          ("kern_a", True, 1.0, 3.0), ("kern_b", True, 2.0, 4.0),
          ("conv_kernel<1>", True, 6.0, 7.0),
          ("kern_a", True, 9.5, 11.0),
          ("aten::nonzero", False, 3.5, 6.5), ("cudaStreamSynchronize", False, 4.5, 5.5),
          ("aten::item", False, 7.0, 9.6)]
    tr = Trace(ev)
    assert tr.window_s == 10.0
    assert tr.busy_s == pytest.approx(3.0 + 1.0 + 0.5)
    assert tr.kernel_s("conv_kernel") == pytest.approx(1.0)
    assert tr.top_device_ops()[0] == ["kern_a", pytest.approx(2.5)]
    idle = dict((k, v) for k, v in tr.top_idle())
    assert idle == {"cudaStreamSynchronize": pytest.approx(2.0), "aten::item": pytest.approx(2.5),
                    "no op": pytest.approx(1.0)}


def test_name_gaps_innermost():
    total = name_gaps([(0, 2)], [("outer", 0, 5), ("inner", 0.5, 1.5), ("later", 3, 4)])
    assert dict(total) == {"inner": 2}
