"""Reading a profiler trace: device activities onto the host's clock, the busy
union, the idle gaps, and the activities a span launched."""

import pytest

from lib import trace as T

# a fit span of 100 µs on the host, a predict span inside it, two launches; the
# device's clock runs 1000 µs ahead, and its activities come out of launch order
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "span:fit", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "span:predict", "ts": 50, "dur": 40},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 1,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 60, "dur": 1,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "b_second", "ts": 1062, "dur": 10,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "a_first", "ts": 1012, "dur": 20,
     "args": {"correlation": 1}},
]


def _trace():
    acts, spans, ops = T._parse(EVENTS)
    offset = min(a.start - a.launched for a in acts)
    acts = [a._replace(start=a.start - offset, end=a.end - offset) for a in acts]
    return T.Trace(acts, spans, ops, spans.pop("fit")[0], {})


def test_busy_idle_and_launches():
    tr = _trace()
    assert T.busy_seconds(tr) == pytest.approx(30e-6)
    assert [a.name for a in T.launched_in(tr, ["predict"])] == ["b_second"]
    gaps = T.breakdown(tr)["idle_gaps"]
    assert sorted(round(g[1] * 1e6) for g in gaps) == [10, 30, 30]
    assert [g[0].split(":")[0] for g in gaps if round(g[1] * 1e6) == 30] == ["outside spans",
                                                                             "predict"]
