"""The device's idle seconds inside one span of a profiled fit."""

import pytest

from lib import cells
from lib import trace as T
from lib.idle import idle_seconds

# a fit of 100 µs: the train span [10, 40] holds one idle gap, [25, 30]; the
# predict span [60, 90] and a nested call of it [70, 80]; the idle gap
# [40, 60] lies outside every span; the device runs [0, 25], [30, 50]
# (launched inside train) and [60, 100]
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "span:fit", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "span:train", "ts": 10, "dur": 30},
    {"ph": "X", "cat": "user_annotation", "name": "span:predict", "ts": 60, "dur": 30},
    {"ph": "X", "cat": "user_annotation", "name": "span:predict", "ts": 70, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 25},
    {"ph": "X", "cat": "kernel", "name": "b", "ts": 30, "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 35, "dur": 5},
    {"ph": "X", "cat": "kernel", "name": "d", "ts": 60, "dur": 40},
]


def _run():
    acts, spans, ops = T._parse(EVENTS)
    trace = T.Trace(acts, spans, ops, spans.pop("fit")[0], {})
    return type("Run", (), {"trace": trace, "fit_spans": []})()


def test_idle_inside_a_span_and_none_outside_it():
    run = _run()
    assert idle_seconds(run.trace, "train") == pytest.approx(5e-6)
    assert idle_seconds(run.trace, "predict") == pytest.approx(0.0, abs=1e-12)
    assert idle_seconds(run.trace, "subsample") is None


@pytest.mark.parametrize("layer,want", [("subsample", None), ("train", 5e-6), ("predict", 0.0)])
def test_each_reader_reads_its_span(layer, want):
    value = cells.reader(f"device_idle_s.{layer}").read(_run())
    assert value == (None if want is None else pytest.approx(want, abs=1e-12))


@pytest.mark.parametrize("layer", ["subsample", "train", "predict"])
def test_nothing_to_read_without_a_trace(layer):
    run = type("Run", (), {"trace": None, "fit_spans": []})()
    assert cells.reader(f"device_idle_s.{layer}").read(run) is None
