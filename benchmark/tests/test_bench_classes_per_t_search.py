"""The reader of ``classes_per_t_search``: the window's ``t_search_problems``
over its ``t_searches``; nothing to read from a program that counts no
t-search."""

import sys
import types
from collections import Counter, deque

import pytest

from jobs.fit import Run
from lib import cells

METRICS = "flgp_tpu_torch.utils.metrics"


def _program(monkeypatch, fits):
    metrics = types.ModuleType(METRICS)
    metrics.FIT_COUNTS = deque(Counter(f) for f in fits)
    monkeypatch.setitem(sys.modules, METRICS, metrics)


def _run(window: int):
    run = Run()
    run.fit_spans, run.trace = [{}] * window, object()
    return run


def _fit(searches, problems):
    return {"t_searches": searches, "t_search_problems": problems, "newton_rounds": 60}


@pytest.mark.parametrize("classes", [1, 10])
def test_one_search_a_fit_reads_its_classes(monkeypatch, classes):
    # the warm-up, two window fits, the profiled fit
    _program(monkeypatch, [_fit(1, classes)] * 4)
    assert cells.reader("classes_per_t_search").read(_run(2)) == float(classes)


def test_a_search_a_class_reads_one(monkeypatch):
    """Ten classes searched one at a time, as a program without the problem
    axis would if it counted its searches."""
    _program(monkeypatch, [_fit(10, 10)] * 4)
    assert cells.reader("classes_per_t_search").read(_run(2)) == 1.0


def test_a_grid_of_searches_reads_the_mean(monkeypatch):
    _program(monkeypatch, [_fit(1, 10), _fit(3, 30), _fit(1, 1), _fit(1, 10)])
    assert cells.reader("classes_per_t_search").read(_run(2)) == 31 / 4


def test_nothing_to_read_without_the_counter(monkeypatch):
    _program(monkeypatch, [{"newton_rounds": 500, "host_syncs": 900}] * 4)
    assert cells.reader("classes_per_t_search").read(_run(2)) is None
    monkeypatch.delitem(sys.modules, METRICS)
    assert cells.reader("classes_per_t_search").read(_run(2)) is None


def test_the_program_counts_what_the_reader_reads():
    import torch

    from flgp_tpu_torch.inference.optimize import minimize_1d_log
    from flgp_tpu_torch.utils import metrics

    before = Counter(metrics.COUNTS)
    minimize_1d_log(lambda x, rows: (torch.log(x) - 1.0) ** 2, dtype=torch.float64,
                    device="cpu", problems=3)
    got = Counter(metrics.COUNTS) - before
    assert (got["t_searches"], got["t_search_problems"]) == (1, 3)
