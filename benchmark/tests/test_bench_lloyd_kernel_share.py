"""The reader of ``lloyd_kernel_share``: the share of the window's Lloyd
assignment passes (``lloyd_rounds`` + 1 a fit) that the program counted on K1,
and nothing to read from a program without that path (whose store never holds
the counter) or from a window without Lloyd."""

import sys
import types
from collections import Counter, deque

from lib import cells

METRICS = "flgp_tpu_torch.utils.metrics"
KMEANS = "flgp_tpu_torch.ops.kmeans"


def _program(monkeypatch, fits, kernel_path: bool):
    metrics = types.ModuleType(METRICS)
    metrics.FIT_COUNTS = deque(Counter(f) for f in fits)
    monkeypatch.setitem(sys.modules, METRICS, metrics)
    kmeans = types.ModuleType(KMEANS)
    if kernel_path:
        kmeans.assign_on_kernel = lambda device_type, dtype, d: True
    monkeypatch.setitem(sys.modules, KMEANS, kmeans)


def _run(window: int):
    return types.SimpleNamespace(fit_spans=[{}] * window, trace=object())


def _fit(rounds, kernel):
    return dict(lloyd_rounds=rounds, lloyd_kernel_rounds=kernel)


# the warm-up, two window fits, the profiled fit
KERNEL_FITS = [_fit(100, 101), _fit(100, 101), _fit(56, 57), _fit(2, 3)]


def test_every_pass_on_the_kernel_reads_100_whatever_the_rounds(monkeypatch):
    _program(monkeypatch, KERNEL_FITS, kernel_path=True)
    assert cells.reader("lloyd_kernel_share").read(_run(2)) == 100.0


def test_reads_the_share_over_the_window_and_zero_where_never_counted(monkeypatch):
    _program(monkeypatch, [_fit(100, 101), _fit(100, 101), _fit(60, 0), _fit(2, 3)],
             kernel_path=True)
    assert cells.reader("lloyd_kernel_share").read(_run(2)) == 100.0 * 101 / 162
    _program(monkeypatch, [_fit(78, 0), _fit(78, 0), _fit(54, 0), _fit(9, 0)], kernel_path=True)
    assert cells.reader("lloyd_kernel_share").read(_run(2)) == 0.0


def test_nothing_to_read_from_a_program_without_the_kernel_path(monkeypatch):
    _program(monkeypatch, KERNEL_FITS, kernel_path=False)
    assert cells.reader("lloyd_kernel_share").read(_run(2)) is None
    monkeypatch.delitem(sys.modules, KMEANS)
    assert cells.reader("lloyd_kernel_share").read(_run(2)) is None


def test_nothing_to_read_from_a_window_without_lloyd(monkeypatch):
    _program(monkeypatch, [{}, {"fits": 1}, {"fits": 1}], kernel_path=True)
    assert cells.reader("lloyd_kernel_share").read(_run(1)) is None


def test_the_program_has_the_kernel_path_the_reader_looks_for():
    from flgp_tpu_torch.ops import kmeans

    assert sys.modules[KMEANS] is kmeans and callable(kmeans.assign_on_kernel)
