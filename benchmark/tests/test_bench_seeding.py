"""The readers of the seeding's metrics: ``seeding_s``, the synced span around
``ops/kmeans.py:_kmeanspar_rows``, and ``seeding_kernel_share``, the share of the
window's weighted k-means++ reductions (``seedings``) that the program launched on
its CUDA kernel (``kernel_launches:weighted_kmeanspp``); nothing to read from a
program without that path or from a window that seeded nothing."""

import sys
import types
from collections import Counter, deque

import pytest

from jobs.fit import Run
from lib import cells, probe

METRICS = "flgp_tpu_torch.utils.metrics"
KMEANS = "flgp_tpu_torch.ops.kmeans"


def _program(monkeypatch, fits, kernel_path: bool):
    metrics = types.ModuleType(METRICS)
    metrics.FIT_COUNTS = deque(Counter(f) for f in fits)
    monkeypatch.setitem(sys.modules, METRICS, metrics)
    kmeans = types.ModuleType(KMEANS)
    if kernel_path:
        kmeans.seed_on_kernel = lambda device_type, dtype, C: True
    monkeypatch.setitem(sys.modules, KMEANS, kmeans)


def _run(window: int, spans=None):
    run = Run()
    run.fit_spans, run.trace = spans or [{}] * window, object()
    return run


def _fit(seedings, kernel):
    return {"seedings": seedings, "kernel_launches:weighted_kmeanspp": kernel}


# the warm-up, two window fits, the profiled fit
KERNEL_FITS = [_fit(1, 1), _fit(1, 1), _fit(1, 1), _fit(1, 1)]


def test_every_seeding_on_the_kernel_reads_100(monkeypatch):
    _program(monkeypatch, KERNEL_FITS, kernel_path=True)
    assert cells.reader("seeding_kernel_share").read(_run(2)) == 100.0


def test_a_mixed_window_reads_its_share(monkeypatch):
    _program(monkeypatch, [_fit(1, 0), _fit(1, 1), _fit(3, 0), _fit(1, 1)], kernel_path=True)
    assert cells.reader("seeding_kernel_share").read(_run(2)) == 100.0 * 1 / 4


def test_no_seeding_on_the_kernel_reads_zero(monkeypatch):
    _program(monkeypatch, [_fit(1, 0)] * 4, kernel_path=True)
    assert cells.reader("seeding_kernel_share").read(_run(2)) == 0.0
    _program(monkeypatch, [{"seedings": 1}] * 4, kernel_path=True)   # no launch counter at all
    assert cells.reader("seeding_kernel_share").read(_run(2)) == 0.0


def test_nothing_to_read_from_a_program_without_the_predicate(monkeypatch):
    _program(monkeypatch, [{"lloyd_rounds": 100}] * 4, kernel_path=False)
    assert cells.reader("seeding_kernel_share").read(_run(2)) is None
    monkeypatch.delitem(sys.modules, KMEANS)
    assert cells.reader("seeding_kernel_share").read(_run(2)) is None


def test_nothing_to_read_from_a_window_that_seeded_nothing(monkeypatch):
    _program(monkeypatch, [{}, {"fits": 1}, {"fits": 1}], kernel_path=True)
    assert cells.reader("seeding_kernel_share").read(_run(1)) is None


@pytest.mark.parametrize("spans,mean", [([{"seeding": 0.02, "subsample": 0.2},
                                          {"seeding": 0.04, "subsample": 0.3}], 0.03),
                                        ([{"subsample": 0.2}], None)])
def test_seeding_s_reads_the_span_s_mean_over_the_window(spans, mean):
    got = cells.reader("seeding_s").read(_run(len(spans), spans))
    assert got == pytest.approx(mean) if mean is not None else got is None


def test_the_program_has_what_the_readers_look_for():
    """The span wraps a function the program has, which ``kmeans`` looks up at
    each call (so the span sees every seeding), and the predicate is there."""
    from flgp_tpu_torch.ops import kmeans

    assert probe.span_table()["seeding"] == [(KMEANS, "_kmeanspar_rows")]
    assert sys.modules[KMEANS] is kmeans and callable(kmeans.seed_on_kernel)
    assert callable(kmeans._kmeanspar_rows)


def test_the_span_times_the_k_means_seeding_kmeans_calls():
    """With the spans installed, ``kmeans``'s k-means‖ seeding runs inside the
    ``seeding`` span and its k-means++ seeding does not; the function is the
    program's own again once they are removed."""
    import torch

    from flgp_tpu_torch.ops import kmeans

    own = kmeans._kmeanspar_rows
    spans = probe.Spans(synced=True, device=torch.device("cpu"))
    X = torch.randn((1200, 2), generator=torch.Generator().manual_seed(0))
    with spans.installed():
        kmeans.kmeans(torch.Generator().manual_seed(1), X, 64, iters=2, init="kmeans++")
        assert "seeding" not in spans.seconds
        kmeans.kmeans(torch.Generator().manual_seed(1), X, 64, iters=2, init="kmeans||")
    assert set(spans.seconds) == {"seeding"} and spans.seconds["seeding"] > 0
    assert kmeans._kmeanspar_rows is own
