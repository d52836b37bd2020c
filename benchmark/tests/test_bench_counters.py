"""The readers of the program's counters: the mean a fit over the traced
window's fits, and nothing to read from a program without the store."""

import sys
import types
from collections import Counter, deque

import pytest

from lib import cells

READERS = {"lloyd_rounds": "lloyd_rounds", "newton_rounds": "newton_rounds",
           "pg_rounds": "pg_rounds", "host_syncs.fit": "host_syncs"}
MODULE = "flgp_tpu_torch.utils.metrics"


def _program(monkeypatch, fits):
    """A stand-in for the program's metrics module whose last fits counted
    ``fits``, oldest first."""
    mod = types.ModuleType(MODULE)
    mod.FIT_COUNTS = deque(Counter(f) for f in fits)
    monkeypatch.setitem(sys.modules, MODULE, mod)
    return mod


def _run(window: int, traced: bool):
    """A job's run whose window held ``window`` fits; ``traced``: a profiled
    fit ran after them."""
    return types.SimpleNamespace(fit_spans=[{}] * window, trace=object() if traced else None)


# the warm-up, three window fits, the profiled fit
FITS = [dict(lloyd_rounds=100, newton_rounds=900, pg_rounds=70, host_syncs=999),
        dict(lloyd_rounds=2, newton_rounds=6, pg_rounds=1, host_syncs=10),
        dict(lloyd_rounds=3, newton_rounds=9, pg_rounds=2, host_syncs=14),
        dict(lloyd_rounds=4, newton_rounds=9, pg_rounds=3, host_syncs=15, **{"kernel_launches:knn": 6}),
        dict(lloyd_rounds=50, newton_rounds=500, pg_rounds=40, host_syncs=777)]


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_counter_reads_as_its_mean_over_the_window(metric, monkeypatch):
    _program(monkeypatch, FITS)
    want = {"lloyd_rounds": 3.0, "newton_rounds": 8.0, "pg_rounds": 2.0, "host_syncs": 13.0}
    assert cells.reader(metric).read(_run(3, traced=True)) == want[READERS[metric]]
    _program(monkeypatch, FITS[:4])                      # no profiled fit (no card)
    assert cells.reader(metric).read(_run(3, traced=False)) == want[READERS[metric]]


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_counter_never_counted_reads_zero(metric, monkeypatch):
    _program(monkeypatch, [{}, {"fits": 1}, {"fits": 1}])
    assert cells.reader(metric).read(_run(2, traced=False)) == 0.0


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_to_read_without_the_store_or_a_fit(metric, monkeypatch):
    mod = _program(monkeypatch, FITS)
    del mod.FIT_COUNTS                                   # an earlier program: no store
    assert cells.reader(metric).read(_run(3, traced=True)) is None
    _program(monkeypatch, FITS)                          # no fit in the window
    assert cells.reader(metric).read(_run(0, traced=True)) is None
    monkeypatch.delitem(sys.modules, MODULE)             # the program not loaded
    assert cells.reader(metric).read(_run(3, traced=True)) is None


def test_the_program_feeds_the_store_the_readers_read():
    import torch

    from flgp_tpu_torch.ops import kmeans
    from flgp_tpu_torch.utils import metrics

    before = Counter(metrics.COUNTS)
    X = torch.tensor([[0.0], [1.0], [10.0], [11.0]], dtype=torch.float64)
    kmeans.lloyd(X, X[:2].clone())
    assert metrics.COUNTS["lloyd_rounds"] - before["lloyd_rounds"] == 3
    assert metrics.COUNTS["host_syncs"] - before["host_syncs"] == 3
    assert sys.modules[MODULE] is metrics


def test_each_fit_appends_its_own_counts():
    from flgp_tpu_torch.utils import metrics

    @metrics.fit_entry
    def inner():
        metrics.count("lloyd_rounds", 2)

    @metrics.fit_entry
    def outer(fail):
        metrics.count("lloyd_rounds", 3)
        inner()
        if fail:
            raise RuntimeError("a failed fit")

    n = len(metrics.FIT_COUNTS)
    outer(False)
    with pytest.raises(RuntimeError):
        outer(True)
    last = list(metrics.FIT_COUNTS)[-2:]
    assert len(metrics.FIT_COUNTS) == min(n + 2, metrics.FIT_COUNTS.maxlen)
    assert last == [Counter(fits=2, lloyd_rounds=5)] * 2
