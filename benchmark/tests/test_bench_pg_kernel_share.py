"""The reader of ``pg_kernel_share``: the share of the window's Pólya-Gamma
draws (``pg_draws``) that the program launched on its CUDA kernel
(``kernel_launches:polya_gamma``), and nothing to read from a program
without that path or from a window that drew nothing."""

import sys
import types
from collections import Counter, deque

from lib import cells

METRICS = "flgp_tpu_torch.utils.metrics"
PG = "flgp_tpu_torch.ops.polya_gamma"


def _program(monkeypatch, fits, kernel_path: bool):
    metrics = types.ModuleType(METRICS)
    metrics.FIT_COUNTS = deque(Counter(f) for f in fits)
    monkeypatch.setitem(sys.modules, METRICS, metrics)
    pg = types.ModuleType(PG)
    if kernel_path:
        pg.pg_on_kernel = lambda device_type, dtype: True
    monkeypatch.setitem(sys.modules, PG, pg)


def _run(window: int):
    return types.SimpleNamespace(fit_spans=[{}] * window, trace=object())


def _fit(draws, kernel):
    return {"pg_draws": draws, "kernel_launches:polya_gamma": kernel}


# the warm-up, two window fits, the profiled fit
KERNEL_FITS = [_fit(50, 50), _fit(50, 50), _fit(50, 50), _fit(50, 50)]


def test_every_draw_on_the_kernel_reads_100(monkeypatch):
    _program(monkeypatch, KERNEL_FITS, kernel_path=True)
    assert cells.reader("pg_kernel_share").read(_run(2)) == 100.0


def test_a_mixed_window_reads_its_share(monkeypatch):
    _program(monkeypatch, [_fit(50, 0), _fit(50, 50), _fit(150, 0), _fit(50, 50)],
             kernel_path=True)
    assert cells.reader("pg_kernel_share").read(_run(2)) == 100.0 * 50 / 200


def test_no_draw_on_the_kernel_reads_zero(monkeypatch):
    _program(monkeypatch, [_fit(50, 0), _fit(50, 0), _fit(50, 0), _fit(50, 0)],
             kernel_path=True)
    assert cells.reader("pg_kernel_share").read(_run(2)) == 0.0
    # a program that counts draws but never launches: no launch counter at all
    _program(monkeypatch, [{"pg_draws": 50}] * 4, kernel_path=True)
    assert cells.reader("pg_kernel_share").read(_run(2)) == 0.0


def test_nothing_to_read_from_a_program_without_the_predicate(monkeypatch):
    _program(monkeypatch, [{"pg_rounds": 570}] * 4, kernel_path=False)
    assert cells.reader("pg_kernel_share").read(_run(2)) is None
    monkeypatch.delitem(sys.modules, PG)
    assert cells.reader("pg_kernel_share").read(_run(2)) is None


def test_nothing_to_read_from_a_window_that_drew_nothing(monkeypatch):
    _program(monkeypatch, [{}, {"fits": 1}, {"fits": 1}], kernel_path=True)
    assert cells.reader("pg_kernel_share").read(_run(1)) is None


def test_the_program_has_the_predicate_the_reader_looks_for():
    from flgp_tpu_torch.ops import polya_gamma

    assert sys.modules[PG] is polya_gamma and callable(polya_gamma.pg_on_kernel)
