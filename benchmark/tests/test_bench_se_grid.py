"""The SE-grid regression cell: its files found by name, its frozen data
generator, its readers, and whole runs of its job on the CPU at a small shape
with the timed path sound and broken underneath, and its control."""

import copy
import sys
import time
import types
from collections import Counter, deque

import numpy as np
import pytest
import torch

from conftest import bench_json
from lib import cells
from lib import trace as T

CELL = "spiral1e5.se_grid"
CPU = torch.device("cpu")
SEED = 2**31 + 977
MODULE = "flgp_tpu_torch.utils.metrics"
NEW_READERS = ["grid_spectra_s", "gpr_train_s", "gpr_predict_s", "adam_steps",
               "device_idle_s.gpr_train"]


def small_cell():
    """The cell at n = 3000, m = 150, s = 128, K = 32, the grid and the fit
    settings as the configuration states them."""
    cell = cells.load(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["data"].update(n=3000, m_train=150)
    cfg["graph"].update(s=128, K=32)
    return cell._replace(config=cfg, traffic=dict(cell.traffic, check_rows=200, min_fits=2))


def test_the_cell_finds_its_job_reference_data_and_metrics_by_name():
    cell = cells.load(CELL)
    assert cell.traffic["job"] == "fit_grid" and cell.config["reference"] == "se_gpr"
    assert cells.job(cell).run and cells.reference(cell).check and cells.reference(cell).control_fit
    assert cell.config["data"]["generator"] == "spiral" and cell.config["reduced"] == []
    per_layer = {m["name"] for m in cell.per_layer}
    assert set(NEW_READERS) <= per_layer
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "fit_s", "peak_mem_GiB"}
    assert set(cell.limits) >= {"choice_disagree", "lane_training_gap", "objective_gap",
                                "mean_gap", "var_gap"}
    b = bench_json()
    assert [w["name"] for w in b["workloads"]][-1] == CELL


def test_the_configuration_states_the_port_s_defaults_as_they_are():
    """The grid is the port's default bit for bit and the priors are
    TrainConfig's, so that the reference, which imports nothing of the port,
    follows what the fit runs."""
    import flgp_tpu_torch as ft

    cell = cells.load(CELL)
    assert cell.config["fit"]["a2s"] == ft.config.default_a2s().tolist()
    cfg = cells.job(cell).fit_config(cell.config, cell.traffic)
    tc = ft.TrainConfig()
    assert (cfg.train.prior_p_gpr, cfg.train.prior_q, cfg.train.prior_tau, cfg.train.prior_alpha,
            cfg.train.prior_beta) == (tc.prior_p_gpr, tc.prior_q, tc.prior_tau, tc.prior_alpha,
                                      tc.prior_beta)
    assert (cfg.train.t_lb, cfg.train.noise_lb, cfg.train.adam_steps) == (tc.t_lb, tc.noise_lb,
                                                                         tc.adam_steps)
    assert cfg.graph.kernel == ft.KernelType.SE and cfg.sigma == 1e-5
    assert cfg.dtype == torch.float32 and cfg.solve_dtype == torch.float64


def test_the_spiral_copy_draws_the_port_s_data():
    from flgp_tpu_torch.datasets import spiral as port
    from lib.spiral import make, spiral

    spec = {"generator": "spiral", "n": 5000, "m_train": 300, "noise_sd": 1.0}
    for got, want in zip(make(spec, 2**32 - 5), port(n=5000, m_train=300, seed=2**32 - 5)):
        assert np.array_equal(got, want)
    assert all(np.array_equal(a, b) for a, b in zip(spiral(), port()))


def _run(spans, traced=None):
    from jobs.fit import Run

    run = Run()
    run.fit_spans, run.trace = spans, traced
    return run


@pytest.mark.parametrize("metric,span", [("grid_spectra_s", "grid_spectra"),
                                         ("gpr_train_s", "gpr_train"),
                                         ("gpr_predict_s", "gpr_predict")])
def test_a_span_reader_reads_its_mean_over_the_window_and_none_without_it(metric, span):
    run = _run([{span: 0.25, "subsample": 1.0}, {span: 0.75}])
    assert cells.reader(metric).read(run) == 0.5
    assert cells.reader(metric).read(_run([{"subsample": 1.0}])) is None


def test_adam_steps_reads_the_window_s_mean_and_none_from_a_program_without_it(monkeypatch):
    mod = types.ModuleType(MODULE)
    # the warm-up, two window fits, the profiled fit
    mod.FIT_COUNTS = deque(Counter(f) for f in [dict(adam_steps=200), dict(adam_steps=200),
                                               dict(adam_steps=200, fits=1), dict(adam_steps=7)])
    mod.COUNTS = Counter(adam_steps=607)
    monkeypatch.setitem(sys.modules, MODULE, mod)
    reader = cells.reader("adam_steps")
    assert reader.read(_run([{}, {}], traced=object())) == 200.0
    mod.COUNTS = Counter(fits=4)                      # a program that never counts them
    assert reader.read(_run([{}, {}], traced=object())) is None
    monkeypatch.delitem(sys.modules, MODULE)
    assert reader.read(_run([{}, {}])) is None


def test_device_idle_in_the_training_span_and_none_without_a_trace():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "span:fit", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "span:gpr_train", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 25},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 30, "dur": 10},
    ]
    acts, spans, ops = T._parse(events)
    trace = T.Trace(acts, spans, ops, spans.pop("fit")[0], {})
    reader = cells.reader("device_idle_s.gpr_train")
    assert reader.read(_run([], trace)) == pytest.approx(5e-6)
    assert reader.read(_run([])) is None


def test_the_spans_wrap_what_the_program_calls():
    from lib.probe import span_table

    table = span_table()
    assert table["grid_spectra"] == [("flgp_tpu_torch.fit.spectral", "se_spectrum_at")]
    assert table["gpr_train"] == [("flgp_tpu_torch.fit.drivers", "_train_gpr")]
    assert table["gpr_predict"] == [("flgp_tpu_torch.fit.drivers", "_gpr_tail")]


def _line(cell):
    import run

    return run.run_cell(cell, SEED, 0.0, False, CPU, time.perf_counter())


def test_a_sound_run_is_correct():
    line, readings = _line(small_cell())
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "fit_s", "peak_mem_GiB"}
    assert line["attempted"] == 2 and line["failed"] == 0
    assert readings["a2_disagree"] == readings["choice_disagree"] == 0.0


@pytest.mark.parametrize("fault", ["t_altered", "noise_altered", "a2_shifted", "mean_altered",
                                   "var_altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    job = cells.job(cells.load(CELL))
    with job.planted(fault):
        line, _ = _line(small_cell())
    assert not line["correct"], line["checks"]


def test_lanes_left_untrained_read_far_above_a_sound_fit_at_a_small_shape():
    """Half the lanes at their coarse-grid seeds: at the cell's size the worst
    lane lies 198–243 nats above its minimum (sound fits: at most 3.3), which
    the limit of 20 sees; at this small shape the coarse grid lies nearer the
    minima (about 10 nats), still far above the sound fit's reading here."""
    job = cells.job(cells.load(CELL))
    sound = job.program_readings(small_cell(), None, SEED, CPU)
    with job.planted("lanes_untrained"):
        broken = job.program_readings(small_cell(), None, SEED, CPU)
    assert sound["lane_training_gap"] < 1e-3 and sound["lanes_above_minimum"] == 0.0
    assert broken["lane_training_gap"] > 5.0 and broken["lanes_above_minimum"] >= 5.0


def test_the_control_is_not_correct_at_a_small_shape():
    from lib.judge import judge

    cell = small_cell()
    readings = cells.job(cell).control_readings(cell, SEED, CPU)
    assert not judge(readings, cell.limits)[0], readings
