"""The hyperposterior cell ``mnist7e4.hyperposterior``: its files found by name,
its readers (each returns a number from a synthetic run and None where there is
nothing to read, as from a program without the counter), the span it adds, and
whole runs of its job on the CPU at a small shape with the path sound and
broken underneath, and its control."""

import copy
import sys
import time
import types
from collections import Counter, deque

import pytest
import torch

from conftest import bench_json
from jobs.fit import Run
from lib import cells, probe
from lib import trace as T

CELL = "mnist7e4.hyperposterior"
CPU = torch.device("cpu")
SEED = 2**31 + 977
METRICS = "flgp_tpu_torch.utils.metrics"
HYPERPARAM = "flgp_tpu_torch.inference.hyperparam"
NEW_READERS = ["smc_s", "smc_stages", "lanes_per_likelihood_eval", "device_idle_s.smc"]


def small_cell():
    """The cell at n = 3000, d = 16, six classes (with fewer, one importance
    step from the prior degenerates too little to be told from a ladder),
    m = 120, s = 150, K = 40, and a quadrature of 64 points a pass."""
    cell = cells.load(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["data"].update(n=3000, n_classes=6, d=16, m_train=120)
    cfg["graph"].update(s=150, K=40)
    cfg["classes"] = 6
    cfg["hyperposterior"]["quadrature_grid"] = 64
    return cell._replace(config=cfg, traffic=dict(cell.traffic, check_rows=200, min_fits=2))


def test_the_cell_finds_its_job_reference_data_limits_and_metrics_by_name():
    cell = cells.load(CELL)
    assert cell.traffic["job"] == "fit_smc"
    assert cell.config["reference"] == "lae_smc"
    assert cell.config["entry"] == "mult_t_posterior"
    job, ref = cells.job(cell), cells.reference(cell)
    assert job.run and job.FAULTS and ref.check and ref.control_fit
    assert cell.config["data"] == {"generator": "mnist_like", "n": 70_000, "n_classes": 10,
                                   "d": 784, "m_train": 500}
    assert cell.config["reduced"] == []
    assert cell.entry["chips"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "fit_s", "peak_mem_GiB"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert set(NEW_READERS) <= per_layer
    assert per_layer - set(NEW_READERS) == {
        "subsample_s", "graph_s", "spectrum_s", "seeding_s", "seeding_kernel_share",
        "lloyd_rounds", "lloyd_kernel_share", "device_idle_s.subsample", "newton_rounds",
        "host_syncs.fit", "device_idle.fit", "graph_roofline"}
    assert set(cell.limits) == {"anchor_gap", "heat_kernel_gap", "theta_mean_gap",
                                "theta_mean_gap_avg"}
    b = bench_json()
    assert CELL in [w["name"] for w in b["workloads"]]
    assert cell.entry["config"] in [c["name"] for c in b["configs"]]


def test_the_graph_settings_are_the_ten_class_cell_s():
    """The spectrum is built as ``mnist7e4.kmeans`` builds it, on its data."""
    smc, point = cells.load(CELL).config, cells.load("mnist7e4.kmeans").config
    assert smc["graph"] == point["graph"] and smc["data"] == point["data"]
    for key in ("sigma", "dtype", "solve_dtype"):
        assert smc["fit"][key] == point["fit"][key], key
    assert smc["hyperposterior"]["prior_p"] == point["train"]["prior_p"]
    assert smc["hyperposterior"]["prior_q"] == point["train"]["prior_q"]
    assert smc["hyperposterior"]["prior_tau"] == point["train"]["prior_tau"]


def _run(spans, traced=None):
    run = Run()
    run.fit_spans, run.trace = spans, traced
    return run


def test_smc_s_reads_its_mean_over_the_window_and_none_without_it():
    run = _run([{"smc": 2.0, "seeding": 1.0}, {"smc": 3.0}])
    assert cells.reader("smc_s").read(run) == 2.5
    assert cells.reader("smc_s").read(_run([{"seeding": 1.0}])) is None


def test_the_counter_readers_read_the_window_and_none_from_a_program_without_them(monkeypatch):
    mod = types.ModuleType(METRICS)
    # the warm-up, two window fits, the profiled fit
    fit = dict(smc_stages=12, smc_likelihood_evals=72, smc_lanes=72 * 640)
    mod.FIT_COUNTS = deque(Counter(f) for f in [fit] * 3 + [dict(smc_stages=1)])
    mod.COUNTS = Counter(smc_stages=37)
    monkeypatch.setitem(sys.modules, METRICS, mod)
    window = _run([{}, {}], traced=object())
    assert cells.reader("smc_stages").read(window) == 12.0
    assert cells.reader("lanes_per_likelihood_eval").read(window) == 640.0
    mod.FIT_COUNTS = deque(Counter(fits=1) for _ in range(4))   # a program that never counts them
    mod.COUNTS = Counter(fits=4)
    assert cells.reader("smc_stages").read(window) is None
    assert cells.reader("lanes_per_likelihood_eval").read(window) is None
    monkeypatch.delitem(sys.modules, METRICS)
    assert cells.reader("smc_stages").read(_run([{}, {}])) is None


def _trace():
    """A profiled fit of 100 µs: the smc span 10–60 µs, two kernels in it (5 +
    10 µs), a kernel outside it."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "span:fit", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "span:smc", "ts": 10, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 13, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "potrf", "ts": 20, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 14, "dur": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 30, "dur": 10,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70, "dur": 1,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 72, "dur": 20,
         "args": {"correlation": 4}},
    ]
    acts, spans, ops = T._parse(events)
    return T.Trace(acts, spans, ops, spans.pop("fit")[0], {})


def test_device_idle_in_the_smc_span_and_none_without_a_trace():
    reader = cells.reader("device_idle_s.smc")
    # 50 µs of span, busy 20–25 and 30–40 µs
    assert reader.read(_run([], _trace())) == pytest.approx(35e-6)
    assert reader.read(_run([])) is None


def test_the_span_wraps_what_the_job_calls():
    from flgp_tpu_torch.inference import hyperparam

    assert probe.span_table()["smc"] == [(HYPERPARAM, "mult_t_posterior")]
    assert callable(hyperparam.mult_t_posterior)


def _line(cell, trace=False):
    import run

    return run.run_cell(cell, SEED, 0.0, trace, CPU, time.perf_counter())


def test_a_sound_run_is_correct_and_the_readers_read_it():
    line, readings = _line(small_cell())
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "fit_s", "peak_mem_GiB"}
    assert line["attempted"] == 2 and line["failed"] == 0
    traced, _ = _line(small_cell(), trace=True)
    got = {k: v["value"] for k, v in traced["metrics"].items()}
    assert got["smc_s"] > 0 and got["smc_stages"] > 1 and got["newton_rounds"] > 0
    assert got["lanes_per_likelihood_eval"] == 64 * 6
    assert got["host_syncs.fit"] > got["newton_rounds"] + got["smc_stages"]


FAULTS = ["tempering_skipped", "unmutated", "t_scaled", "class_dropped", "state_unchanged"]


def test_the_job_plants_every_fault_it_lists():
    assert sorted(cells.job(cells.load(CELL)).FAULTS) == sorted(FAULTS)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_path_is_not_correct(fault):
    job = cells.job(cells.load(CELL))
    with job.planted(fault):
        line, _ = _line(small_cell())
    assert not line["correct"], line["checks"]


def test_the_control_is_not_correct_at_a_small_shape():
    from lib.judge import judge

    cell = small_cell()
    readings = cells.job(cell).control_readings(cell, SEED, CPU)
    assert not judge(readings, cell.limits)[0], readings
