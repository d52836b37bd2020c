"""The out-of-core cell ``torus1e7.streamed``: its files found by name, its
readers (each returns a number from a synthetic run and None where there is
nothing to read, as from a program without the counter), the spans it adds,
and whole runs of its job on the CPU at a small shape with the streamed path
sound and broken underneath, and its control."""

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
from lib.roofline import bound, work

CELL = "torus1e7.streamed"
CPU = torch.device("cpu")
SEED = 2**31 + 977
METRICS = "flgp_tpu_torch.utils.metrics"
STREAMING = "flgp_tpu_torch.fit.streaming"
NEW_READERS = ["reservoir_s", "stream_graph_s", "lowrank_tail_s", "stream_chunks",
               "device_idle_s.stream_graph", "stream_graph_roofline"]


def small_cell():
    """The cell at n = 6000 (two rings, which 64 anchors keep apart), m = 200,
    s = 64, K = 32 and chunks of 1,000 rows: three passes of six chunks."""
    cell = cells.load(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["data"].update(n=6000, m_train=200, n_rings=2)
    cfg["graph"].update(s=64, K=32)
    cfg["stream"].update(chunk_rows=1000)
    return cell._replace(config=cfg, traffic=dict(cell.traffic, check_rows=200, min_fits=2))


def test_the_cell_finds_its_job_reference_data_limits_and_metrics_by_name():
    cell = cells.load(CELL)
    assert cell.traffic["job"] == "fit_streamed"
    assert cell.config["reference"] == "lae_gpc_streamed"
    assert cell.config["entry"] == "fit_lae_logit_gp_streamed"
    job, ref = cells.job(cell), cells.reference(cell)
    assert job.run and job.FAULTS and ref.check and ref.control_fit
    assert cell.config["data"] == {"generator": "torus_rings", "n": 10_000_000, "n_rings": 6,
                                   "m_train": 1000}
    assert cell.config["reduced"] == ["hosts", "hmc_chains"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "fit_s", "peak_mem_GiB"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert set(NEW_READERS) <= per_layer
    assert per_layer - set(NEW_READERS) == {
        "device_idle.fit", "host_syncs.fit", "lloyd_rounds", "lloyd_kernel_share", "seeding_s",
        "seeding_kernel_share", "newton_rounds", "pg_kernel_share"}
    assert {"sample_differs", "count_gap", "anchor_gap", "objective_gap", "mean_gap",
            "label_disagree", "var_gap"} <= set(cell.limits)
    b = bench_json()
    assert CELL in [w["name"] for w in b["workloads"]]
    assert cell.entry["config"] in [c["name"] for c in b["configs"]]


def test_the_settings_are_the_torus_cell_s():
    """Every setting the two torus configurations can share, they share."""
    streamed, torus = cells.load(CELL).config, cells.load("torus1e6.kmeans").config
    for group in ("graph", "fit", "train"):
        assert streamed[group] == torus[group], group
    assert streamed["stream"] == {"chunk_rows": 65536, "sample_factor": 50, "sample_seed": 0}


def test_the_stream_settings_are_the_port_s_defaults():
    """The streamed fit draws its reservoir at the sample factor and seed the
    reference follows."""
    import inspect

    from flgp_tpu_torch.fit import streaming

    st = cells.load(CELL).config["stream"]
    sub = inspect.signature(streaming.streamed_subsample).parameters
    res = inspect.signature(streaming.reservoir_sample).parameters
    assert sub["sample_factor"].default == st["sample_factor"]
    assert res["seed"].default == st["sample_seed"]


def _run(spans, traced=None):
    run = Run()
    run.fit_spans, run.trace = spans, traced
    return run


@pytest.mark.parametrize("metric,span", [("reservoir_s", "reservoir"),
                                         ("stream_graph_s", "stream_graph"),
                                         ("lowrank_tail_s", "lowrank_tail")])
def test_a_span_reader_reads_its_mean_over_the_window_and_none_without_it(metric, span):
    run = _run([{span: 0.25, "seeding": 1.0}, {span: 0.75}])
    assert cells.reader(metric).read(run) == 0.5
    assert cells.reader(metric).read(_run([{"seeding": 1.0}])) is None


def test_stream_chunks_reads_the_window_s_mean_and_none_from_a_program_without_it(monkeypatch):
    mod = types.ModuleType(METRICS)
    # the warm-up, two window fits, the profiled fit
    mod.FIT_COUNTS = deque(Counter(f) for f in [dict(stream_chunks=459)] * 3
                           + [dict(stream_chunks=7)])
    mod.COUNTS = Counter(stream_chunks=3 * 459 + 7)
    monkeypatch.setitem(sys.modules, METRICS, mod)
    reader = cells.reader("stream_chunks")
    assert reader.read(_run([{}, {}], traced=object())) == 459.0
    mod.COUNTS = Counter(fits=4)                      # a program that never counts them
    assert reader.read(_run([{}, {}], traced=object())) is None
    monkeypatch.delitem(sys.modules, METRICS)
    assert reader.read(_run([{}, {}])) is None


def _trace(shape):
    """A profiled fit of 100 µs: the graph span 10–60 µs, K1 and K2 in it
    (5 + 10 µs of device time), a copy in it (8 µs), a kernel outside it."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "span:fit", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "span:stream_graph", "ts": 10, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 11, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 12,
         "dur": 8, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 13, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "knn_kernel", "ts": 20, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 14, "dur": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "lae_kernel", "ts": 30, "dur": 10,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70, "dur": 1,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 72, "dur": 20,
         "args": {"correlation": 4}},
    ]
    acts, spans, ops = T._parse(events)
    return T.Trace(acts, spans, ops, spans.pop("fit")[0], shape)


def test_device_idle_in_the_graph_span_and_none_without_a_trace():
    reader = cells.reader("device_idle_s.stream_graph")
    # 50 µs of span, busy 12–20, 20–25 and 30–40 µs: 23 µs
    assert reader.read(_run([], _trace({}))) == pytest.approx(27e-6)
    assert reader.read(_run([])) is None


def test_the_roofline_share_counts_the_kernels_in_the_span_and_not_the_copies():
    shape = dict(n=1000, s=16, r=3, d=2)
    least_ms = sum(bound(work(k, 1000, 3, 16, 2))[0] for k in ("knn", "lae_weights"))
    got = cells.reader("stream_graph_roofline").read(_run([], _trace(shape)))
    assert got == pytest.approx(100.0 * least_ms * 1e-3 / 15e-6)
    assert cells.reader("stream_graph_roofline").read(_run([])) is None


def test_the_roofline_share_is_none_without_the_span():
    trace = _trace(dict(n=1000, s=16, r=3, d=2))
    trace.spans.pop("stream_graph")
    assert cells.reader("stream_graph_roofline").read(_run([], trace)) is None


def test_the_spans_wrap_what_the_streamed_driver_calls():
    """Each span wraps a function of ``fit.streaming`` that the streamed fit looks up
    there at each call, so the span sees every call."""
    from flgp_tpu_torch.fit import streaming

    table = probe.span_table()
    assert table["reservoir"] == [(STREAMING, "reservoir_sample")]
    assert table["stream_graph"] == [(STREAMING, "streamed_ell_graph")]
    assert table["lowrank_tail"] == [(STREAMING, "_gpc_lowrank_tail")]
    assert all(callable(getattr(streaming, a)) for _, a in
               table["reservoir"] + table["stream_graph"] + table["lowrank_tail"])


def _line(cell, trace=False):
    import run

    return run.run_cell(cell, SEED, 0.0, trace, CPU, time.perf_counter())


def test_a_sound_run_is_correct_and_the_spans_see_each_pass():
    line, readings = _line(small_cell())
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "fit_s", "peak_mem_GiB"}
    assert line["attempted"] == 2 and line["failed"] == 0
    assert readings["sample_differs"] == 0.0 and readings["label_error"] == 0.0
    traced, _ = _line(small_cell(), trace=True)
    for name in ("reservoir_s", "stream_graph_s", "lowrank_tail_s"):
        assert traced["metrics"][name]["value"] > 0, name
    assert traced["metrics"]["stream_chunks"]["value"] == 18.0


FAULTS = ["state_unchanged", "half_the_batch", "sample_reseeded", "tail_uncounted", "t_shrunk",
          "t_lower_bound", "mean_altered", "var_altered", "answer_altered"]


def test_the_job_plants_every_fault_it_lists():
    assert sorted(cells.job(cells.load(CELL)).FAULTS) == sorted(FAULTS)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_streamed_path_is_not_correct(fault):
    job = cells.job(cells.load(CELL))
    with job.planted(fault):
        line, _ = _line(small_cell())
    assert not line["correct"], line["checks"]


def test_the_control_is_not_correct_at_a_small_shape():
    from lib.judge import judge

    cell = small_cell()
    readings = cells.job(cell).control_readings(cell, SEED, CPU)
    assert not judge(readings, cell.limits)[0], readings
