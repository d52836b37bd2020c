"""Whole runs of the harness on the CPU at small shapes, with the timed path
sound and broken underneath, and the control; the control at a cell's own
size needs the card."""

import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, bench_json, small_cell
from lib import faults

CPU = torch.device("cpu")
SEED = 2**31 + 977
CELLS = [w["name"] for w in bench_json()["workloads"]]


def _run(cell, seed=SEED):
    import run

    return run.run_cell(cell, seed, 0.0, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line, readings = _run(small_cell(name))
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", "fit_s", "peak_mem_GiB"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    """A fault that makes the fit raise is seen too: the run then prints nothing."""
    with faults.planted(fault):
        try:
            line, _ = _run(small_cell(name))
        except RuntimeError:
            return
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_a_small_shape(name, monkeypatch):
    import control
    from lib.judge import judge

    cell = small_cell(name)
    readings = control.control_readings(cell, SEED, CPU)
    assert not judge(readings, cell.limits)[0], readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(name, cuda_device):
    import control
    from lib import cells
    from lib.judge import judge

    cell = cells.load(name)
    readings = control.control_readings(cell, SEED, cuda_device)
    assert not judge(readings, cell.limits)[0], readings


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "torus1e6.kmeans",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_beside_no_program_fails_and_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "torus1e6.kmeans",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
