"""Shared set-up of the benchmark's own tests (``python -m pytest benchmark/tests``)."""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))

# small shapes of each configuration that a CPU test run can hold
SMALL = {
    "torus_rings": dict(data=dict(n=4800, m_train=100), graph=dict(s=600, K=100)),
    "mnist_like": dict(data=dict(n=3000, m_train=200, d=32), graph=dict(s=150, K=40)),
}


@pytest.fixture
def cuda_device():
    """The CUDA device; the test skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def small_cell(name: str):
    """The cell ``name`` at the small shape of its configuration's data."""
    from lib import cells

    cell = cells.load(name)
    cfg = copy.deepcopy(cell.config)
    for group, values in SMALL[cfg["data"]["generator"]].items():
        cfg[group].update(values)
    return cell._replace(config=cfg, traffic=dict(cell.traffic, check_rows=200, min_fits=2))


def bench_json() -> dict:
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())
