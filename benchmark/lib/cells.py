"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration, found in the file
its entry of ``configs`` gives, and a traffic mix, found as
``benchmark/traffic/<traffic>.json``.  Its limits for the comparison that
decides ``correct`` are ``benchmark/limits/<cell>.json``.  A per-layer
metric's reader is ``benchmark/layers/<metric>.py``, a traffic mix's job is
``benchmark/jobs/<job>.py`` and a configuration's plain reference is
``benchmark/reference/<reference>.py``.  Adding any of them adds files and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    entry: dict          # the cell's entry of ``workloads``
    config: dict         # the configuration's file
    traffic: dict        # the traffic mix's file
    limits: dict         # number -> limit; empty until the limits are set
    end_to_end: list     # the cell's end-to-end metrics (entries of ``end_to_end``)
    per_layer: list      # the cell's per-layer metrics (entries of ``per_layer``)


def load_module(path: Path) -> ModuleType:
    """Import a file by its path (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    limits_file = BENCH / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.is_file() else {}
    return Cell(name, entry, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def job(cell: Cell) -> ModuleType:
    return load_module(BENCH / "jobs" / f"{cell.traffic['job']}.py")


def reference(cell: Cell) -> ModuleType:
    return load_module(BENCH / "reference" / f"{cell.config['reference']}.py")


def reader(metric: str) -> ModuleType:
    return load_module(BENCH / "layers" / f"{metric}.py")
