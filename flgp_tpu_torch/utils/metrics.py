"""Structured per-stage metrics and wall-clock instrumentation.

Every pipeline stage can record its wall-clock, sizes and solver residuals
into a structured report (``flgp_tpu.utils.metrics``), and a
``torch.profiler`` trace can wrap any scope.  PyTorch queues work on the card
asynchronously, so a stage synchronizes the devices of what it names in its
``_sync`` slot before its clock stops.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import torch


@dataclass
class StageMetrics:
    name: str
    wall_s: float
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MetricsReport:
    stages: list = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, **extra) -> Iterator[Dict[str, Any]]:
        """Time a stage; the yielded dict collects extra metrics.  A tensor
        put in its ``_sync`` slot is waited for before the clock stops, so
        the wall covers the work queued for it."""
        slot: Dict[str, Any] = dict(extra)
        t0 = time.perf_counter()
        try:
            yield slot
        finally:
            t = slot.pop("_sync", None)
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            self.stages.append(StageMetrics(name, time.perf_counter() - t0, slot))

    def to_json(self) -> str:
        return json.dumps([{"stage": s.name, "wall_s": round(s.wall_s, 6), **s.extra}
                           for s in self.stages])

    def total(self) -> float:
        return sum(s.wall_s for s in self.stages)


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]) -> Iterator[None]:
    """Wrap a scope in a ``torch.profiler`` trace (CPU, and CUDA where there
    is a card) written as a Chrome trace into ``logdir``; a no-op for None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
