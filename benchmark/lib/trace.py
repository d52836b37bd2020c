"""One profiled fit, read from the profiler's trace.

``profiled(fn)`` runs fn under ``torch.profiler`` (CPU and CUDA activities)
and returns a ``Trace``: every device activity (kernel, copy, memset) with
its device interval and the host time of the runtime call that launched it,
the benchmark's span ranges (``span:<name>`` annotations) and the host's
operations, all on the profiler's one clock, in seconds.  The trace file is
written to a temporary directory and deleted once read.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Activity(NamedTuple):
    name: str
    start: float
    end: float
    launched: float      # host time of the launching runtime call; nan if unknown


class Trace(NamedTuple):
    activities: list     # [Activity], sorted by start, on the host's clock
    spans: dict          # span name -> [(start, end)] on the host
    host_ops: list       # [(start, end, name)] of host operations and runtime calls
    window: tuple        # (start, end) of the profiled call on the host
    shape: dict          # n, s, r, d of the fit: what the readers' bounds need


def _parse(events: list) -> tuple:
    launches, acts, spans, ops = {}, [], defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat == "cuda_runtime" or cat == "cuda_driver":
            if corr is not None:
                launches[corr] = ts
            ops.append((ts, ts + dur, e["name"]))
        elif cat in DEVICE_CATS:
            acts.append((e["name"], ts, ts + dur, corr))
        elif cat == "user_annotation" and e["name"].startswith("span:"):
            spans[e["name"][5:]].append((ts, ts + dur))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, e["name"]))
    acts = sorted((Activity(n, s, t, launches.get(c, float("nan"))) for n, s, t, c in acts),
                  key=lambda a: a.start)
    ops.sort()
    return acts, dict(spans), ops


def profiled(fn, shape: dict) -> Trace:
    """Run fn once under the profiler and read its trace.  The device's
    timestamps are moved onto the host's clock: by the least delay from a
    launching call to the start of what it launched, which is the launch
    latency of a few microseconds on one clock."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("span:fit"):
                fn()
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    acts_, spans, ops = _parse(events)
    offset = min((a.start - a.launched for a in acts_ if a.launched == a.launched), default=0.0)
    acts_ = [a._replace(start=a.start - offset, end=a.end - offset) for a in acts_]
    print(f"trace: {len(acts_)} device activities, clock offset {offset:.6f} s", file=sys.stderr)
    fit = spans.pop("fit")[0]
    return Trace(acts_, spans, ops, fit, shape)


def launched_in(trace: Trace, span_names) -> list:
    """The device activities whose launching call lies inside one of the
    named spans' host ranges."""
    ranges = sorted(r for name in span_names for r in trace.spans.get(name, []))
    return [a for a in trace.activities
            if any(lo <= a.launched <= hi for lo, hi in ranges)]


def busy_intervals(trace: Trace) -> list:
    """The union of the device activities' intervals inside the window."""
    lo, hi = trace.window
    out = []
    for a in trace.activities:
        s, e = max(a.start, lo), min(a.end, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def _host_doing(trace: Trace, at: float) -> str:
    """The benchmark span and the innermost host operation running at ``at``."""
    span = next((name for name, rs in trace.spans.items() if any(lo <= at <= hi for lo, hi in rs)),
                "outside spans")
    starts = [o[0] for o in trace.host_ops]
    i = bisect.bisect_right(starts, at)
    inner = next((o for o in reversed(trace.host_ops[max(0, i - 2000):i]) if o[0] <= at <= o[1]),
                 None)
    return f"{span}: {inner[2] if inner else 'no host operation'}"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by what the host was doing when each began."""
    per_op = defaultdict(float)
    for a in trace.activities:
        per_op[a.name[:120]] += a.end - a.start
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace)
    lo, hi = trace.window
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name, sec] for name, sec in ops],
            "idle_gaps": [[_host_doing(trace, s), e - s] for s, e in gaps]}
