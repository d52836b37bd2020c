"""Idle device time inside the host ranges of one span of a profiled fit."""

from __future__ import annotations

from lib.trace import Trace, busy_intervals


def _union(ranges) -> list:
    out = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def idle_seconds(trace: Trace, name: str):
    """Seconds inside the union of the span ``name``'s host ranges (nested or
    repeated calls count once) in which no kernel, copy or memset ran on the
    device; None where the fit has no such span."""
    ranges = _union(trace.spans.get(name, []))
    if not ranges:
        return None
    busy = busy_intervals(trace)
    covered, j = 0.0, 0
    for lo, hi in ranges:
        while j < len(busy) and busy[j][1] <= lo:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < hi:
            covered += min(hi, busy[k][1]) - max(lo, busy[k][0])
            k += 1
    return sum(hi - lo for lo, hi in ranges) - covered
