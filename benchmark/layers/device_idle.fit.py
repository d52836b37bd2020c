"""Share of one profiled fit's wall (host clock, ending in a synchronize) in
which no kernel, copy or memset ran on the device."""

from lib.trace import busy_seconds


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - busy_seconds(run.trace) / (hi - lo))
