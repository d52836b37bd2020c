"""Seconds of one profiled fit in which the device ran no kernel, copy or
memset while the host was inside the SMC span (``benchmark/spans/smc.json``, the
``span:smc`` ranges of the trace): the device time the ladder loses to the host's
β reads, Newton round reads and launches."""

from lib.idle import idle_seconds


def read(run):
    return None if run.trace is None else idle_seconds(run.trace, "smc")
