"""Seconds of one profiled fit in which the device ran no kernel, copy or
memset while the host was inside the predict span (``benchmark/spans/predict.json``,
the ``span:predict`` ranges of the trace): the device time the predict layer loses
to the host.  Once the benchmark's own spans retire, the program's
``flgp:predict`` ranges take their place."""

from lib.idle import idle_seconds


def read(run):
    return None if run.trace is None else idle_seconds(run.trace, "predict")
