"""Seconds of one profiled fit in which the device ran no kernel, copy or
memset while the host was inside the train span (``benchmark/spans/train.json``,
the ``span:train`` ranges of the trace): the device time the train layer loses
to the host.  Once the benchmark's own spans retire, the program's
``flgp:train`` ranges take their place."""

from lib.idle import idle_seconds


def read(run):
    return None if run.trace is None else idle_seconds(run.trace, "train")
