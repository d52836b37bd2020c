"""Seconds of one profiled fit in which the device ran no kernel, copy or
memset while the host was inside the regression's training span
(``benchmark/spans/gpr_train.json``, the ``span:gpr_train`` ranges of the trace):
the device time the training (its coarse grid and Adam steps) loses to the host."""

from lib.idle import idle_seconds


def read(run):
    return None if run.trace is None else idle_seconds(run.trace, "gpr_train")
