"""Device activities (kernels, copies, memsets) launched inside the predict
span of the profiled fit: the work the PG-Gibbs chain and the Laplace moments
issue, one launch at a time."""

from lib.trace import launched_in


def read(run):
    if run.trace is None or "predict" not in run.trace.spans:
        return None
    return float(len(launched_in(run.trace, ["predict"])))
