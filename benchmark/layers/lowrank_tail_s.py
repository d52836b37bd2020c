"""Seconds of the O(n·K) predict tail a fit (``fit/streaming.py:_gpc_lowrank_tail``:
the PG-Gibbs duals and the Laplace moments in K dimensions, then the row blocks of
the (n, K) eigenvector store, each cast to the solve dtype): the synced span around
it, the mean over the traced window's fits."""


def read(run):
    return run.span_mean("lowrank_tail")
