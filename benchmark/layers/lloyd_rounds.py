"""Lloyd rounds a fit (``ops/kmeans.py:lloyd``, the subsample layer): the
program's ``lloyd_rounds`` counter, one a round, the mean over the traced window's fits."""

from lib.counters import per_fit


def read(run):
    return per_fit("lloyd_rounds", run)
