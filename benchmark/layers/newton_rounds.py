"""Newton rounds a fit (``models/gpc.py:_iterate_lanes``: the training's
batched Newton solves and the Laplace moments' one), each a host sync: the
program's ``newton_rounds`` counter, the mean over the traced window's fits."""

from lib.counters import per_fit


def read(run):
    return per_fit("newton_rounds", run)
