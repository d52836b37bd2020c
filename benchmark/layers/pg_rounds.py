"""Pólya-Gamma rejection rounds a fit (``ops/polya_gamma.py``: the rounds of
its three loops, each ending in a host sync), the predict layer's PG-Gibbs
chain: the program's ``pg_rounds`` counter, the mean over the traced window's fits."""

from lib.counters import per_fit


def read(run):
    return per_fit("pg_rounds", run)
