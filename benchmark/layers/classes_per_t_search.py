"""Classes a t-search solves together (``inference/optimize.py:minimize_1d_log``
under ``fit/drivers.py:_train_gpc``, the train layer): the program's
``t_search_problems`` counter (the problems each search solved) over its
``t_searches`` (one a search), over the traced window's fits.  A program that
counts no t-search (one without the problem axis) has nothing to read."""

from lib.counters import per_fit


def read(run):
    searches = per_fit("t_searches", run)
    if not searches:
        return None
    return per_fit("t_search_problems", run) / searches
