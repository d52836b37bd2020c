"""The program's own counters, read for the traced window's fits.

``flgp_tpu_torch.utils.metrics.FIT_COUNTS`` holds each of the program's last
fits' own counts (``lloyd_rounds``, ``newton_rounds``, ``pg_rounds``,
``host_syncs``, the kernels' launches), one entry a call of a public fit
driver, failed calls too, oldest first.  The readers run after the run's
last fit and before the reference, which calls nothing of the port.  The
job's fits are the warm-up, the window's (one entry of ``Run.fit_spans``
each) and, where there is a trace, the profiled one, in that order, so the
window's are the entries just before the profiled fit's.  A program without
that store (an earlier checkout) has nothing to read.
"""

from __future__ import annotations

import sys


def per_fit(name: str, run):
    """The counter ``name``'s mean a fit over the traced window's fits, or
    None where the program keeps no such store or the window held no fit."""
    metrics = sys.modules.get("flgp_tpu_torch.utils.metrics")
    history = getattr(metrics, "FIT_COUNTS", None)
    n = len(run.fit_spans)
    if history is None or n == 0:
        return None
    fits = list(history)
    if run.trace is not None:
        fits = fits[:-1]                  # the profiled fit ran last
    window = fits[-n:]
    if not window:
        return None
    return sum(c.get(name, 0) for c in window) / len(window)
