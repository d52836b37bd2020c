"""Share of the graph stage's roofline (K1 and K2, ``csrc/`` via
``ops/hopper_kernels.py``): 100 × the least time the card could take for the
kNN and anchor-embedding work at the fit's n, s, r, d (``lib/roofline.py``,
against the H100 SXM's published peaks) over the device time of everything
launched inside the ``knn`` and ``lae_weights`` spans of the profiled fit."""

from lib.roofline import bound, work
from lib.trace import launched_in


def read(run):
    if run.trace is None or "knn" not in run.trace.spans:
        return None
    acts = launched_in(run.trace, ["knn", "lae_weights"])
    device_s = sum(a.end - a.start for a in acts)
    if device_s <= 0:
        return None
    sh = run.trace.shape
    least_ms = sum(bound(work(k, sh["n"], sh["r"], sh["s"], sh["d"]))[0]
                   for k in ("knn", "lae_weights"))
    return 100.0 * least_ms * 1e-3 / device_s
