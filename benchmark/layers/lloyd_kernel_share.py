"""Share of Lloyd's assignment passes that ran on K1 at r = 1 (``ops/kmeans.py:lloyd``,
the subsample layer), in %: the program's ``lloyd_kernel_rounds`` counter (one a
pass on K1: each round's and the last one's) over the fit's passes,
``lloyd_rounds`` + 1 (one Lloyd run a fit, as k-means with one start runs), over
the traced window's fits.  It moves where the dispatch moves, not with the number
of rounds Lloyd takes.  A program whose Lloyd has no such path (no
``kmeans.assign_on_kernel``), or a window that ran no Lloyd round, has nothing to
read."""

import sys

from lib.counters import per_fit


def read(run):
    kmeans = sys.modules.get("flgp_tpu_torch.ops.kmeans")
    if getattr(kmeans, "assign_on_kernel", None) is None:
        return None
    rounds = per_fit("lloyd_rounds", run)
    if not rounds:
        return None
    return 100.0 * per_fit("lloyd_kernel_rounds", run) / (rounds + 1)
