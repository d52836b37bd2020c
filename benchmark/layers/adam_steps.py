"""Adam steps a fit (``inference/optimize.py:adam_minimize``, the regression's
training: one a step, however many lanes it runs): the program's ``adam_steps``
counter, the mean over the traced window's fits.  A program that does not count
them has nothing to read."""

import sys

from lib.counters import per_fit


def read(run):
    metrics = sys.modules.get("flgp_tpu_torch.utils.metrics")
    if "adam_steps" not in getattr(metrics, "COUNTS", {}):
        return None
    return per_fit("adam_steps", run)
