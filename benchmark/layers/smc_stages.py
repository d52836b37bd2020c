"""Tempering stages a fit (``inference/smc.py``: one a stage of the ladder from the
prior to the posterior, each stage six likelihood evaluations and a host read of β):
the program's ``smc_stages`` counter, the mean over the traced window's fits.  A
program that does not count them has nothing to read."""

import sys

from lib.counters import per_fit


def read(run):
    metrics = sys.modules.get("flgp_tpu_torch.utils.metrics")
    if "smc_stages" not in getattr(metrics, "COUNTS", {}):
        return None
    return per_fit("smc_stages", run)
