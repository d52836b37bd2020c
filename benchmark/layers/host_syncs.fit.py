"""Blocking device-to-host reads a fit (``utils/metrics.py:to_host``, the one
helper every read of the fit path goes through): each drains the launch
queue and idles the device until the host launches again.  The program's
``host_syncs`` counter, the mean over the traced window's fits."""

from lib.counters import per_fit


def read(run):
    return per_fit("host_syncs", run)
