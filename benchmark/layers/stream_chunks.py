"""Chunks a fit hands to its passes over the file (``fit/streaming.py``: the
reservoir pass, the count pass and the graph pass, ⌈n / chunk_rows⌉ each): the
program's ``stream_chunks`` counter, the mean over the traced window's fits.  A
program that does not count them has nothing to read."""

import sys

from lib.counters import per_fit


def read(run):
    metrics = sys.modules.get("flgp_tpu_torch.utils.metrics")
    if "stream_chunks" not in getattr(metrics, "COUNTS", {}):
        return None
    return per_fit("stream_chunks", run)
