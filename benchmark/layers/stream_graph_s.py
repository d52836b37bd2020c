"""Seconds of the streamed graph pass a fit (``fit/streaming.py:streamed_ell_graph``:
each chunk of the file read into a pinned buffer, copied to the card, then K1 and
K2 on it, written into the (n, r) ELL graph): the synced span around it, the mean
over the traced window's fits."""


def read(run):
    return run.span_mean("stream_graph")
