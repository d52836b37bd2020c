"""Seconds of one profiled fit in which the device ran no kernel, copy or
memset while the host was inside the streamed graph pass
(``benchmark/spans/stream_graph.json``, the ``span:stream_graph`` ranges of the
trace): the device time the pass loses to the host's reads and launches."""

from lib.idle import idle_seconds


def read(run):
    return None if run.trace is None else idle_seconds(run.trace, "stream_graph")
