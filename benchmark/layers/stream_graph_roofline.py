"""Share of the streamed graph pass's roofline (K1 and K2 over every chunk,
``csrc/`` via ``ops/hopper_kernels.py``): 100 × the least time the card could
take for the kNN and anchor-embedding work at the fit's n, s, r, d
(``lib/roofline.py``, against the H100 SXM's published peaks) over the device
time of the kernels launched inside the ``stream_graph`` span of the profiled
fit; the chunks' copies and memsets are left out, as the bound leaves out the
file's reads."""

from lib.roofline import bound, work
from lib.trace import launched_in

NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    if run.trace is None or "stream_graph" not in run.trace.spans:
        return None
    acts = [a for a in launched_in(run.trace, ["stream_graph"])
            if not a.name.startswith(NOT_KERNELS)]
    device_s = sum(a.end - a.start for a in acts)
    if device_s <= 0:
        return None
    sh = run.trace.shape
    least_ms = sum(bound(work(k, sh["n"], sh["r"], sh["s"], sh["d"]))[0]
                   for k in ("knn", "lae_weights"))
    return 100.0 * least_ms * 1e-3 / device_s
