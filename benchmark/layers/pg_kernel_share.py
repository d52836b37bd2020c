"""Share of the Pólya-Gamma draws that ran on the CUDA kernel
(``ops/polya_gamma.py:polya_gamma``, the predict layer's PG-Gibbs chain), in
%: the program's ``kernel_launches:polya_gamma`` counter (one a draw on the
kernel) over its ``pg_draws`` (one a draw, either path), over the traced
window's fits.  A program whose draw has no kernel path (no
``polya_gamma.pg_on_kernel``), or a window that drew nothing, has nothing to
read."""

import sys

from lib.counters import per_fit


def read(run):
    pg = sys.modules.get("flgp_tpu_torch.ops.polya_gamma")
    if getattr(pg, "pg_on_kernel", None) is None:
        return None
    draws = per_fit("pg_draws", run)
    if not draws:
        return None
    return 100.0 * per_fit("kernel_launches:polya_gamma", run) / draws
