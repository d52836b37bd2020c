"""Share of k-means‖'s weighted k-means++ reductions that ran on the CUDA kernel
(``ops/kmeans.py:_kmeanspar_rows``, the subsample layer), in %: the program's
``kernel_launches:weighted_kmeanspp`` counter (one a reduction on the kernel) over
its ``seedings`` (one a reduction, either path), over the traced window's fits.  A
program whose reduction has no kernel path (no ``kmeans.seed_on_kernel``), or a
window that seeded nothing, has nothing to read."""

import sys

from lib.counters import per_fit


def read(run):
    kmeans = sys.modules.get("flgp_tpu_torch.ops.kmeans")
    if getattr(kmeans, "seed_on_kernel", None) is None:
        return None
    seedings = per_fit("seedings", run)
    if not seedings:
        return None
    return 100.0 * per_fit("kernel_launches:weighted_kmeanspp", run) / seedings
