"""Resumable bandwidth-grid search.

``fit_se_regression_gp`` trains every grid point at once; here each grid
point is trained alone (one Adam lane) and its result is checkpointed as it
completes, so a resumed call skips the finished points and returns the same
result bit for bit.  The right trade for very large n, where each grid point
is minutes of work.  ``flgp_tpu.fit.resumable``'s counterpart.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import FitConfig
from ..utils.checkpoint import is_saved, load_pytree, save_pytree, save_spectrum
from . import spectral
from .drivers import (FitResult, _a2_grid, _concat_all, _gpr_tail, _solve_cast, _start,
                      _to_result, _train_gpr)


def _same_a2(stored, a2: float) -> bool:
    """A checkpoint keyed by index goes stale when the grid changes between
    runs: trust it only for the same a2."""
    stored = float(stored)
    return np.isfinite(stored) and abs(stored - a2) <= 1e-12 * max(1.0, abs(a2))


def fit_se_regression_gp_resumable(generator: torch.Generator, X, Y, X_new, ckpt_dir: str,
                                   cfg: FitConfig = FitConfig(sigma=1e-5),
                                   device=None) -> FitResult:
    """SE-kernel GPR with a checkpoint per bandwidth-grid point under
    ``ckpt_dir`` (``a2_<i>``: t, noise, objective and a2) and the winner's
    spectrum (``best_spectrum``).  The setup (anchors, kNN graph) comes from
    ``generator`` as in :func:`fit_se_regression_gp`, so the same seed gives
    the same setup on resume.  ``device``: the CUDA device unless the caller
    names one."""
    device = _start(generator, device)
    os.makedirs(ckpt_dir, exist_ok=True)
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    g = cfg.graph
    K = min(g.resolved_K(), g.s, n)
    a2s = _a2_grid(cfg)
    basis = spectral.se_grid_setup(generator, X_all, g)

    results = []
    for i, a2 in enumerate(a2s):
        path = os.path.join(ckpt_dir, f"a2_{i}")
        if is_saved(path):
            tree = load_pytree(path)
            if _same_a2(tree["a2"], a2):
                results.append(tree)
                continue
        scfg, seig, (Ys,) = _solve_cast(cfg, spectral.se_spectrum_at(basis, a2, g), Y)
        res = _train_gpr(seig, Ys, slice(0, m), K, scfg)
        tree = {"t": res.t, "noise": res.noise, "obj": res.obj, "a2": a2}
        save_pytree(path, tree)
        # read back: a fresh run and a resumed one take the same CPU values
        results.append(load_pytree(path))

    best = int(np.argmin([float(r["obj"]) for r in results]))
    a2, t, noise, obj = a2s[best], results[best]["t"], results[best]["noise"], results[best]["obj"]
    eig = spectral.se_spectrum_at(basis, a2, g)
    save_spectrum(os.path.join(ckpt_dir, "best_spectrum"), eig, basis.sub.centers,
                  basis.sub.counts)
    scfg, seig, (Ys,) = _solve_cast(cfg, eig, Y)
    out = _gpr_tail(seig, Ys, m, n, K, scfg, t.to(device=device, dtype=scfg.dtype),
                    noise.to(device=device, dtype=scfg.dtype))
    return _to_result(out, dict(t=t, noise=noise, a2=a2), -obj, eig)
