"""Empirical-Bayes optimization of the 1-D GPC diffusion time.

A log-spaced grid evaluated as one batch, window expansion while the optimum
pins to the top of the window, then batched refinement rounds of the
bracketing cell.  The objective takes a 1-D tensor of x values and returns
one value per x (the batch dimension written out where the JAX package
vmaps).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class Scalar1DResult(NamedTuple):
    x: torch.Tensor
    obj: torch.Tensor               # objective value at x (minimized)
    bracket_logwidth: torch.Tensor  # final refinement bracket width in log-x
    n_expansions: int               # window shifts taken (== max_expand → top-pinned)


def _linspace(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """n points from a to b, the last exactly b (tensor endpoints)."""
    step = (b - a) / (n - 1)
    head = a + step * torch.arange(n - 1, dtype=a.dtype, device=a.device)
    return torch.cat([head, b.reshape(1)])


def _finite(f: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(f), f, torch.full_like(f, float("inf")))


def minimize_1d_log(
    fn: Callable[[torch.Tensor], torch.Tensor],
    lo: float = 1e-2,
    hi: float = 1e3,
    n_grid: int = 32,
    refine_rounds: int = 4,
    refine_width: int = 32,
    dtype: torch.dtype = torch.float32,
    max_expand: int = 4,
    coarse_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    device=None,
) -> Scalar1DResult:
    """Minimize fn over [lo, hi], unbounded above: while the optimum pins to
    the top of the scan window, the window shifts up by its own log-span (at
    most ``max_expand`` times).

    ``coarse_fn`` (default ``fn``) evaluates the coarse scan and window
    expansions; pass a cheaper surrogate when the exact objective's batched
    inner solve runs to the worst lane's trip count.  With a surrogate, the
    exact objective re-ranks the surrogate's 3 best cells before the bracket
    is chosen.  Refinement (``refine_rounds`` rounds of ``refine_width``
    points, each shrinking the bracket by 2/(width−1)) and the returned
    objective always use the exact ``fn``.  Non-finite values count as +inf.
    """
    lo_l = torch.log(torch.tensor(lo, dtype=dtype, device=device))
    hi_l = torch.log(torch.tensor(hi, dtype=dtype, device=device))
    g = lambda u: _finite(fn(torch.exp(u)))  # noqa: E731
    g_coarse = g if coarse_fn is None else (lambda u: _finite(coarse_fn(torch.exp(u))))

    def scan_window(a_l, b_l):
        us = _linspace(a_l, b_l, n_grid)
        fs = g_coarse(us)
        return us, fs, int(torch.argmin(fs))

    us, fs, i = scan_window(lo_l, hi_l)
    span = hi_l - lo_l
    n_exp = 0
    while i == n_grid - 1 and n_exp < max_expand:
        us, fs, i = scan_window(us[-1], us[-1] + span)
        n_exp += 1
    if coarse_fn is not None:
        # the surrogate's 3 best cells (ties to the lower index), re-ranked exactly
        top3 = torch.sort(fs, stable=True).indices[:3]
        i = int(top3[torch.argmin(g(us[top3]))])
    wa, wb = us[0], us[-1]
    a = us[max(i - 1, 0)]
    b = us[min(i + 1, n_grid - 1)]
    w = refine_width

    # a surrogate's coarse values must not seed the best-so-far tracker
    best_u = us[i]
    best_f = fs[i] if coarse_fn is None else torch.tensor(float("inf"), dtype=dtype, device=device)
    for _ in range(refine_rounds):
        uu = _linspace(a, b, w)
        ff = g(uu)
        j = torch.argmin(ff)
        improved = ff[j] < best_f
        best_u = torch.where(improved, uu[j], best_u)
        best_f = torch.where(improved, ff[j], best_f)
        h = (b - a) / (w - 1)
        a, b = torch.clamp(uu[j] - h, wa, wb), torch.clamp(uu[j] + h, wa, wb)
    return Scalar1DResult(torch.exp(best_u), best_f, b - a, n_exp)
