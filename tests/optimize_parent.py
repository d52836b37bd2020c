"""The 1-D optimizer and the GPC training as ``flgp_tpu_torch`` ran them with
one problem a call (``inference/optimize.py:minimize_1d_log`` on a 1-D grid,
``fit/drivers.py:_train_gpc`` on labels (m,)): the yardstick the CPU and card
tests hold the problem axis to at one problem, bit for bit and sync for sync.
It imports no JAX, so the card tests can import it."""

import torch

from flgp_tpu_torch.config import Approach, resolve_device
from flgp_tpu_torch.inference.optimize import Scalar1DResult
from flgp_tpu_torch.models import gpc as gpc_mod
from flgp_tpu_torch.utils.metrics import to_device, to_host


def _linspace(a, b, n):
    step = (b - a) / (n - 1)
    head = a + step * torch.arange(n - 1, dtype=a.dtype, device=a.device)
    return torch.cat([head, b.reshape(1)])


def _finite(f):
    return torch.where(torch.isfinite(f), f, torch.full_like(f, float("inf")))


def minimize_1d_log(fn, lo=1e-2, hi=1e3, n_grid=32, refine_rounds=4, refine_width=32,
                    dtype=torch.float32, max_expand=4, coarse_fn=None, device=None):
    device = resolve_device(device, "minimize_1d_log")
    lo_l = torch.log(to_device(lo, dtype, device))
    hi_l = torch.log(to_device(hi, dtype, device))
    g = lambda u: _finite(fn(torch.exp(u)))  # noqa: E731
    g_coarse = g if coarse_fn is None else (lambda u: _finite(coarse_fn(torch.exp(u))))

    def scan_window(a_l, b_l):
        us = _linspace(a_l, b_l, n_grid)
        fs = g_coarse(us)
        return us, fs, to_host(torch.argmin(fs))

    us, fs, i = scan_window(lo_l, hi_l)
    span = hi_l - lo_l
    n_exp = 0
    while i == n_grid - 1 and n_exp < max_expand:
        us, fs, i = scan_window(us[-1], us[-1] + span)
        n_exp += 1
    if coarse_fn is not None:
        top3 = torch.sort(fs, stable=True).indices[:3]
        i = to_host(top3[to_host(torch.argmin(g(us[top3])))])
    wa, wb = us[0], us[-1]
    a = us[max(i - 1, 0)]
    b = us[min(i + 1, n_grid - 1)]
    w = refine_width

    best_u = us[i]
    best_f = fs[i] if coarse_fn is None else to_device(float("inf"), dtype, device)
    for _ in range(refine_rounds):
        uu = _linspace(a, b, w)
        ff = g(uu)
        j = to_host(torch.argmin(ff))
        improved = ff[j] < best_f
        best_u = torch.where(improved, uu[j], best_u)
        best_f = torch.where(improved, ff[j], best_f)
        h = (b - a) / (w - 1)
        a, b = torch.clamp(uu[j] - h, wa, wb), torch.clamp(uu[j] + h, wa, wb)
    return Scalar1DResult(torch.exp(best_u), best_f, b - a, n_exp)


def train_gpc(eigenpair, Y, N, idx, K, cfg):
    tc = cfg.train

    def obj_at(t, max_iter):
        if tc.approach == Approach.POSTERIOR:
            return gpc_mod.gpc_nlp_objective(
                eigenpair, Y, N, idx, K, t, cfg.sigma,
                p=tc.prior_p_gpc, q=tc.prior_q, tau=tc.prior_tau,
                tol=tc.newton_tol, max_iter=max_iter,
            )
        return gpc_mod.gpc_nmll_objective(
            eigenpair, Y, N, idx, K, t, cfg.sigma, tol=tc.newton_tol, max_iter=max_iter,
        )

    coarse_cap = min(30, tc.newton_max_iter)
    return minimize_1d_log(
        lambda t: obj_at(t, tc.newton_max_iter),
        lo=tc.t_lb, hi=tc.t_ub, n_grid=tc.grid_size, dtype=cfg.dtype,
        coarse_fn=lambda t: obj_at(t, coarse_cap), device=eigenpair.values.device,
    )
