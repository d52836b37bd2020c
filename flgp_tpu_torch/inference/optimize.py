"""Empirical-Bayes hyperparameter optimization.

1-D objectives (the GPC diffusion time): a log-spaced grid evaluated as one
batch, window expansion while the optimum pins to the top of the window,
then batched refinement rounds of the bracketing cell.  The objective takes
a 1-D tensor of x values and returns one value per x (the batch dimension
written out where the JAX package vmaps).

Multi-D objectives (GPR's t and noise): a coarse log-grid evaluated as one
batch picks the seed, then a hand-written Adam runs in log-transformed
(bound-respecting) coordinates on ``torch.autograd`` gradients and keeps the
best iterate.  It is deterministic, so in float64 it lands on the JAX
package's result.

The three minimizers build their grids on ``device``: the CUDA device when
it is None (``config.resolve_device``, which raises without one), as every
entry point of the port runs on the card unless the caller names the CPU.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..utils.metrics import count, to_device, to_host


class Scalar1DResult(NamedTuple):
    x: torch.Tensor
    obj: torch.Tensor               # objective value at x (minimized)
    bracket_logwidth: torch.Tensor  # final refinement bracket width in log-x
    n_expansions: Any               # window shifts taken (== max_expand → top-pinned): an int,
                                    # or a list of J ints for J problems

    def first(self) -> "Scalar1DResult":
        """The first problem's result, every field a scalar."""
        return Scalar1DResult(self.x[0], self.obj[0], self.bracket_logwidth[0],
                              self.n_expansions[0])


def _linspace(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """n points from a to b along a new last axis, the last exactly b (a and b
    tensors of one shape)."""
    step = (b - a) / (n - 1)
    head = a[..., None] + step[..., None] * torch.arange(n - 1, dtype=a.dtype, device=a.device)
    return torch.cat([head, b[..., None]], dim=-1)


def _finite(f: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(f), f, torch.full_like(f, float("inf")))


def _pick(x: torch.Tensor, cols) -> torch.Tensor:
    """x[r, cols[r]] for each row r, the columns read on the host."""
    return torch.stack([x[r, c] for r, c in enumerate(cols.tolist())])


def _merge(old: torch.Tensor, new: torch.Tensor, rows: list) -> torch.Tensor:
    """``old`` with its rows ``rows`` replaced by the rows of ``new``, in order."""
    at = {r: k for k, r in enumerate(rows)}
    return torch.stack([new[at[r]] if r in at else old[r] for r in range(old.shape[0])])


def minimize_1d_log(
    fn: Callable,
    lo: float = 1e-2,
    hi: float = 1e3,
    n_grid: int = 32,
    refine_rounds: int = 4,
    refine_width: int = 32,
    dtype: torch.dtype = torch.float32,
    max_expand: int = 4,
    coarse_fn: Optional[Callable] = None,
    device=None,
    problems: Optional[int] = None,
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

    Without ``problems``, fn takes a 1-D tensor of x values and returns one
    value per x, and every field of the result is a scalar.  With
    ``problems`` = J, J independent problems over the same [lo, hi] are
    solved together: fn(x, rows) takes x of shape (J', w), row k holding w
    points of problem ``rows[k]``, and returns (J', w); ``rows`` lists the
    J' problems in ascending order, or is None for all J.  Each problem keeps
    its own window, argmin (ties to the lower index), window shifts,
    re-ranked top 3, bracket and best-so-far, so its result is the one it
    gets alone; each stage reads all its problems' argmins in one
    ``to_host``, and a window shift evaluates only the problems still pinned
    to the top of their window.  Every field of the result has a leading
    (J,) axis (``n_expansions`` a list).  Each call counts one
    ``t_searches`` and J ``t_search_problems``.
    """
    device = resolve_device(device, "minimize_1d_log")
    if problems is None:
        def lift(f):
            return None if f is None else (lambda x, rows: f(x[0])[None])
        return minimize_1d_log(lift(fn), lo, hi, n_grid, refine_rounds, refine_width, dtype,
                               max_expand, lift(coarse_fn), device, problems=1).first()
    J = problems
    count("t_searches")
    count("t_search_problems", J)
    lo_l = torch.log(to_device(lo, dtype, device))
    hi_l = torch.log(to_device(hi, dtype, device))
    g = lambda u, rows: _finite(fn(torch.exp(u), rows))  # noqa: E731
    g_coarse = g if coarse_fn is None else (
        lambda u, rows: _finite(coarse_fn(torch.exp(u), rows)))

    def scan_window(a_l, b_l, rows):
        us = _linspace(a_l, b_l, n_grid)
        fs = g_coarse(us, rows)
        return us, fs, to_host(torch.argmin(fs, dim=-1))

    us, fs, i = scan_window(lo_l.expand(J), hi_l.expand(J), None)
    span = hi_l - lo_l
    n_exp = np.zeros(J, dtype=np.int64)
    while True:
        rows = [r for r in range(J) if i[r] == n_grid - 1 and n_exp[r] < max_expand]
        if not rows:
            break
        if len(rows) == J:
            us, fs, i = scan_window(us[:, -1], us[:, -1] + span, None)
        else:
            top = torch.stack([us[r, -1] for r in rows])
            us_r, fs_r, i[rows] = scan_window(top, top + span, rows)
            us, fs = _merge(us, us_r, rows), _merge(fs, fs_r, rows)
        n_exp[rows] += 1
    if coarse_fn is not None:
        # the surrogate's 3 best cells (ties to the lower index), re-ranked exactly
        top3 = torch.sort(fs, dim=-1, stable=True).indices[:, :3]
        k = to_host(torch.argmin(g(torch.gather(us, 1, top3), None), dim=-1))
        i = to_host(_pick(top3, k))
    wa, wb = us[:, 0], us[:, -1]
    a = _pick(us, np.maximum(i - 1, 0))
    b = _pick(us, np.minimum(i + 1, n_grid - 1))
    w = refine_width

    # a surrogate's coarse values must not seed the best-so-far tracker
    best_u = _pick(us, i)
    best_f = _pick(fs, i) if coarse_fn is None else to_device(float("inf"), dtype, device)
    for _ in range(refine_rounds):
        uu = _linspace(a, b, w)
        ff = g(uu, None)
        j = to_host(torch.argmin(ff, dim=-1))
        u_j, f_j = _pick(uu, j), _pick(ff, j)
        improved = f_j < best_f
        best_u = torch.where(improved, u_j, best_u)
        best_f = torch.where(improved, f_j, best_f)
        h = (b - a) / (w - 1)
        a, b = torch.clamp(u_j - h, wa, wb), torch.clamp(u_j + h, wa, wb)
    return Scalar1DResult(torch.exp(best_u), best_f.expand(J), b - a, n_exp.tolist())


class AdamResult(NamedTuple):
    x: torch.Tensor
    obj: torch.Tensor
    grad_norm: torch.Tensor  # ‖∇fn‖ at the returned iterate (convergence status)


def _value_and_grad(fn, x: torch.Tensor):
    x = x.detach().requires_grad_(True)
    f = fn(x)
    (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


def _adam_step(fn, x, m, v, best_x, best_f, unbias1, unbias2, lr, b1, b2, eps):
    """One Adam step from ``x``: the next (x, m, v, best_x, best_f).

    ``unbias1`` and ``unbias2`` are the step's 1 − b1^(i+1) and 1 − b2^(i+1),
    which undo the moments' bias: host floats on the CPU, 0-d tensors on the
    card, where a CUDA graph of the step reads them anew at each replay."""
    f, g = _value_and_grad(fn, x)
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / unbias1
    vhat = v / unbias2
    improved = torch.isfinite(f) & (f < best_f)
    best_x = torch.where(improved[..., None], x, best_x)
    best_f = torch.where(improved, f, best_f)
    return x - lr * mhat / (torch.sqrt(vhat) + eps), m, v, best_x, best_f


# eager steps before a CUDA graph is captured: they initialise the solver and
# BLAS handles and autograd's state on the capturing stream
_GRAPH_WARMUP = 3


class _Capture:
    """A card's means of the graphed loop: the stream it runs on, the memory
    pool its graphs share, and the last graph, kept until the next one is
    captured so that the pool outlives it (a pool that no graph holds cannot
    be captured into again); no graph is replayed after its own loop."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graph = None


_CAPTURE: dict = {}     # device index -> _Capture


def _graphed_steps(fn, state: tuple, unbias, first: int, steps: int, lr, b1, b2, eps,
                   capture: _Capture) -> tuple:
    """Adam steps ``first``..``steps``−1 on the card as replays of one CUDA
    graph of a step, captured on the current stream: the loop's host work is
    two fills and a replay a step, where an eager step launches every
    operation of the objective and its gradient.  ``state`` is (x, m, v,
    best_x, best_f) before step ``first``; ``unbias`` the step's two 0-d
    tensors."""
    static = [t.clone() for t in state]
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=capture.pool)
    try:
        for dst, src in zip(static, _adam_step(fn, *static, *unbias, lr, b1, b2, eps)):
            dst.copy_(src)
    finally:
        graph.capture_end()
    capture.graph = graph
    for i in range(first, steps):
        count("adam_steps")
        unbias[0].fill_(1 - b1 ** (i + 1.0))
        unbias[1].fill_(1 - b2 ** (i + 1.0))
        graph.replay()
    return tuple(static)


def adam_minimize(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    steps: int = 200,
    lr: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> AdamResult:
    """Adam on a flat parameter vector, returning the best iterate seen.

    ``fn`` maps (..., P) to (...): leading axes of ``x0`` are independent
    lanes (the gradient of the lanes' sum holds each lane's own gradient).
    Non-finite gradient entries count as 0; nothing in the loop reads a
    value back to the host.  Each step counts one ``adam_steps``, whatever
    the number of lanes.  On the card, in float32 or float64, the steps after
    the first few replay one CUDA graph of a step (the same operations as an
    eager step, so the same bits), so ``fn`` must launch no host sync there."""
    x = x0.detach()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    best_x = x
    best_f = torch.full(x.shape[:-1], float("inf"), dtype=x.dtype, device=x.device)
    state = (x, m, v, best_x, best_f)
    on_card = x.device.type == "cuda"
    unbias = ([torch.empty((), dtype=x.dtype, device=x.device) for _ in range(2)]
              if on_card else None)

    def eager_step(i, state):
        count("adam_steps")
        c1, c2 = 1 - b1 ** (i + 1.0), 1 - b2 ** (i + 1.0)
        if on_card:
            unbias[0].fill_(c1)
            unbias[1].fill_(c2)
            c1, c2 = unbias
        return _adam_step(fn, *state, c1, c2, lr, b1, b2, eps)

    graphed = (on_card and x.dtype in (torch.float32, torch.float64)
               and steps > _GRAPH_WARMUP + 1)
    if not graphed:
        for i in range(steps):
            state = eager_step(i, state)
    else:
        if x.device.index not in _CAPTURE:
            _CAPTURE[x.device.index] = _Capture(x.device)
        capture = _CAPTURE[x.device.index]
        side, main = capture.stream, torch.cuda.current_stream(x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for i in range(_GRAPH_WARMUP):
                state = eager_step(i, state)
            state = _graphed_steps(fn, state, unbias, _GRAPH_WARMUP, steps, lr, b1, b2, eps,
                                   capture)
        main.wait_stream(side)
        # the side stream's cuBLAS workspaces would stay allocated beside the main
        # stream's for the rest of the fit: release them all (a stream's is made
        # again at its next product)
        torch._C._cuda_clearCublasWorkspaces()
    x, _, _, best_x, best_f = state
    with torch.no_grad():
        f_final = fn(x)
    take_final = torch.isfinite(f_final) & (f_final < best_f)
    x_out = torch.where(take_final[..., None], x, best_x)
    f_out = torch.where(take_final, f_final, best_f)
    g_out = _value_and_grad(fn, x_out)[1]
    return AdamResult(x_out, f_out, torch.linalg.norm(g_out, dim=-1))


class GprOptResult(NamedTuple):
    t: torch.Tensor
    noise: torch.Tensor
    obj: torch.Tensor        # minimized objective value
    grad_norm: torch.Tensor  # ‖∇obj‖ (log-coords) at the RETURNED point (status)


def _log_grid(lo_hi: Tuple[float, float], n: int, dtype, device) -> torch.Tensor:
    return torch.logspace(math.log10(lo_hi[0]), math.log10(lo_hi[1]), n, dtype=dtype,
                          device=device)


def _to_log(v: torch.Tensor, lb: float) -> torch.Tensor:
    return torch.log(torch.clamp(v - lb, min=1e-6))


def _coarse_seeds(fn, flatT: torch.Tensor, flatN: torch.Tensor, lanes: int):
    """The best cell of the coarse grid for each lane: (t, noise, value),
    each of shape (lanes,).  Non-finite cells count as +inf."""
    with torch.no_grad():
        vals = _finite(fn(flatT.expand(lanes, -1), flatN.expand(lanes, -1)))
    i = torch.argmin(vals, dim=1)
    return flatT[i], flatN[i], torch.gather(vals, 1, i[:, None])[:, 0]


def minimize_t_noise(
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    t_lb: float = 1e-3,
    noise_lb: float = 1e-4,
    t_range: Tuple[float, float] = (1e-2, 1e3),
    noise_range: Tuple[float, float] = (1e-3, 1e1),
    n_grid: int = 8,
    adam_steps: int = 200,
    adam_lr: float = 0.05,
    dtype: torch.dtype = torch.float32,
    device=None,
    lanes: int = 1,
) -> GprOptResult:
    """Minimize fn(t, noise) with bounds t ≥ t_lb, noise ≥ noise_lb, for
    ``lanes`` independent problems at once (the lanes of a bandwidth grid).

    ``fn`` takes t and noise of shape (lanes, G), row a holding G candidate
    points of lane a, and returns a value per entry.  The coarse log-grid is
    one such call (non-finite cells, such as a failed Cholesky at an extreme
    corner, count as +inf); Adam then runs in (log t, log noise) from each
    lane's best cell, one run of ``adam_steps`` steps with G = 1 serving all
    lanes, and the better of the Adam iterate and the grid seed is returned,
    with the gradient norm taken at the returned point.  Every field of the
    result has shape (lanes,)."""
    device = resolve_device(device, "minimize_t_noise")
    ts = _log_grid(t_range, n_grid, dtype, device)
    ns = _log_grid(noise_range, n_grid, dtype, device)
    T, Nz = torch.meshgrid(ts, ns, indexing="ij")
    t0, n0, f0 = _coarse_seeds(fn, T.reshape(-1), Nz.reshape(-1), lanes)

    def obj_flat(x):
        return fn(t_lb + torch.exp(x[:, :1]), noise_lb + torch.exp(x[:, 1:]))[:, 0]

    res = adam_minimize(obj_flat, torch.stack([_to_log(t0, t_lb), _to_log(n0, noise_lb)], dim=-1),
                        steps=adam_steps, lr=adam_lr)
    better = res.obj < f0
    t_out = torch.where(better, t_lb + torch.exp(res.x[:, 0]), t0)
    n_out = torch.where(better, noise_lb + torch.exp(res.x[:, 1]), n0)
    x_out = torch.stack([_to_log(t_out, t_lb), _to_log(n_out, noise_lb)], dim=-1)
    g_out = _value_and_grad(obj_flat, x_out)[1]
    return GprOptResult(t_out, n_out, torch.minimum(res.obj, f0), torch.linalg.norm(g_out, dim=-1))


def minimize_t_noisevec(
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    m: int,
    t_lb: float = 1e-3,
    noise_lb: float = 1e-4,
    t0: float = 10.0,
    noise0: float = 1.0,
    t_range: Tuple[float, float] = (1e-2, 1e3),
    noise_range: Tuple[float, float] = (1e-3, 1e1),
    n_grid: int = 8,
    adam_steps: int = 400,
    adam_lr: float = 0.05,
    dtype: torch.dtype = torch.float32,
    device=None,
    lanes: int = 1,
) -> GprOptResult:
    """Per-point-noise variant: minimize fn(t, noise_vec) over m+1
    parameters a lane; ``fn`` takes t of shape (lanes, G) and noise of shape
    (lanes, G, m).

    Seeding as in :func:`minimize_t_noise`: a coarse log-grid over (t,
    homoscedastic noise), joined by the point (t0, noise0), picks the
    starting basin; Adam then runs over the full (t, noise-vector) space.
    The result's noise has shape (lanes, m), its other fields (lanes,)."""
    device = resolve_device(device, "minimize_t_noisevec")
    ts = _log_grid(t_range, n_grid, dtype, device)
    ns = _log_grid(noise_range, n_grid, dtype, device)
    T, Nz = torch.meshgrid(ts, ns, indexing="ij")
    flatT = torch.cat([T.reshape(-1), torch.full((1,), t0, dtype=dtype, device=device)])
    flatN = torch.cat([Nz.reshape(-1), torch.full((1,), noise0, dtype=dtype, device=device)])
    ts0, ns0, f0 = _coarse_seeds(lambda t, nz: fn(t, nz[..., None].expand(*nz.shape, m)),
                                 flatT, flatN, lanes)

    def obj_flat(x):
        return fn(t_lb + torch.exp(x[:, :1]), noise_lb + torch.exp(x[:, None, 1:]))[:, 0]

    def to_x(t, noise):
        return torch.cat([_to_log(t, t_lb)[:, None], _to_log(noise, noise_lb)], dim=-1)

    res = adam_minimize(obj_flat, to_x(ts0, ns0[:, None].expand(lanes, m)), steps=adam_steps,
                        lr=adam_lr)
    # keep the better of (Adam iterate, grid seed), like the scalar variant
    better = res.obj < f0
    t_out = torch.where(better, t_lb + torch.exp(res.x[:, 0]), ts0)
    n_out = torch.where(better[:, None], noise_lb + torch.exp(res.x[:, 1:]),
                        ns0[:, None].expand(lanes, m))
    g_out = _value_and_grad(obj_flat, to_x(t_out, n_out))[1]
    return GprOptResult(t_out, n_out, torch.minimum(res.obj, f0), torch.linalg.norm(g_out, dim=-1))
