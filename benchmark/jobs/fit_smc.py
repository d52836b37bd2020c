"""The hyperposterior job: one client running one ten-class hyperposterior
after another (a closed loop), as ``jobs/fit.py`` fits its point models.

A traffic mix of this job sets ``subsample``, ``min_fits`` and
``check_rows`` as for ``jobs/fit.py``, whose seeds, checked fit and window it
shares: the same ``setup_s``, ``fit_s`` and ``peak_mem_GiB``, and a fit that
raises counts as failed.  One fit is the user's whole job, composed of the
port's public functions as ``fit_lae_logit_mult_gp`` composes its first
stages: the upload of the points and labels (``utils.metrics.to_device``),
``fit.spectral.build_spectrum``, the pair cast to the solve dtype
(``fit.drivers._solve_cast``), ``fit.multiclass.one_hot_labels``, then
``inference.hyperparam.mult_t_posterior`` over the ten classes' log t at the
configuration's ``hyperposterior`` settings; it draws from its own generator
seed, runs as one of the recorder's fits (``utils.metrics.fit_entry``, so the
counter readers see its counts) and ends in ``torch.cuda.synchronize()``.
What the reference reads of the checked fit: the anchors and counts, the kNN
lists and weights, the spectrum's values and its vectors at the checked rows,
the final particles of log t and the log evidence.

    python3 benchmark/jobs/fit_smc.py --workload <name> --seeds <n> ... [--sound | --fault <f>]

on the card reads, for each seed, the control of the cell's comparison (the
reference one precision down, in the program's place), or with ``--sound``
one fit of the unbroken program, or with ``--fault`` one fit with a fault of
``FAULTS`` planted where the path calls it, and prints one JSON line a seed:
the readings and whether the limits call them correct.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    _BENCH = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_BENCH.parent), str(_BENCH)]

from jobs.fit import Run, _sync, checked, seed_of  # noqa: E402
from lib import cells, datasets, faults, probe  # noqa: E402
from lib.judge import judge  # noqa: E402
from lib.trace import breakdown, busy_seconds, profiled  # noqa: E402

SMC = "flgp_tpu_torch.inference.smc"
HYPERPARAM = "flgp_tpu_torch.inference.hyperparam"


def make_data(cell, seed: int) -> datasets.Split:
    return datasets.make(cell.config["data"], seed_of(seed, 0) % (1 << 32))


def fit_config(config: dict, traffic: dict):
    import flgp_tpu_torch as ft

    graph = {k: v for k, v in config["graph"].items() if k != "lae_iters"}
    fit = config["fit"]
    return ft.FitConfig(graph=ft.GraphConfig(subsample=traffic["subsample"], **graph),
                        sigma=fit["sigma"], dtype=getattr(torch, fit["dtype"]),
                        solve_dtype=getattr(torch, fit["solve_dtype"]))


def posterior_kwargs(config: dict) -> dict:
    """``mult_t_posterior``'s keyword arguments from the configuration."""
    h = config["hyperposterior"]
    return dict(n_particles=h["n_particles"], n_mutation_steps=h["n_mutation_steps"],
                p=h["prior_p"], q=h["prior_q"], tau=h["prior_tau"], mu0=h["mu0"], s0=h["s0"],
                newton_tol=h["newton_tol"], newton_max_iter=h["newton_max_iter"],
                stages_per_dispatch=h["stages_per_dispatch"])


def job(data: datasets.Split, config: dict, cfg, device: torch.device):
    """The user's job as one function of (generator) -> the posterior."""
    from flgp_tpu_torch.config import pin_full_precision
    from flgp_tpu_torch.fit import drivers, spectral
    from flgp_tpu_torch.fit.multiclass import one_hot_labels
    from flgp_tpu_torch.inference import hyperparam
    from flgp_tpu_torch.utils import metrics

    m, J = data.x_train.shape[0], config["classes"]
    K = min(cfg.graph.resolved_K(), cfg.graph.s, m + data.x_test.shape[0])
    kw = posterior_kwargs(config)

    @metrics.fit_entry
    def one(generator):
        pin_full_precision()
        X_all = torch.cat([metrics.to_device(data.x_train, cfg.dtype, device),
                           metrics.to_device(data.x_test, cfg.dtype, device)])
        Y = metrics.to_device(data.y_train, cfg.dtype, device)
        eig, _ = spectral.build_spectrum(generator, X_all, cfg.graph)
        _, seig, (aug,) = drivers._solve_cast(cfg, eig, one_hot_labels(Y, J))
        idx = torch.arange(m, device=device)
        post = hyperparam.mult_t_posterior(generator, seig, aug, idx, K, cfg.sigma,
                                           device=device, **kw)
        return eig, post

    return one


class SmcCapture(probe.Capture):
    """``probe.Capture`` over the graph stage and the hyperposterior."""

    WRAPS = dict(probe.Capture.WRAPS, posterior=(HYPERPARAM, "mult_t_posterior"))


def _take(capture: SmcCapture, eig, rows: torch.Tensor) -> dict:
    """The checked fit's outputs, moved to the host."""
    got = capture.got
    sub, knn, w, post = got["subsample"], got["knn"], got["lae_weights"], got["posterior"]
    return dict(centers=sub.centers.cpu(), counts=sub.counts.cpu(), idx=knn.indices.cpu(),
                w=w.cpu(), values=eig.values.cpu(),
                vectors=eig.vectors[rows.to(eig.vectors.device)].cpu(),
                theta=post.smc.particles.cpu(), log_evidence=float(post.log_evidence),
                n_stages=int(post.smc.n_stages))


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    config, traffic = cell.config, cell.traffic
    if device.type == "cuda":
        from flgp_tpu_torch.ops import _build

        _build.load()          # the nvcc build, on a checkout's first run, lands here
    data = make_data(cell, seed)
    one = job(data, config, fit_config(config, traffic), device)
    m, n_test = data.x_train.shape[0], data.x_test.shape[0]
    checked_fit, rows = checked(seed, traffic, m, n_test)

    def fit(i: int):
        gen = torch.Generator(device=device).manual_seed(seed_of(seed, 2, i) if i >= 0
                                                         else seed_of(seed, 3))
        return one(gen)

    capture = SmcCapture()
    out, attempted, failed, walls = None, 0, 0, []
    with capture.installed():
        fit(-1)                                  # warm-up: the cell's own shapes
        _sync(device)
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        spans = probe.Spans(synced=True, device=device)
        state = Run()
        w0 = time.perf_counter()
        with spans.installed() if trace else contextlib.nullcontext():
            while True:
                capture.armed = attempted == checked_fit
                spans.seconds.clear()
                attempted += 1
                f0 = time.perf_counter()
                try:
                    res = fit(attempted - 1)
                    _sync(device)
                    walls.append(time.perf_counter() - f0)
                except RuntimeError as exc:          # a fit that fails counts, the loop goes on
                    print(f"fit {attempted - 1} failed: {exc}", flush=True)
                    failed += 1
                    res = None
                if capture.armed and res is not None:
                    out = _take(capture, res[0], rows)
                capture.armed = False
                capture.got.clear()
                if trace:
                    state.fit_spans.append(dict(spans.seconds))
                del res
                if time.perf_counter() - w0 >= seconds and attempted >= traffic["min_fits"]:
                    break
        window_s = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        result = dict(attempted=attempted, failed=failed, fit_walls=walls,
                      memory_peak_bytes=max(peak, setup_peak), out=out, rows=rows, data=data,
                      metrics={"setup_s": setup_s, "fit_s": window_s / max(attempted - failed, 1),
                               "peak_mem_GiB": peak / 2**30})
        if trace and device.type == "cuda":
            shape = dict(n=m + n_test, s=config["graph"]["s"], r=config["graph"]["r"],
                         d=data.x_train.shape[1])
            with probe.Spans(synced=False, device=device).installed():
                state.trace = profiled(lambda: fit(attempted), shape)
            result.update(busy_s=busy_seconds(state.trace),
                          traced_window_s=state.trace.window[1] - state.trace.window[0],
                          breakdown=breakdown(state.trace))
        result["run"] = state
    return result


# ---------------------------------------------------------------------------
# the control, the sound readings and the faults of this job's cells
# ---------------------------------------------------------------------------


def _beta_one(orig):
    def next_beta(ll, beta, min_ess):
        return torch.ones_like(beta)
    return next_beta


def _unmutated(orig):
    def mutate(generator, target, x, lp, step, n_steps):
        return x, torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    return mutate


def _t_tenfold(orig):
    def phi(V_idx, lam, t):
        return orig(V_idx, lam, 10.0 * t)
    return phi


def _class_dropped(orig):
    def marginal(*args, **kwargs):
        mll = orig(*args, **kwargs).clone()
        mll[..., 0] = 0.0
        return mll
    return marginal


# each replaces one function where the hyperposterior's path calls it, for the
# duration of a ``with``:
# - tempering_skipped: the first stage's ESS bisection picks β = 1, so the
#   ladder is one importance-sampling step from the prior;
# - unmutated: the random-walk mutations leave the resampled particles as
#   they are;
# - t_scaled: the likelihood (Φ of the Newton solve) is evaluated at 10·t,
#   the base prior and the penalty at t;
# - class_dropped: class 0's Laplace marginal is left out of the summed
#   likelihood, so its particles follow the prior and the penalty alone;
# - state_unchanged: ``lib/faults.py``'s Lloyd fault, under the spectrum.
FAULTS = {
    "tempering_skipped": (SMC, "_next_beta", _beta_one),
    "unmutated": (SMC, "_mutate_rwm", _unmutated),
    "t_scaled": (HYPERPARAM, "_phi", _t_tenfold),
    "class_dropped": (HYPERPARAM, "gpc_marginal_log_likelihood_lowrank", _class_dropped),
    "state_unchanged": ("flgp_tpu_torch.ops.kmeans", "_update", faults._unchanged),
}


@contextlib.contextmanager
def planted(name: str):
    mod_name, attr, make = FAULTS[name]
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def program_readings(cell, fault, seed: int, device: torch.device) -> dict:
    """The readings of one fit of the program with ``fault`` planted (none
    where ``fault`` is None)."""
    one = cell._replace(traffic=dict(cell.traffic, min_fits=1))
    with planted(fault) if fault else contextlib.nullcontext():
        res = run(one, seed, 0.0, False, device, time.perf_counter())
    res.pop("run")
    return dict(cells.reference(cell).check(res["data"], res["out"], cell.config, res["rows"],
                                            device), smc_stages=res["out"]["n_stages"],
                fit_s=res["metrics"]["fit_s"])


def control_readings(cell, seed: int, device: torch.device) -> dict:
    """The readings of the control on the data of ``seed``, the rows checked
    drawn as a run draws them."""
    ref = cells.reference(cell)
    data = make_data(cell, seed)
    _, rows = checked(seed, cell.traffic, data.x_train.shape[0], data.x_test.shape[0])
    out = ref.control_fit(data, cell.config, rows, seed_of(seed, 4), device)
    return ref.check(data, out, cell.config, rows, device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--fault", choices=sorted(FAULTS))
    what.add_argument("--sound", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fit_smc: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = cells.load(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings = (program_readings(cell, args.fault, seed, dev) if args.fault or args.sound
                    else control_readings(cell, seed, dev))
        gc.collect()
        torch.cuda.empty_cache()
        correct, _ = judge(readings, cell.limits)
        read = "sound" if args.sound else args.fault or "control"
        print(json.dumps({"workload": args.workload, "read": read, "seed": seed,
                          "correct": correct, "seconds": time.perf_counter() - t0,
                          "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
