"""The fit job: one client fitting one model after another (a closed loop).

A traffic mix of this job (``benchmark/traffic/<mix>.json``) sets
``subsample`` (the anchor method the client asks for), ``min_fits`` (the
fewest fits the window holds; the checked fit is drawn from the first
``min_fits``) and ``check_rows`` (the test rows, drawn from the seed, at which
the eigenvectors are compared).  The data are drawn once from the seed, on
the host in float64, as users pass them; each fit draws from its own
generator seed, taken from the run's seed and the fit's index.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from lib import datasets, probe
from lib.trace import breakdown, busy_seconds, profiled


def seed_of(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of the run's seed."""
    hi, lo = np.random.SeedSequence([seed % (1 << 64), *path]).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def checked(seed: int, traffic: dict, m: int, n_test: int) -> tuple:
    """(index of the fit the reference judges, the rows at which its
    eigenvectors are compared: the m training rows and a sample of test rows),
    both drawn from the seed."""
    pick = np.random.default_rng(seed_of(seed, 1))
    fit = int(pick.integers(traffic["min_fits"]))
    sample = np.sort(pick.choice(n_test, traffic["check_rows"], replace=False)) + m
    return fit, torch.as_tensor(np.concatenate([np.arange(m), sample]))


class Run:
    """What the per-layer readers read: the synced spans of the window's fits
    and the profiled fit's trace."""

    def __init__(self):
        self.fit_spans = []
        self.trace = None

    def span_mean(self, name: str):
        vals = [f[name] for f in self.fit_spans if name in f]
        return sum(vals) / len(vals) if vals else None


def fit_config(config: dict, traffic: dict):
    import flgp_tpu_torch as ft

    graph = {k: v for k, v in config["graph"].items() if k != "lae_iters"}
    fit = dict(config["fit"])
    train = {k: v for k, v in config["train"].items() if k not in ("prior_p", "t_top")}
    train["prior_p_gpc"] = config["train"]["prior_p"]
    for key in ("dtype", "solve_dtype"):
        fit[key] = getattr(torch, fit[key])
    return ft.FitConfig(graph=ft.GraphConfig(subsample=traffic["subsample"], **graph),
                        train=ft.TrainConfig(**train), **fit)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _take(capture: probe.Capture, res, rows: torch.Tensor) -> dict:
    """The checked fit's outputs, moved to the host."""
    sub, knn, w = capture.got["subsample"], capture.got["knn"], capture.got["lae_weights"]
    eig = res.eigenpair
    return dict(centers=sub.centers.cpu(), counts=sub.counts.cpu(), idx=knn.indices.cpu(),
                w=w.cpu(), values=eig.values.cpu(), vectors=eig.vectors[rows.to(
                    eig.vectors.device)].cpu(), t=np.atleast_1d(res.pars["t"]),
                mean=res.posterior_mean, y_test=res.y_test)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    import flgp_tpu_torch as ft

    config, traffic = cell.config, cell.traffic
    if device.type == "cuda":
        from flgp_tpu_torch.ops import _build

        _build.load()          # the nvcc build, on a checkout's first run, lands here
    data = datasets.make(config["data"], seed_of(seed, 0) % (1 << 32))
    cfg = fit_config(config, traffic)
    entry = getattr(ft, config["entry"])
    m, n_test = data.x_train.shape[0], data.x_test.shape[0]
    checked_fit, rows = checked(seed, traffic, m, n_test)

    def fit(i: int):
        gen = torch.Generator(device=device).manual_seed(seed_of(seed, 2, i) if i >= 0
                                                         else seed_of(seed, 3))
        return entry(gen, data.x_train, data.y_train, data.x_test, cfg=cfg, device=device)

    capture = probe.Capture()
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
                    out = _take(capture, res, rows)
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

