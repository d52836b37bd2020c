"""The grid-fit job: one client fitting one regression with a bandwidth grid
after another (a closed loop), as ``jobs/fit.py`` fits its models.

A traffic mix of this job sets ``subsample``, ``min_fits`` and
``check_rows`` as for ``jobs/fit.py``, whose seeds, checked fit and
window it shares: the same ``setup_s``, ``fit_s`` and ``peak_mem_GiB``, and a
fit that raises counts as failed.  The data are the frozen ``lib/spiral.py``
copy's, drawn once from the seed on the host in float64; each fit draws from
its own generator seed.  What the reference reads of the checked fit: the
anchors and kNN lists, every bandwidth's eigenvalues and trained (t, noise,
objective), the selected a², t and noise, and the predictive mean and
variance at the test rows.

    python3 benchmark/jobs/fit_grid.py --workload <name> --seeds <n> ... [--sound | --fault <f>]

on the card reads, for each seed, the control of the cell's comparison (the
reference one precision down, in the program's place), or with ``--sound``
one fit of the unbroken program, or with ``--fault`` one fit with a fault of
``FAULTS`` planted under the timed path, and prints one JSON line a seed: the
readings and whether the limits call them correct.  ``benchmark/control.py``
does this for the cells of ``jobs/fit.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import sys
import time
from pathlib import Path

import torch

if __name__ == "__main__":
    _BENCH = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_BENCH.parent), str(_BENCH)]

from jobs.fit import Run, _sync, checked, seed_of  # noqa: E402
from lib import cells, probe, spiral  # noqa: E402
from lib.judge import judge  # noqa: E402
from lib.trace import breakdown, busy_seconds, profiled  # noqa: E402

DRIVERS = "flgp_tpu_torch.fit.drivers"


def fit_config(config: dict, traffic: dict):
    import flgp_tpu_torch as ft

    fit = dict(config["fit"], a2s=tuple(config["fit"]["a2s"]))
    for key in ("dtype", "solve_dtype"):
        fit[key] = getattr(torch, fit[key])
    train = dict(config["train"])
    train["prior_p_gpr"] = train.pop("prior_p")
    return ft.FitConfig(graph=ft.GraphConfig(subsample=traffic["subsample"], **config["graph"]),
                        train=ft.TrainConfig(**train), **fit)


class GridCapture(probe.Capture):
    """``probe.Capture``, each bandwidth's eigenvalues in turn, and every
    lane's training."""

    WRAPS = dict(probe.Capture.WRAPS, grid=("flgp_tpu_torch.fit.spectral", "se_spectrum_at"),
                 lanes=(DRIVERS, "_train_gpr"))

    def _make(self, key):
        if key != "grid":
            return super()._make(key)

        def make(orig):
            @functools.wraps(orig)
            def wrapper(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self.armed:
                    self.got.setdefault("grid", []).append(out.values)
                return out
            return wrapper
        return make


def _take(capture: GridCapture, res) -> dict:
    """The checked fit's outputs, moved to the host."""
    sub, knn, lanes = capture.got["subsample"], capture.got["knn"], capture.got["lanes"]
    return dict(centers=sub.centers.cpu(), counts=sub.counts.cpu(), idx=knn.indices.cpu(),
                values=torch.stack(capture.got["grid"]).cpu(), lane_t=lanes.t.cpu(),
                lane_noise=lanes.noise.cpu(), lane_obj=lanes.obj.cpu(), a2=float(res.pars["a2"]),
                t=float(res.pars["t"]), noise=float(res.pars["noise"]),
                mean=res.posterior_mean, var=res.posterior_cov)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    import flgp_tpu_torch as ft

    config, traffic = cell.config, cell.traffic
    if device.type == "cuda":
        from flgp_tpu_torch.ops import _build

        _build.load()          # the nvcc build, on a checkout's first run, lands here
    data = spiral.make(config["data"], seed_of(seed, 0) % (1 << 32))
    cfg = fit_config(config, traffic)
    entry = getattr(ft, config["entry"])
    m, n_test = data.x_train.shape[0], data.x_test.shape[0]
    checked_fit, rows = checked(seed, traffic, m, n_test)

    def fit(i: int):
        gen = torch.Generator(device=device).manual_seed(seed_of(seed, 2, i) if i >= 0
                                                         else seed_of(seed, 3))
        return entry(gen, data.x_train, data.y_train, data.x_test, cfg=cfg, device=device)

    capture = GridCapture()
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
                    out = _take(capture, res)
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


def _scaled(field: str, factor: float):
    def make(orig):
        def train(*args, **kwargs):
            res = orig(*args, **kwargs)
            return res._replace(**{field: factor * getattr(res, field)})
        return train
    return make


def _neighbour(orig):
    def first_min(objs):
        i = orig(objs)
        return i + 1 if i + 1 < len(objs) else i - 1
    return first_min


def _half_untrained(orig):
    def train(eigenpair, Y, idx, K, cfg):
        full = orig(eigenpair, Y, idx, K, cfg)
        seeds = orig(eigenpair, Y, idx, K, dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, adam_steps=0)))
        odd = torch.arange(full.t.shape[0], device=full.t.device) % 2 == 1
        return type(full)(*(torch.where(odd, b, a) for a, b in zip(full, seeds)))
    return train


def _mean_moved(orig):
    def to_result(out, *args, **kwargs):
        test = out["test"].clone()
        test[0] += 1.0
        return orig(dict(out, test=test), *args, **kwargs)
    return to_result


def _var_halved(orig):
    def to_result(out, *args, **kwargs):
        cov = out["cov"].clone()
        cov[0] *= 0.5
        return orig(dict(out, cov=cov), *args, **kwargs)
    return to_result


# each replaces one function of the port's drivers for the duration of a ``with``:
# - t_altered: every lane's t, as the training returns it, is ten times what it found;
# - noise_altered: every lane's noise, likewise, is ten times what it found;
# - a2_shifted: the selection takes the neighbouring bandwidth (the next, or the
#   one before at the grid's end), with that lane's t and noise;
# - lanes_untrained: every other bandwidth's lane keeps the coarse grid's best
#   cell, as if left out of the Adam run (half the batch left out);
# - mean_altered: the first test point's predictive mean, as the driver hands it
#   to the result, is one unit (the noise's standard deviation) higher;
# - var_altered: the first test point's predictive variance, likewise, is half
#   what the driver computed.
FAULTS = {
    "t_altered": ("_train_gpr", _scaled("t", 10.0)),
    "noise_altered": ("_train_gpr", _scaled("noise", 10.0)),
    "a2_shifted": ("_first_min", _neighbour),
    "lanes_untrained": ("_train_gpr", _half_untrained),
    "mean_altered": ("_to_result", _mean_moved),
    "var_altered": ("_to_result", _var_halved),
}


@contextlib.contextmanager
def planted(name: str):
    attr, make = FAULTS[name]
    mod = importlib.import_module(DRIVERS)
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
    return cells.reference(cell).check(res["data"], res["out"], cell.config, res["rows"], device)


def control_readings(cell, seed: int, device: torch.device) -> dict:
    """The readings of the control on the data of ``seed``, the rows checked
    drawn as a run draws them."""
    ref = cells.reference(cell)
    data = spiral.make(cell.config["data"], seed_of(seed, 0) % (1 << 32))
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
        print("fit_grid: needs a CUDA device", file=sys.stderr)
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
