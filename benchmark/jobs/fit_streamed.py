"""The streamed-fit job: one client fitting one out-of-core model after
another (a closed loop), as ``jobs/fit.py`` fits its in-memory models.

A traffic mix of this job sets ``subsample``, ``min_fits`` and
``check_rows`` as for ``jobs/fit.py``, whose seeds, checked fit and window it
shares: the same ``setup_s``, ``fit_s`` and ``peak_mem_GiB``, and a fit that
raises counts as failed.  Set-up draws the data from the seed on the host
(the frozen ``lib/datasets.py``), writes all n rows as one float32 FLGP0001
file, the m training rows first, into a temporary directory that lives as
long as the data, loads the kernel library and the host library, and runs one
warm-up fit; each fit streams the file (``MatrixFile``) through the port's
out-of-core driver, draws from its own generator seed and ends in
``torch.cuda.synchronize()``.  What the reference reads of the checked fit:
the reservoir sample, the anchors and counts, the ELL graph, the spectrum's
values and its vectors at the checked rows, t, the posterior mean and labels
at every test row, and the posterior variance at the checked test rows.

    python3 benchmark/jobs/fit_streamed.py --workload <name> --seeds <n> ... [--sound | --fault <f>]

on the card reads, for each seed, the control of the cell's comparison (the
reference one precision down, in the program's place), or with ``--sound``
one fit of the unbroken program, or with ``--fault`` one fit with a fault of
``FAULTS`` planted where the streamed path calls it, and prints one JSON line
a seed: the readings and whether the limits call them correct.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
import weakref
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    _BENCH = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_BENCH.parent), str(_BENCH)]

from jobs.fit import Run, _sync, checked, fit_config, seed_of  # noqa: E402
from lib import cells, datasets, faults, probe  # noqa: E402
from lib.judge import judge  # noqa: E402
from lib.trace import breakdown, busy_seconds, profiled  # noqa: E402

STREAMING = "flgp_tpu_torch.fit.streaming"


class FileData:
    """The cell's data as its fits see them: ``path``, the FLGP0001 file of
    all n rows (float32, the training rows first), and the labels.  The file's
    directory goes with the object."""

    def __init__(self, split: datasets.Split):
        from flgp_tpu_torch import native

        directory = tempfile.mkdtemp(prefix="flgp_streamed_")
        weakref.finalize(self, shutil.rmtree, directory, True)
        self.path = os.path.join(directory, "x.flgp")
        native.write_matrix(self.path, np.concatenate([split.x_train, split.x_test])
                            .astype(np.float32))
        self.y_train, self.y_test = split.y_train, split.y_test
        self.m = len(split.y_train)
        self.n = self.m + len(split.y_test)


def make_data(cell, seed: int) -> FileData:
    return FileData(datasets.make(cell.config["data"], seed_of(seed, 0) % (1 << 32)))


class StreamCapture(probe.Capture):
    """``probe.Capture`` over the streamed path's own calls."""

    WRAPS = {"sample": (STREAMING, "reservoir_sample"),
             "subsample": (STREAMING, "streamed_subsample"),
             "graph": (STREAMING, "streamed_ell_graph"),
             "spectrum": (STREAMING, "spectrum_fused")}


def _take(capture: StreamCapture, res, rows: torch.Tensor, m: int) -> dict:
    """The checked fit's outputs, moved to the host."""
    got = capture.got
    sub, Z, eig = got["subsample"], got["graph"], got["spectrum"]
    dev = eig.vectors.device
    return dict(sample=np.array(got["sample"]), centers=sub.centers.cpu(),
                counts=sub.counts.cpu(), idx=Z.indices.cpu(), w=Z.values.cpu(),
                values=eig.values.cpu(), vectors=eig.vectors[rows.to(dev)].cpu(),
                t=np.atleast_1d(res.pars["t"].cpu().numpy()),
                mean=res.post_mean[m:].cpu().numpy(), var=res.post_var[rows[m:].to(dev)].cpu(),
                y_test=res.labels[m:].cpu().numpy())


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    from flgp_tpu_torch import native
    from flgp_tpu_torch.fit import streaming

    config, traffic = cell.config, cell.traffic
    if device.type == "cuda":
        from flgp_tpu_torch.ops import _build

        _build.load()          # the nvcc build, on a checkout's first run, lands here
    data = make_data(cell, seed)           # writing the file loads the host library (g++)
    cfg = fit_config(config, traffic)
    entry = getattr(streaming, config["entry"])
    chunk_rows = config["stream"]["chunk_rows"]
    m, n_test = data.m, data.n - data.m
    checked_fit, rows = checked(seed, traffic, m, n_test)
    mat = native.MatrixFile(data.path)
    train_idx = np.arange(m)

    def fit(i: int):
        gen = torch.Generator(device=device).manual_seed(seed_of(seed, 2, i) if i >= 0
                                                         else seed_of(seed, 3))
        return entry(gen, mat, data.y_train, train_idx, cfg=cfg, chunk_rows=chunk_rows,
                     device=device)

    capture = StreamCapture()
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
                    out = _take(capture, res, rows, m)
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
            shape = dict(n=data.n, s=config["graph"]["s"], r=config["graph"]["r"],
                         d=mat.shape[1])
            with probe.Spans(synced=False, device=device).installed():
                state.trace = profiled(lambda: fit(attempted), shape)
            result.update(busy_s=busy_seconds(state.trace),
                          traced_window_s=state.trace.window[1] - state.trace.window[0],
                          breakdown=breakdown(state.trace))
        result["run"] = state
    mat.close()
    return result


# ---------------------------------------------------------------------------
# the control, the sound readings and the faults of this job's cells
# ---------------------------------------------------------------------------


def _first_test_row(field: int, change):
    """The tail's output ``field`` (0 labels, 2 mean) with ``change`` applied
    at the first test row, as the tail hands it back to the fit."""
    def make(orig):
        def tail(generator, eig, Y, N, train_idx, *args, **kwargs):
            outs = list(orig(generator, eig, Y, N, train_idx, *args, **kwargs))
            row = int(train_idx.shape[0])             # the training rows come first
            outs[field] = outs[field].clone()
            outs[field][row] = change(outs[field][row])
            return tuple(outs)
        return tail
    return make


def _var_halved(orig):
    def tail(*args, **kwargs):
        labels, probs, mean, var = orig(*args, **kwargs)
        return labels, probs, mean, 0.5 * var
    return tail


def _reseeded(orig):
    def sample(mat, size, chunk_rows=1 << 16, seed=0):
        return orig(mat, size, chunk_rows, seed + 1)
    return sample


def _tail_uncounted(orig):
    def stream(mat, chunk_rows, device, consume, *args, **kwargs):
        if getattr(consume, "__name__", "") != "count_pass":
            return orig(mat, chunk_rows, device, consume, *args, **kwargs)
        rows = min(chunk_rows, mat.shape[0])
        last = (mat.shape[0] - 1) // rows * rows

        def counted(lo, chunk):
            if lo < last:
                consume(lo, chunk)
        return orig(mat, chunk_rows, device, counted, *args, **kwargs)
    return stream


KMEANS = "flgp_tpu_torch.ops.kmeans"

# each replaces one function where the streamed path calls it, for the
# duration of a ``with``:
# - state_unchanged, half_the_batch: ``lib/faults.py``'s Lloyd faults, in the
#   sample's k-means;
# - sample_reseeded: the reservoir draws its sample from seed 1, not 0;
# - tail_uncounted: the count pass skips the file's last chunk (an
#   off-by-one in the chunk loop);
# - t_shrunk, t_lower_bound: ``lib/faults.py``'s, on the t the streamed
#   fit's training returns;
# - mean_altered: the first test row's posterior mean has the other sign;
# - var_altered: every row's posterior variance is half its value (the
#   variance is judged at the sampled test rows, which a single row would miss);
# - answer_altered: the first test row's label is the other class.
FAULTS = {
    "state_unchanged": (KMEANS, "_update", faults._unchanged),
    "half_the_batch": (KMEANS, "_segment_sums", faults._half),
    "sample_reseeded": (STREAMING, "reservoir_sample", _reseeded),
    "tail_uncounted": (STREAMING, "_stream_chunks", _tail_uncounted),
    "t_shrunk": (STREAMING, "_train_gpc", faults._t_scaled(0.1)),
    "t_lower_bound": (STREAMING, "_train_gpc", faults._t_lower_bound),
    "mean_altered": (STREAMING, "_gpc_lowrank_tail", _first_test_row(2, lambda v: -v)),
    "var_altered": (STREAMING, "_gpc_lowrank_tail", _var_halved),
    "answer_altered": (STREAMING, "_gpc_lowrank_tail", _first_test_row(0, lambda v: 1.0 - v)),
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
    return cells.reference(cell).check(res["data"], res["out"], cell.config, res["rows"], device)


def control_readings(cell, seed: int, device: torch.device) -> dict:
    """The readings of the control on the data of ``seed``, the rows checked
    drawn as a run draws them."""
    ref = cells.reference(cell)
    data = make_data(cell, seed)
    _, rows = checked(seed, cell.traffic, data.m, data.n - data.m)
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
        print("fit_streamed: needs a CUDA device", file=sys.stderr)
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
