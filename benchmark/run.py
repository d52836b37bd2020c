"""Run one cell of the benchmark of flgp_tpu_torch and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the kernel library, the data,
one warm-up fit of the cell's shapes) is timed as ``setup_s``; then fits run
one after another for ``--seconds``; then the plain reference judges one fit
drawn from the seed.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (synced spans over the window, then one
profiled fit).  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.  Without a CUDA device, or with fewer than the cell asks for, it exits
with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))

import torch  # noqa: E402

from lib import cells  # noqa: E402
from lib.judge import judge  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "flgp_tpu"}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float) -> tuple:
    """(result line, every reading of the reference) for one run of ``cell``."""
    res = cells.job(cell).run(cell, seed, seconds, trace, device, t0)
    run = res.pop("run")
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    # the program's state is gone with the job's frame; the reference runs after
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if res["out"] is None:
        readings = {}
    else:
        readings = cells.reference(cell).check(res["data"], res["out"], cell.config, res["rows"],
                                               device)
    correct, checks = judge(readings, cell.limits)
    correct = correct and res["failed"] == 0
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": res["memory_peak_bytes"], "power_limit": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace and "busy_s" in res:
        dev.update(busy_s=res["busy_s"], window_s=res["traced_window_s"])
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if trace and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    return line, dict(readings, fit_walls=res["fit_walls"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line, readings = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"benchmark: the run loaded {loaded}, which nothing it runs may import",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    print("fit walls: " + json.dumps(readings.pop("fit_walls")), file=sys.stderr)
    print("readings: " + json.dumps(readings), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
