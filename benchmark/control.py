"""The control of a cell's comparison: the plain reference, one precision
below what the configuration states, put in the program's place.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it draws the cell's data, runs ``control_fit`` of the cell's
reference (its own anchors, TF32 operands in the graph stage, a float32
tail) on the CUDA device, judges the outputs as a run judges the program's,
and prints one JSON line: the seed, every reading, and whether the limits
call it correct.  A sound limit calls every control run incorrect.

    python3 benchmark/control.py --workload <name> --fault <fault> --seeds <n> ...

reads the program instead, one fit a seed, with a fault of ``lib/faults.py``
planted under it; ``--sound`` reads the program unbroken, the same way, so
that the sound readings of a dozen seeds and more come from one process.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))

import torch  # noqa: E402

from jobs.fit import checked, seed_of  # noqa: E402
from lib import cells, datasets, faults  # noqa: E402
from lib.judge import judge  # noqa: E402


def control_readings(cell, seed: int, device: torch.device) -> dict:
    """The readings of the control on the data of ``seed``, the rows checked
    drawn as a run draws them."""
    ref = cells.reference(cell)
    data = datasets.make(cell.config["data"], seed_of(seed, 0) % (1 << 32))
    _, rows = checked(seed, cell.traffic, data.x_train.shape[0], data.x_test.shape[0])
    out = ref.control_fit(data, cell.config, rows, seed_of(seed, 4), device)
    return ref.check(data, out, cell.config, rows, device)


def fault_readings(cell, fault, seed: int, device: torch.device) -> dict:
    """The readings of one fit of the program with ``fault`` planted (none
    where ``fault`` is None)."""
    from jobs import fit

    one = cell._replace(traffic=dict(cell.traffic, min_fits=1))
    with faults.planted(fault) if fault else contextlib.nullcontext():
        res = fit.run(one, seed, 0.0, False, device, time.perf_counter())
    res.pop("run")
    return cells.reference(cell).check(res["data"], res["out"], cell.config, res["rows"], device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--fault", choices=sorted(faults.FAULTS))
    what.add_argument("--sound", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        dev = torch.device("cuda", 0)
        readings = (fault_readings(cell, args.fault, seed, dev) if args.fault or args.sound
                    else control_readings(cell, seed, dev))
        gc.collect()
        torch.cuda.empty_cache()
        correct, _ = judge(readings, cell.limits)
        read = "sound" if args.sound else args.fault or "control"
        print(json.dumps({"workload": args.workload, "read": read, "seed": seed,
                          "correct": correct,
                          "seconds": time.perf_counter() - t0, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
