"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 8 [--control 1]

For each seed, in one process: the cell's set-up, a window of ``--seconds``
and its comparisons (the program's readings), and with ``--control 1`` the
control's readings on the same seed's inputs (the lower precision that each
limit has to fail); with ``--fault NAME`` the set-up and window run with
that fault of ``faults.py`` planted.  One JSON line a seed.  Not part of a
benchmark run.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None, help="a fault of faults.py planted in the program")
    args = p.parse_args()
    bench = harness.load_benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = harness.load_json("configs", entry["config"])
    traffic = harness.load_json("traffic", entry["traffic"])
    driver = harness.load_module("drivers", traffic["driver"])
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, seed, dev, cfg, traffic)
        cell = driver.Cell(ctx)
        with (FAULTS[traffic["driver"]][args.fault]() if args.fault
              else contextlib.nullcontext()):
            cell.setup()
            out = cell.window(args.seconds, harness.TraceWindow(False, None, dev))
        cell.release()
        row = {"seed": seed, "program": {c.name: c.value for c in cell.checks()},
               "metrics": out["metrics"], "worst_leaves": getattr(cell, "worst_leaves", None), "fault": args.fault}
        if args.control:
            row["control"] = {c.name: c.value for c in cell.control()}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
