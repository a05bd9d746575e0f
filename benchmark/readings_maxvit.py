"""The readings that the MaxViT cell's limits of ``correct`` are set from.

    python3 benchmark/readings_maxvit.py --seeds 1,2,3 --seconds 8 [--control 1] [--fault NAME]

As ``readings.py``, for ``maxvit-archive``: for each seed, in one process,
the cell's set-up, a window of ``--seconds`` and its comparisons (the
program's readings); with ``--control 1`` the control's readings on the
same seed's inputs; with ``--fault NAME`` the set-up and window run with
that fault of ``faults_maxvit.py`` planted.  One JSON line a seed.  Not
part of a benchmark run.
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
from benchmark.faults_maxvit import FAULTS  # noqa: E402

WORKLOAD = "maxvit-archive"


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None, choices=sorted(FAULTS))
    args = p.parse_args()
    entry = next(w for w in harness.load_benchmark()["workloads"] if w["name"] == WORKLOAD)
    cfg = harness.load_json("configs", entry["config"])
    traffic = harness.load_json("traffic", entry["traffic"])
    driver = harness.load_module("drivers", traffic["driver"])
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = driver.Cell(harness.Context(WORKLOAD, seed, dev, cfg, traffic))
        with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            cell.setup()
            out = cell.window(args.seconds, harness.TraceWindow(False, None, dev))
        cell.release()
        row = {"seed": seed, "program": {c.name: c.value for c in cell.checks()},
               "metrics": out["metrics"], "fault": args.fault}
        if args.control:
            row["control"] = {c.name: c.value for c in cell.control()}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del cell
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
