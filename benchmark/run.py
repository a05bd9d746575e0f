"""Run one cell of the benchmark of btsbot_tpu_torch on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: set-up (the weights and inputs made from the seed, the
program's objects built and every shape the cell uses warmed up), then the
measured window of ``--seconds``, then the comparison with the plain
reference that decides ``correct``.  The last line of standard output is one
JSON object: ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.  Each compared
number is printed beside its limit, last on standard error and last in the
JSON line.  Without a CUDA card the run exits with 2 and prints no result;
if JAX or the JAX package is loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             cell_factory=None) -> dict:
    """Set-up, window and comparison of one cell; returns the result line's
    object.  ``device`` None is the card; the tests pass the CPU.
    ``cell_factory(ctx)`` builds the cell in place of its driver's ``Cell``."""
    import torch

    from benchmark import harness

    bench = harness.load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    dev = torch.device(device or "cuda:0")
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{workload} needs {entry['chips']} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
                  file=sys.stderr)
            raise SystemExit(2)
    cfg = harness.load_json("configs", entry["config"])
    traffic = harness.load_json("traffic", entry["traffic"])
    ctx = harness.Context(workload=workload, seed=seed, device=dev, cfg=cfg, traffic=traffic)
    driver = harness.load_module("drivers", traffic["driver"])
    cell = (cell_factory or driver.Cell)(ctx)

    cell.setup()
    setup_s = time.perf_counter() - T_START
    window = harness.TraceWindow(bool(trace), traffic.get("trace_seconds"), dev)
    out = cell.window(seconds, window)
    window.stop()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = window.read()
    cell.release()
    checks = cell.checks()

    metrics = {}
    for m in bench["end_to_end"] if not trace else bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        if m["name"] == "setup_s":
            value = setup_s
        elif not trace:
            value = out["metrics"].get(m["name"])
        else:
            run = harness.LayerRun(trace=traced, counters=out.get("counters", {}), cfg=cfg)
            value = harness.load_module("layer_metrics", m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": int(memory_peak),
                   "power_limit": power_limit() if dev.type == "cuda" else "none"}
    result = {"correct": all(c.ok for c in checks), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    # a number that could not be taken (no answer came) is written as text
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value),
                                 "limit": c.limit} for c in checks}
    for name, value in out.get("counters", {}).items():
        if isinstance(value, (int, float)):
            print(f"counter {name} = {value!r}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    from benchmark.harness import forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = isinstance(c["value"], (int, float)) and c["value"] <= c["limit"]
        verdict = "ok" if ok else "FAILED"
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}) {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
