"""Hyperparameter sweep CLI: ``python -m btsbot_tpu_torch.cli.sweep <sweep.json>``
(port of btsbot_tpu.cli.sweep).

The reference runs sweeps through wandb.agent (train.py:46-54,569-575),
which needs the wandb service.  This module runs grid or random sweeps
itself — each trial a full ``run_training`` with overridden config keys,
on the CUDA card unless ``--device cpu`` — and logs through the experiment
logger (JSONL by default; wandb when asked and installed, imported only
then).  ``--wandb-sweep-id`` pulls the trials from a wandb sweep server
instead.

Sweep config format (flat JSON)::

    {
      "base_config": "path/to/train_config.json",
      "method": "random",              // or "grid"
      "count": 5,                      // random trials (grid ignores)
      "seed": 0,
      "parameters": {
        "learning_rate": {"values": [1e-4, 3e-4, 1e-3]},
        "meta_dropout": {"min": 0.1, "max": 0.5}   // uniform (random only)
      }
    }
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np

from ..core.config import load_config, normalize_config
from ..engine.train import run_training


def sample_trials(sweep: dict) -> list[dict]:
    params = sweep.get("parameters", {})
    method = sweep.get("method", "grid")
    if method == "grid":
        keys = list(params)
        value_lists = []
        for k in keys:
            if "values" not in params[k]:
                raise ValueError(
                    f"grid sweeps need explicit 'values' for {k}")
            value_lists.append(params[k]["values"])
        return [dict(zip(keys, combo))
                for combo in itertools.product(*value_lists)]
    if method == "random":
        rng = np.random.default_rng(sweep.get("seed", 0))
        trials = []
        for _ in range(int(sweep.get("count", 5))):
            t = {}
            for k, spec in params.items():
                if "values" in spec:
                    t[k] = spec["values"][rng.integers(len(spec["values"]))]
                else:
                    t[k] = float(rng.uniform(spec["min"], spec["max"]))
            trials.append(t)
        return trials
    raise ValueError(f"Unknown sweep method: {method}")


def run_sweep(sweep: dict, data_dir: str = "data", out_root: str = "models",
              logger_kind: str = "jsonl", **run_kwargs) -> list[dict]:
    from ..utils.logging import make_logger

    base = load_config(sweep["base_config"])
    results = []
    for i, overrides in enumerate(sample_trials(sweep)):
        config = normalize_config({**base, **overrides})
        run_name = f"sweep{i:03d}"
        if logger_kind == "jsonl":
            logger = make_logger("jsonl",
                                 path=f"{out_root}/{run_name}_log.jsonl")
        else:
            logger = make_logger(logger_kind, config=dict(config),
                                 run_name=run_name)
        print(f"=== trial {i}: {overrides}")
        result = run_training(config, data_dir=data_dir, out_root=out_root,
                              run_name=run_name, logger=logger, **run_kwargs)
        best_val = float(np.min(result["history"]["val_loss"]))
        results.append({"trial": i, "overrides": overrides,
                        "best_val_loss": best_val,
                        "model_dir": result["model_dir"]})
        logger.finish()
    results.sort(key=lambda r: r["best_val_loss"])
    print("=== sweep results (best first)")
    for r in results:
        print(f"  {r['best_val_loss']:.5f}  {r['overrides']}")
    return results


class _WandbRunLogger:
    """Experiment-logger adapter over a LIVE wandb run (one the sweep agent
    already opened) — unlike utils.logging.WandbLogger it must not call
    wandb.init/finish itself; the agent owns the run lifecycle."""

    def __init__(self, run):
        self.run = run

    def log(self, metrics: dict, step: int | None = None) -> None:
        self.run.log(metrics, step=step)

    def set_summary(self, summary: dict) -> None:
        for k, v in summary.items():
            self.run.summary[k] = v

    def finish(self) -> None:
        pass  # the agent's `with wandb.init()` context closes the run


def run_wandb_agent(sweep_id: str, project: str = "BTSbotv2",
                    count: int = 5, data_dir: str = "data",
                    out_root: str = "models", base_config=None,
                    wandb_api=None, **run_kwargs) -> list[dict]:
    """Drop-in for the reference's wandb sweep entry point
    (train.py:46-54,569-575): the wandb sweep SERVER supplies each trial's
    config; every trial is a full ``run_training`` logging through the live
    run.  ``wandb_api`` is injectable (tests drive a fake agent offline);
    ``base_config`` optionally underlays keys the sweep doesn't vary."""
    if wandb_api is None:
        import wandb as wandb_api  # optional dependency

    base = {}
    if base_config:
        base = base_config if isinstance(base_config, dict) \
            else load_config(base_config)
    results: list[dict] = []

    def trial():
        with wandb_api.init() as run:
            config = normalize_config({**base, **dict(run.config)})
            result = run_training(
                config, data_dir=data_dir, out_root=out_root,
                run_name=str(run.name), logger=_WandbRunLogger(run),
                **run_kwargs)
            results.append({
                "trial": len(results), "run_name": str(run.name),
                "best_val_loss": float(
                    np.min(result["history"]["val_loss"])),
                "model_dir": result["model_dir"]})

    wandb_api.agent(sweep_id, function=trial, count=count, project=project)
    return results


def main(argv=None):
    """Returns the trials' results, best first (a local sweep)."""
    p = argparse.ArgumentParser(description="Run a hyperparameter sweep")
    p.add_argument("sweep_config", nargs="?",
                   help="native sweep JSON (omit with --wandb-sweep-id)")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--out-root", default="models")
    p.add_argument("--logger", default="jsonl",
                   choices=["jsonl", "wandb", "null"])
    p.add_argument("--wandb-sweep-id",
                   help="pull trial configs from a wandb sweep server "
                        "(reference train.py:569-575 workflow) instead of "
                        "a local sweep JSON")
    p.add_argument("--project", default="BTSbotv2")
    p.add_argument("--count", type=int, default=5)
    p.add_argument("--base-config",
                   help="config underlay for keys the wandb sweep "
                        "doesn't vary")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.wandb_sweep_id:
        if args.sweep_config:
            p.error("a local sweep JSON and --wandb-sweep-id are mutually "
                    "exclusive — the wandb server supplies the trial "
                    "configs")
        run_wandb_agent(args.wandb_sweep_id, project=args.project,
                        count=args.count, data_dir=args.data_dir,
                        out_root=args.out_root,
                        base_config=args.base_config, make_figure=False,
                        device=args.device)
        return
    if not args.sweep_config:
        p.error("provide a sweep JSON or --wandb-sweep-id")
    with open(args.sweep_config) as f:
        sweep = json.load(f)
    return run_sweep(sweep, data_dir=args.data_dir, out_root=args.out_root,
                     logger_kind=args.logger, make_figure=False, device=args.device)


if __name__ == "__main__":
    main()
