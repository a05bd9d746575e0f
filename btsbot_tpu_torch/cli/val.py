"""Validation CLI: ``python -m btsbot_tpu_torch.cli.val <model_dir> [options]``.

The port of ``python -m btsbot_tpu.cli.val``: re-evaluates a trained model
directory on a split (on the CUDA card unless ``--device cpu``) and writes
``perf.json`` beside it: the alert-level metrics and the follow-up policy
replay (``metrics/diagnostics.py``), and with ``--calibrate`` the fitted
temperature with NLL and ECE before and after (``metrics/calibration.py``),
which ``cli.serve --temperature auto`` reads.  With ``--run-id`` it
re-validates a logged run: config, run name and history come from the
experiment-tracking API, the run directory from the training naming
convention (``{out_root}/{model}_{version}_N{N}_torch/{run_name}``).

``--figure`` also draws the 12-panel diagnostic PDF
(``{split}_diagnostics.pdf`` beside ``perf.json``) with the training curves
of the run's history (the tracking API's for ``--run-id``, else
``report.json``'s); it needs matplotlib and raises before evaluating without
it.
"""

from __future__ import annotations

import argparse
import json
import os

from ..core.config import normalize_config


def resolve_logged_run(run_id: str, api=None, project: str = "BTSbot/runs/",
                       out_root: str = "models", device_suffix: str = "torch"):
    """(config, run_name, history, model_dir) of a logged run.

    ``api`` is injectable (``.run(path)`` returning an object with
    ``.config`` / ``.name`` / ``.history()``), so re-validation is testable
    offline; the default is ``wandb.Api()``, imported only then."""
    if api is None:
        import wandb

        api = wandb.Api()
    run = api.run(project + run_id)
    config = normalize_config(dict(run.config))
    history = run.history()
    run_model_name = (f"{config['model_name']}_{config['train_data_version']}"
                      f"_N{config.get('N_max', 100)}_{device_suffix}")
    return config, run.name, history, os.path.join(out_root, run_model_name, run.name)


def _history_run_data(history, run_name: str) -> dict:
    """Training-curve series for the figure (reference val.py:714-723),
    from a DataFrame-like or dict-of-lists history in the reference's or
    the trainer's column names."""
    def col(*names):
        for n in names:
            try:
                series = history[n]
            except (KeyError, IndexError, TypeError):
                continue
            return [float(v) for v in list(series)]
        return []

    return {
        "run_name": run_name,
        "loss": col("train_loss", "loss"),
        "accuracy": col("train_accuracy", "accuracy"),
        "val_loss": col("val_loss"),
        "val_accuracy": col("val_accuracy"),
    }


def _report_run_data(model_dir: str) -> dict | None:
    """The training curves of a run directory's report.json, if any."""
    path = os.path.join(model_dir, "report.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        report = json.load(f)
    return _history_run_data(report.get("Training history", {}), report.get("Run name", ""))


def main(argv=None, api=None) -> dict:
    """Returns the summary written to perf.json.  api: injectable
    tracking-API client for --run-id (tests pass a fake)."""
    p = argparse.ArgumentParser(description="Evaluate a trained model dir")
    p.add_argument("model_dir", nargs="?", default=None,
                   help="Dir containing report.json + best_model.pth "
                        "(omit with --run-id)")
    p.add_argument("--run-id", default=None,
                   help="Re-validate a logged run by id: config/history "
                        "come from the tracking API, the run dir from the "
                        "training naming convention")
    p.add_argument("--project", default="BTSbot/runs/",
                   help="Tracking-API project prefix for --run-id")
    p.add_argument("--out-root", default="models",
                   help="Training output root for --run-id dir resolution")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--split", default="val")
    p.add_argument("--figure", action="store_true",
                   help="Draw the 12-panel diagnostic PDF (needs matplotlib)")
    p.add_argument("--calibrate", action="store_true",
                   help="Fit temperature scaling on this split and report "
                        "NLL/ECE before/after (metrics/calibration.py)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from ..data.dataset import load_split
    from ..engine.checkpoint import load_model_checkpoint, load_run_dir
    from ..engine.eval import evaluate
    from ..metrics.diagnostics import close_figure, diagnostic_summary, require_matplotlib
    from ..models.factory import build_model

    if args.figure:
        require_matplotlib()
    if args.run_id is not None:
        config, run_name, history, model_dir = resolve_logged_run(
            args.run_id, api=api, project=args.project, out_root=args.out_root)
        args.model_dir = model_dir
        weights = load_model_checkpoint(config, model_dir)
        run_data = _history_run_data(history, run_name)
        print(f"re-validating logged run {args.run_id} ({run_name}) from {model_dir}")
    elif args.model_dir is None:
        p.error("need a model_dir or --run-id")
    else:
        config, weights = load_run_dir(args.model_dir)
        run_data = _report_run_data(args.model_dir)
    model = build_model(config, device=args.device)
    model.load_state_dict(weights, strict=True)
    model.eval()

    ds = load_split(config, args.split, args.data_dir)
    loss, acc, raw_preds, labels = evaluate(model, config, ds, pos_weight=ds.pos_weight)
    print(f"{args.split} loss {loss:.5f}  acc {acc:.5f}")

    summary = diagnostic_summary(
        ds.candidates, raw_preds, labels, run_data=run_data, make_figure=args.figure,
        fig_path=os.path.join(args.model_dir, f"{args.split}_diagnostics.pdf"))
    if args.figure:
        close_figure(summary)
        print(f"Wrote {os.path.join(args.model_dir, f'{args.split}_diagnostics.pdf')}")
    if args.calibrate:
        from ..metrics.calibration import calibration_report
        summary["calibration"] = calibration_report(raw_preds, labels)
        print(f"calibration: {summary['calibration']}")
    perf_path = os.path.join(args.model_dir, "perf.json")
    with open(perf_path, "w") as f:
        json.dump(summary, f, indent=4, default=float)
    print(f"Wrote {perf_path}")
    return summary


if __name__ == "__main__":
    main()
