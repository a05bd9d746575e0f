"""Experiment logging with an optional wandb backend (a copy of
btsbot_tpu.utils.logging).

The reference logs per-epoch scalars and summary science metrics to wandb
(reference train.py:274-279,356-365,393-429).  Here logging goes through a
small protocol object, so the trainer never imports wandb itself:
``WandbLogger`` uses wandb (imported when one is made), ``JsonlLogger``
appends to a local file, ``NullLogger`` discards.
``summary_from_diagnostics`` flattens a diagnostic summary into the
reference's wandb.summary keys (ROC_AUC, bal_acc, per-policy
precision / recall / F1 / binned metrics / latencies).
"""

from __future__ import annotations

import json
import os
from typing import Any

from ..metrics.classification import f1


class NullLogger:
    def log(self, metrics: dict, step: int | None = None) -> None:
        pass

    def set_summary(self, summary: dict) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlLogger(NullLogger):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, metrics: dict, step: int | None = None) -> None:
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"step": step, **metrics}, default=float) + "\n")

    def set_summary(self, summary: dict) -> None:
        self.log({"summary": summary})


class WandbLogger(NullLogger):
    def __init__(self, project: str = "btsbot-tpu", config: dict | None = None,
                 run_name: str | None = None):
        import wandb  # optional dependency

        self._wandb = wandb
        self.run = wandb.init(project=project, config=config, name=run_name)

    def log(self, metrics: dict, step: int | None = None) -> None:
        self._wandb.log(metrics, step=step)

    def set_summary(self, summary: dict) -> None:
        for k, v in summary.items():
            self._wandb.summary[k] = v

    def finish(self) -> None:
        self._wandb.finish()


def make_logger(kind: str = "null", **kwargs: Any):
    """``"null"``, ``"jsonl"`` (``path=``) or ``"wandb"`` (a NullLogger when
    wandb is not installed, as in the JAX package)."""
    if kind == "null":
        return NullLogger()
    if kind == "jsonl":
        return JsonlLogger(**kwargs)
    if kind == "wandb":
        try:
            return WandbLogger(**kwargs)
        except ImportError:
            return NullLogger()
    raise ValueError(f"Unknown logger kind: {kind}")


def summary_from_diagnostics(summary: dict, prefix: str = "") -> dict:
    """Flatten a diagnostic summary into the reference's wandb.summary keys
    (train.py:402-428)."""
    out = {
        prefix + "ROC_AUC": summary["roc_auc"],
        prefix + "bal_acc": summary["bal_acc"],
        prefix + "bts_acc": summary["bts_acc"],
        prefix + "notbts_acc": summary["notbts_acc"],
        prefix + "alert_precision": summary["alert_precision"],
        prefix + "alert_recall": summary["alert_recall"],
        prefix + "alert_F1": f1(summary["alert_precision"], summary["alert_recall"]),
    }
    for pol_name, perf in summary.get("policy_performance", {}).items():
        p = prefix + pol_name
        out[p + "_precision"] = perf["policy_precision"]
        out[p + "_recall"] = perf["policy_recall"]
        out[p + "_binned_precision"] = perf["binned_precision"]
        out[p + "_binned_recall"] = perf["binned_recall"]
        out[p + "_peakmag_bins"] = perf["peakmag_bins"]
        out[p + "_save_dt"] = perf["med_save_dt"]
        out[p + "_trigger_dt"] = perf["med_trigger_dt"]
        out[p + "_F1"] = f1(perf["policy_precision"], perf["policy_recall"])
    return out
