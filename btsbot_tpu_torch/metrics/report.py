"""Training report writer (reference ``make_report``, utils.py:51-67).

A numpy-only copy of btsbot_tpu.metrics.report, which the port cannot
import (the JAX package's ``__init__`` loads flax).

Same JSON contract — timestamp, run name, per-epoch history, train_config,
val_summary — so downstream tooling (to_HF prep_config, frozen_fusion's
report.json loader, to_onnx load_config) works against our model dirs.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

import numpy as np


def _listify(value):
    return np.asarray(value).tolist()


def make_report(config, report_path: str, run_data: dict, val_summary: dict
                ) -> dict:
    report = {
        "Run time stamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
        "Run name": run_data.get("run_name", ""),
        "Training history": {
            k: _listify(v) for k, v in run_data.items() if k != "run_name"
        },
        "train_config": dict(config),
        "val_summary": dict(val_summary),
    }
    os.makedirs(os.path.dirname(report_path) or ".", exist_ok=True)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=4, default=_listify)
    return report


def load_report_config(model_dir: str) -> dict:
    """train_config from a model dir's report.json."""
    with open(os.path.join(model_dir, "report.json"), "r") as f:
        return json.load(f)["train_config"]
