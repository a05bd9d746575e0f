#!/usr/bin/env python3
"""Training quickstart with the PyTorch / CUDA port (counterpart of
examples/train_quickstart.py): synthetic data → train → evaluate → serve.

A self-contained tour (no downloads needed):

    python examples/train_quickstart_torch.py [--model mm_cnn|mm_ConvNeXt]
        [--epochs 3] [--n 2048] [--out DIR] [--device cpu]

Generates a separable synthetic alert dataset, trains with the full engine
(augmentation on the card, weighted BCE, early stopping, checkpoints;
mm_ConvNeXt's blocks in the hand-written block kernel), prints the
science-metric summary, and scores the validation set through the batched
serving path.  It runs on the CUDA card by default and on the host with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

META_COLS = [f"m{i}" for i in range(25)]


def make_dataset(n: int, seed: int):
    from btsbot_tpu_torch.data.dataset import AlertDataset

    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.35).astype(np.float32)
    images = rng.normal(0, 0.1, (n, 63, 63, 3)).astype(np.float32)
    pos = labels == 1
    images[pos, 26:36, 26:36, 0] += 0.9
    images[pos, 26:36, 26:36, 2] += 0.7
    meta = rng.normal(0, 1, (n, 25)).astype(np.float32)
    meta[pos, 5] -= 1.2
    return AlertDataset(labels=labels, images=images, metadata=meta)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="mm_cnn", choices=["mm_cnn", "mm_ConvNeXt"])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--out", default=None,
                   help="Output root (default: a new temporary directory)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    import torch

    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.engine.serve import AlertScorer
    from btsbot_tpu_torch.engine.train import run_training

    config = normalize_config({
        "model_name": args.model,
        "train_data_version": "vquickstart",
        "metadata_cols": META_COLS,
        "conv1_channels": 16, "conv2_channels": 32, "conv_kernel": 5,
        "conv_dropout1": 0.3, "conv_dropout2": 0.3,
        "model_kind": "convnext_atto.quickstart",
        "meta_fc1_neurons": 64, "meta_fc2_neurons": 64, "meta_dropout": 0.25,
        "comb_fc1_neurons": 32, "comb_fc2_neurons": 16, "comb_dropout": 0.2,
        "learning_rate": 1e-3, "beta_1": 0.9, "beta_2": 0.999,
        "batch_size": 128, "epochs": args.epochs, "patience": 10,
        "warmup_epochs": 1, "random_seed": 7,
    })
    out = args.out or tempfile.mkdtemp(prefix="btsbot_quickstart_")

    train_ds = make_dataset(args.n, seed=0)
    val_ds = make_dataset(max(256, args.n // 8), seed=1)

    result = run_training(config, run_name="quickstart", out_root=out, train_ds=train_ds,
                          val_ds=val_ds, make_figure=False, device=args.device)

    summary = result["summaries"]["val"]
    print("\nval summary:")
    for key in ("roc_auc", "bal_acc", "alert_precision", "alert_recall"):
        if key in summary:
            print(f"  {key}: {summary[key]:.4f}")

    scorer = AlertScorer(config, result["model"].state_dict(), batch_size=256,
                         dtype=torch.float32, device=args.device)
    scores = scorer(val_ds.images, val_ds.metadata)
    acc = float(np.mean((scores > 0.5) == (val_ds.labels > 0.5)))
    print(f"serving-path val accuracy: {acc:.4f} over {len(scores)} alerts")
    return {"result": result, "scores": scores, "accuracy": acc}


if __name__ == "__main__":
    main()
