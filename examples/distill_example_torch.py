#!/usr/bin/env python3
"""Distillation walkthrough with the PyTorch / CUDA port: a trained
mm_ConvNeXt → an ``inceptionnext_<size>`` student.

    python examples/distill_example_torch.py [--size atto] [--epochs 4] [--n 1024]
        [--out DIR] [--device cpu]

1. trains a small mm_ConvNeXt teacher on synthetic alerts,
2. distills it into the matching ``inceptionnext_<size>`` student
   (``btsbot_tpu_torch.engine.distill.distill_to_student``: the teacher scores
   every training batch inside the student's train step, without gradients),
3. reports student / teacher score agreement and both models' val accuracy.

In production the teacher comes from a converted reference checkpoint (an HF
snapshot) or an earlier training run directory; pass that directory as
``teacher_dir`` instead of training one here.  It runs on the CUDA card by
default and on the host with ``--device cpu``.  On an NVIDIA H100 80GB HBM3
at 700 W the ``.r2`` student of the pico size serves 415k alerts/s against
the ``convnext_pico`` teacher's 505k (bf16, batch 3072): there the student is
not the faster model, so distil for the model, not for speed.
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
    p.add_argument("--size", default="atto",
                   help="ConvNeXt / InceptionNeXt size (atto|femto|pico|...)")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--out", default=None,
                   help="Output root (default: a new temporary directory)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.engine.distill import distill_to_student, load_teacher
    from btsbot_tpu_torch.engine.eval import predict_dataset
    from btsbot_tpu_torch.engine.train import run_training

    out = args.out or tempfile.mkdtemp(prefix="btsbot_distill_")
    train_ds = make_dataset(args.n, seed=0)
    val_ds = make_dataset(args.n // 4, seed=1)

    teacher_cfg = normalize_config({
        "model_name": "mm_ConvNeXt",
        "model_kind": f"convnext_{args.size}.example",
        "train_data_version": "vdistill",
        "metadata_cols": META_COLS,
        "meta_fc1_neurons": 32, "meta_fc2_neurons": 32, "meta_dropout": 0.1,
        "comb_fc1_neurons": 16, "comb_fc2_neurons": 8, "comb_dropout": 0.1,
        "learning_rate": 1e-3, "beta_1": 0.9, "beta_2": 0.999,
        "batch_size": 64, "epochs": args.epochs, "warmup_epochs": 1,
        "patience": max(2, args.epochs), "random_seed": 2, "pretrained": False,
    })

    print("=== 1. train teacher (mm_ConvNeXt) ===")
    t_result = run_training(teacher_cfg, run_name="teacher", out_root=out,
                            train_ds=train_ds, val_ds=val_ds, device=args.device)
    teacher_dir = t_result["model_dir"]
    print(f"teacher val acc: {t_result['history']['val_accuracy'][-1]:.3f}")

    print("=== 2. distill into the inceptionnext student ===")
    s_result = distill_to_student(
        teacher_dir=teacher_dir, student_kind=f"inceptionnext_{args.size}",
        run_name="student", out_root=os.path.join(out, "student"),
        train_ds=train_ds, val_ds=val_ds, device=args.device)
    print(f"student val acc: {s_result['history']['val_accuracy'][-1]:.3f}")

    print("=== 3. student / teacher agreement on val alerts ===")
    scores = {}
    for name, model_dir in (("teacher", teacher_dir), ("student", s_result["model_dir"])):
        model, config = load_teacher(model_dir, device=args.device)
        scores[name] = predict_dataset(model, config, val_ds)[1]
    diff = np.abs(scores["student"] - scores["teacher"])
    print(f"mean |student-teacher| score diff: {diff.mean():.4f} (max {diff.max():.4f})")
    agree = float(np.mean((scores["student"] > 0.5) == (scores["teacher"] > 0.5)))
    print(f"decision agreement @0.5: {agree:.3f}")
    return {"teacher": t_result, "student": s_result, "agreement": agree,
            "mean_abs_diff": float(diff.mean())}


if __name__ == "__main__":
    main()
