#!/usr/bin/env python3
"""Off-the-shelf inference with the PyTorch / CUDA port (counterpart of
examples/inference_example.py).

Loads a published BTSbot checkpoint from a local HF snapshot (downloaded
first if it is missing) or, with ``--local``, the port's shipped synthetic
example model (``btsbot_tpu_torch/example_data``), scores the example alerts
in one batch on the CUDA card (``--device cpu`` for the host), and prints
predictions beside labels and the golden scores.

    python examples/inference_example_torch.py --architecture convnext \\
        --pretrain galaxyzoo --multi_modal
    python examples/inference_example_torch.py --local [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EXAMPLE_DIR = os.path.join(ROOT, "btsbot_tpu_torch", "example_data")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Score example alerts with a published BTSbot model")
    p.add_argument("--architecture", choices=["convnext", "maxvit"], default="convnext")
    p.add_argument("--pretrain", default="galaxyzoo",
                   choices=["imagenet", "galaxyzoo", "randinit"])
    p.add_argument("--multi_modal", action="store_true")
    p.add_argument("--local", action="store_true",
                   help="Use the shipped synthetic example model instead of an "
                        "HF snapshot")
    p.add_argument("--models-root", default="models",
                   help="Where HF snapshots live (downloaded there if missing)")
    p.add_argument("--example-dir", default=EXAMPLE_DIR,
                   help="Directory with usage_triplets.npy + usage_candidates.csv")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from btsbot_tpu_torch.engine.serve import AlertScorer
    from btsbot_tpu_torch.example_data.make_example_data import read_candidates
    from btsbot_tpu_torch.interop.hf import load_HF_model, load_model_dir

    if args.local:
        model, config = load_model_dir(EXAMPLE_DIR, device="cpu")
    else:
        model, config = load_HF_model(args.architecture, args.multi_modal, args.pretrain,
                                      models_root=args.models_root, device="cpu")

    meta, labels, expected = read_candidates(os.path.join(args.example_dir,
                                                          "usage_candidates.csv"))
    trips = np.load(os.path.join(args.example_dir, "usage_triplets.npy")).astype(np.float32)

    scorer = AlertScorer(config, model.state_dict(), batch_size=64, dtype=torch.float32,
                         device=args.device)
    scores = scorer(trips if config.need_triplets else None,
                    meta if config.need_metadata else None)
    preds = np.rint(scores).astype(int)

    print("scores:", np.round(scores, 4))
    print("preds: ", preds)
    print("labels:", labels)
    if args.local:
        print(f"max |score - expected_scores|: {np.abs(scores - expected).max():.3g}")
    return {"scores": scores, "labels": labels, "expected_scores": expected}


if __name__ == "__main__":
    main()
