"""Generate the port's shipped example / golden dataset (port of
btsbot_tpu/example_data/make_example_data.py).

The same 16 seeded synthetic alerts as the JAX package's example data
(``synthesize_alerts`` draws the same numbers from the same seed, so the
triplets and metadata are equal array for array), an mm_cnn model
initialised by torch's generator under the config's ``random_seed``, and
golden scores that model gives them at generation time.  Written beside this
file:

* ``usage_triplets.npy`` — the (16, 63, 63, 3) triplets in float64;
* ``usage_candidates.csv`` — objectId, jd, the 25 metadata columns, label
  and ``expected_scores`` (the port's golden scores);
* ``train_config.json`` — the normalised ``EXAMPLE_CONFIG``;
* ``pytorch_model.bin`` — the model as a reference-named state dict, so the
  directory loads with ``interop.hf.load_model_dir``.

Run from the repo root:  python -m btsbot_tpu_torch.example_data.make_example_data
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

META_COLS = [
    "sgscore1", "distpsnr1", "sgscore2", "distpsnr2", "fwhm", "magpsf",
    "sigmapsf", "chipsf", "ra", "dec", "diffmaglim", "ndethist", "nmtchps",
    "age", "days_since_peak", "days_to_peak", "peakmag_so_far", "new_drb",
    "ncovhist", "nnotdet", "chinr", "sharpnr", "scorr", "sky", "maxmag_so_far",
]

EXAMPLE_CONFIG = {
    "model_name": "mm_cnn",
    "train_data_version": "vexample",
    "metadata_cols": META_COLS,
    "conv1_channels": 32,
    "conv2_channels": 64,
    "conv_kernel": 5,
    "conv_dropout1": 0.5,
    "conv_dropout2": 0.55,
    "meta_fc1_neurons": 128,
    "meta_fc2_neurons": 128,
    "meta_dropout": 0.25,
    "comb_fc1_neurons": 8,
    "comb_fc2_neurons": 8,
    "comb_dropout": 0.2,
    "batch_size": 16,
    "epochs": 1,
    "patience": 1,
    "learning_rate": 1e-4,
    "beta_1": 0.99,
    "beta_2": 0.99,
    "random_seed": 0,
}

N_ALERTS = 16
TRIPLETS_FILE = "usage_triplets.npy"
CANDIDATES_FILE = "usage_candidates.csv"
CONFIG_FILE = "train_config.json"
WEIGHTS_FILE = "pytorch_model.bin"


def synthesize_alerts(seed: int = 0):
    """Seeded synthetic alerts: L2-normalized 63×63×3 triplets with a faint
    PSF-like blob, plus plausible metadata rows."""
    rng = np.random.default_rng(seed)
    trips = rng.normal(0, 1.0, (N_ALERTS, 63, 63, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:63, 0:63]
    labels = (rng.random(N_ALERTS) < 0.5).astype(int)
    for i in range(N_ALERTS):
        cx, cy = rng.uniform(25, 38, 2)
        amp = 8.0 if labels[i] else 2.0
        blob = amp * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                              / (2 * rng.uniform(1.5, 3.0) ** 2)))
        trips[i, :, :, 0] += blob
        trips[i, :, :, 2] += blob * 0.8
    norms = np.linalg.norm(trips, axis=(1, 2), keepdims=True)
    trips = (trips / norms).astype(np.float32)

    meta = rng.normal(0, 1, (N_ALERTS, len(META_COLS))).astype(np.float32)
    meta[:, META_COLS.index("magpsf")] = rng.uniform(16.5, 20.5, N_ALERTS)
    meta[labels == 1, META_COLS.index("magpsf")] -= 1.0
    return trips, meta, labels


def read_candidates(path: str) -> tuple:
    """(metadata (N, 25) float32, labels (N,), expected_scores (N,) float32)
    of a ``usage_candidates.csv``."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    meta = np.asarray([[float(r[c]) for c in META_COLS] for r in rows], np.float32)
    labels = np.asarray([int(r["label"]) for r in rows])
    scores = np.asarray([float(r["expected_scores"]) for r in rows], np.float32)
    return meta, labels, scores


def write_example_data(out_dir: str = HERE) -> np.ndarray:
    """Write the four files into ``out_dir``; returns the golden scores."""
    import torch

    from ..core.config import normalize_config
    from ..models.factory import build_model

    config = normalize_config(EXAMPLE_CONFIG)
    trips, meta, labels = synthesize_alerts()
    model = build_model(config, device="cpu", seed=int(config["random_seed"]))
    with torch.inference_mode():
        logits = model(torch.from_numpy(trips), torch.from_numpy(meta))
    scores = torch.sigmoid(logits).reshape(-1).numpy()

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, TRIPLETS_FILE), trips.astype(np.float64))
    with open(os.path.join(out_dir, CANDIDATES_FILE), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["objectId", "jd", *META_COLS, "label", "expected_scores"])
        for i in range(N_ALERTS):
            w.writerow([f"SYN{i:05d}", repr(2459300.0 + i),
                        *(str(np.float32(v)) for v in meta[i]), int(labels[i]),
                        str(np.float32(scores[i]))])
    torch.save(model.state_dict(), os.path.join(out_dir, WEIGHTS_FILE))
    with open(os.path.join(out_dir, CONFIG_FILE), "w") as f:
        json.dump(dict(config), f, indent=2)
    return scores


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", default=HERE)
    args = p.parse_args(argv)
    scores = write_example_data(args.out_dir)
    print(f"Wrote example data to {args.out_dir}; scores[:4] = {scores[:4]}")


if __name__ == "__main__":
    main()
