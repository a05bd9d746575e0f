"""Evaluation loop (port of btsbot_tpu.engine.eval).

The model is evaluated in memory, batch by batch in the split's order.  The
JAX package pads the last batch to its compiled shape; eager PyTorch needs
no padding, and eval-mode BatchNorm makes every alert's result independent
of its batch.  Scores stay on the device until the split is done.

Under a mesh (``mesh=``) each rank scores its rows of every batch and the
scores are gathered in order, so every rank returns the whole split's.  As
in the JAX package, every batch then has the same shape: the last one is
padded to ``batch_size`` (its padding dropped after), and a ``batch_size``
the data axis does not divide raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.dataset import AlertDataset, iterate_batches
from ..parallel.mesh import batch_sharding
from .loss import weighted_bce_with_logits
from .steps import make_eval_step, to_device


def _pad_rows(x: np.ndarray | None, n: int) -> np.ndarray | None:
    if x is None or len(x) == n:
        return x
    return np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:], x.dtype)])


def predict_dataset(model, config, dataset: AlertDataset,
                    batch_size: int | None = None,
                    mesh=None) -> tuple[np.ndarray, np.ndarray]:
    """(float32 logits, sigmoid scores) for every alert of the dataset, in
    order, on the model's device; ``mesh``: each rank scores its rows (see
    the module doc)."""
    batch_size = batch_size or int(config["batch_size"])
    device = next(model.parameters()).device
    eval_step = make_eval_step(config, mesh)
    rows = None
    if mesh is not None:
        rows = batch_sharding(mesh)
        rows.rows(batch_size)  # raises on a batch the data axis does not split
    logits, scores = [], []
    for images, metadata, labels in iterate_batches(dataset, batch_size):
        n = len(labels)
        if rows is not None:
            images, metadata = (rows(_pad_rows(x, batch_size)) for x in (images, metadata))
        z, s = eval_step(model, to_device(images, device), to_device(metadata, device))
        logits.append(z[:n])
        scores.append(s[:n])
    if not logits:
        return np.zeros((0,), np.float32), np.zeros((0,), np.float32)
    return (torch.cat(logits).float().cpu().numpy(),
            torch.cat(scores).cpu().numpy())


def evaluate(model, config, dataset: AlertDataset, pos_weight: float = 1.0,
             batch_size: int | None = None, mesh=None):
    """(loss, accuracy, raw_preds, labels): pos-weighted BCE over the whole
    split and 0.5-threshold accuracy (reference val.py:159-170)."""
    logits, scores = predict_dataset(model, config, dataset, batch_size, mesh)
    labels = dataset.labels
    loss = float(weighted_bce_with_logits(torch.from_numpy(logits),
                                          torch.from_numpy(labels), pos_weight))
    acc = float(np.mean((scores > 0.5) == (labels > 0.5)))
    return loss, acc, scores, labels
