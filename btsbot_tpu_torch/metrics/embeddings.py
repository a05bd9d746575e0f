"""Penultimate-layer embeddings and their 2-D projection (port of
btsbot_tpu.metrics.embeddings).

The reference trainer can write UMAP embeddings of a trained model through
a ``generate_embeddings`` module it does not ship (reference
train.py:20,449-469).  As in the JAX package, the features are the
activation that feeds the model's final Linear(·, 1):

* mm_* / frozen_fusion — the combined head's second hidden activation;
* um_cnn / ConvNeXt / MaxViT — the image head's second hidden activation;
* um_nn — the metadata branch's output.

The JAX package sows that activation as the "penultimate" intermediate
(models/common.py:109,131, models/mlp.py:32 of the JAX package); here a
forward pre-hook on the final Linear reads its input, so the serving
forward is unchanged.  ``project_2d`` projects with UMAP when it is
installed (imported only then), else PCA.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.config import normalize_config
from ..data.dataset import AlertDataset, iterate_batches
from ..engine.steps import compute_dtype, model_inputs, to_device


def final_linear(model: nn.Module) -> nn.Linear:
    """The model's last ``Linear(·, 1)``: the output layer of every family
    (its combined or image head, or um_nn's network)."""
    last = None
    for module in model.modules():
        if isinstance(module, nn.Linear) and module.out_features == 1:
            last = module
    if last is None:
        raise ValueError("No penultimate features: the model has no Linear(·, 1)")
    return last


def extract_features(model: nn.Module, config, dataset: AlertDataset,
                     batch_size: int | None = None) -> np.ndarray:
    """(N, D) float32 penultimate features of every alert, in dataset
    order, in eval mode on the model's device in the config's compute
    type.  The last batch is padded with zeros to a full batch and cut
    back, as the JAX package does."""
    config = normalize_config(config)
    batch_size = batch_size or int(config.get("batch_size", 256))
    device = next(model.parameters()).device
    dtype = compute_dtype(config)
    captured = []
    hook = final_linear(model).register_forward_pre_hook(
        lambda _module, args: captured.append(args[0]))
    model.eval()
    out = []
    try:
        with torch.no_grad():
            for images, metadata, labels in iterate_batches(dataset, batch_size):
                n = len(labels)
                if n < batch_size:
                    pad = batch_size - n
                    if images is not None:
                        images = np.concatenate(
                            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
                    if metadata is not None:
                        metadata = np.concatenate(
                            [metadata, np.zeros((pad,) + metadata.shape[1:],
                                                metadata.dtype)])
                image_input, metadata_input = model_inputs(
                    config, to_device(images, device), to_device(metadata, device), dtype)
                captured.clear()
                model(image_input=image_input, metadata_input=metadata_input)
                out.append(captured[0][:n].float().cpu().numpy())
    finally:
        hook.remove()
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


def project_2d(features: np.ndarray, seed: int = 0, method: str = "auto") -> np.ndarray:
    """(N, 2) projection: UMAP when installed (the reference's choice),
    PCA otherwise."""
    if method in ("auto", "umap"):
        try:
            import umap  # optional

            return umap.UMAP(random_state=seed).fit_transform(features)
        except ImportError:
            if method == "umap":
                raise
    centered = features - features.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:2].T


def generate_embeddings(model: nn.Module, config, dataset: AlertDataset,
                        candids=None, seed: int = 0) -> np.ndarray:
    """(N, 3) array of [emb_1, emb_2, candid] in the reference's embeddings
    CSV schema (train.py:464-465); float64, as the JAX package stacks it
    (a candid above 2**53 is rounded there too)."""
    feats = extract_features(model, config, dataset)
    emb = project_2d(feats, seed=seed)
    if candids is None:
        candids = np.arange(len(emb))
    return np.column_stack([emb, np.asarray(candids)[:len(emb)]])
