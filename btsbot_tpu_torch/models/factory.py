"""Model construction by config name (port of btsbot_tpu.models.factory).

Only mm_ConvNeXt is ported so far; the other names raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch

from ..core.config import Config, normalize_config
from ..core.device import resolve_device
from .convnext import MmConvNeXt

MODEL_REGISTRY = {"mm_ConvNeXt": MmConvNeXt}

_NOT_PORTED = {
    "ConvNeXt": "ROADMAP Queue A item 2 (ConvNeXtClassifier)",
    "mm_cnn": "ROADMAP Queue A item 7 (remaining families)",
    "um_cnn": "ROADMAP Queue A item 7 (remaining families)",
    "um_nn": "ROADMAP Queue A item 7 (remaining families)",
    "MaxViT": "ROADMAP Queue A item 7 (remaining families)",
    "mm_MaxViT": "ROADMAP Queue A item 7 (remaining families)",
    "frozen_fusion": "ROADMAP Queue A item 7 (remaining families)",
}


def build_model(config, dtype=torch.float32, device=None, seed: int = 0):
    """Construct the model for a config in eval mode, initialised by torch's
    module defaults from ``seed`` (γ = 1e-6), with parameters in ``dtype``
    on ``device`` (default: the CUDA card; raises without one).  The train
    step puts it in train mode itself (engine.steps)."""
    if not isinstance(config, Config):
        config = normalize_config(config)
    dev = resolve_device(device)
    name = config["model_name"]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet: {_NOT_PORTED[name]}")
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"Could not find model of name {name}") from None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = cls(config)
    return model.to(device=dev, dtype=dtype).eval()
