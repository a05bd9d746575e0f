"""Model construction by config name (port of btsbot_tpu.models.factory).

Every family is ported except MaxViT / mm_MaxViT, which raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch

from ..core.config import Config, normalize_config
from ..core.device import resolve_device
from .cnn import MmCnn, UmCnn
from .convnext import ConvNeXtClassifier, MmConvNeXt
from .fusion import FrozenFusion
from .mlp import UmNN

MODEL_REGISTRY = {
    "mm_cnn": MmCnn,
    "um_cnn": UmCnn,
    "um_nn": UmNN,
    "ConvNeXt": ConvNeXtClassifier,
    "mm_ConvNeXt": MmConvNeXt,
    "frozen_fusion": FrozenFusion,
}

_NOT_PORTED = {
    "MaxViT": "ROADMAP Queue A item 7 (MaxViT, the next slice)",
    "mm_MaxViT": "ROADMAP Queue A item 7 (MaxViT, the next slice)",
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


def example_inputs(config, batch_size: int = 1, dtype=torch.float32, device=None):
    """Zero (image, metadata) inputs matching the config's modality (None
    for a modality the model does not take)."""
    if not isinstance(config, Config):
        config = normalize_config(config)
    dev = resolve_device(device)
    image = metadata = None
    if config.need_triplets:
        s = int(config.get("image_size", 63))
        image = torch.zeros(batch_size, s, s, 3, dtype=dtype, device=dev)
    if config.need_metadata:
        n = len(config.get("metadata_cols", []))
        metadata = torch.zeros(batch_size, n, dtype=dtype, device=dev)
    return image, metadata
