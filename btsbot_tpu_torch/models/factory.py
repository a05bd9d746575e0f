"""Model construction by config name (port of btsbot_tpu.models.factory).

Every family of the JAX package is ported: the CNNs, um_nn, ConvNeXt and
mm_ConvNeXt (the ``convnext_*`` and ``inceptionnext_*`` kinds), MaxViT and
mm_MaxViT (the ``maxvit_*`` kinds, and the ``maxxvit_rmlp_*`` kinds, which
the JAX package lacks), and frozen_fusion over any of their image branches.
"""

from __future__ import annotations

import torch

from ..core.config import Config, normalize_config
from ..core.device import resolve_device
from .cnn import MmCnn, UmCnn
from .convnext import ConvNeXtClassifier, MmConvNeXt
from .fusion import FrozenFusion
from .init import apply_init_scheme
from .maxvit import MaxViTClassifier, MmMaxViT
from .mlp import UmNN

MODEL_REGISTRY = {
    "mm_cnn": MmCnn,
    "um_cnn": UmCnn,
    "um_nn": UmNN,
    "ConvNeXt": ConvNeXtClassifier,
    "mm_ConvNeXt": MmConvNeXt,
    "MaxViT": MaxViTClassifier,
    "mm_MaxViT": MmMaxViT,
    "frozen_fusion": FrozenFusion,
}


def build_model(config, dtype=torch.float32, device=None, seed: int = 0):
    """Construct the model for a config in eval mode, initialised from
    ``seed`` by the config's ``init_scheme`` (``models.init``: "torch", the
    default, is torch's module defaults with γ = 1e-6; "flax" redraws every
    Conv / Linear as lecun_normal with zero biases), with parameters in
    ``dtype`` on ``device`` (default: the CUDA card; raises without one).
    The train step puts it in train mode itself (engine.steps)."""
    if not isinstance(config, Config):
        config = normalize_config(config)
    dev = resolve_device(device)
    name = config["model_name"]
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"Could not find model of name {name}") from None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = cls(config)
    apply_init_scheme(model, config.get("init_scheme", "torch"), seed)
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
