"""Shared model building blocks (port of btsbot_tpu.models.common).

* ``gelu`` — the JAX package's dtype rule: the exact erf form in float32,
  the tanh form in bfloat16 (models/common.py:30-42 of the JAX package);
* ``MetadataBranch`` — BatchNorm → Linear → GELU → Dropout → Linear → GELU,
  BN eps 1e-5, running statistics in eval mode;
* ``CombinedHead`` — Linear → GELU → Linear → GELU → Dropout → Linear(1).

Both heads are ``nn.Sequential``s so their parameters carry the reference's
state-dict names (``metadata_branch.{0,1,4}``, ``combined_head.{0,2,5}``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import IMAGE_ONLY_MODELS, METADATA_ONLY_MODELS, MULTIMODAL_MODELS


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the JAX package's rule: erf in float32, tanh in bfloat16."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


def check_inputs(model_name: str, image_input, metadata_input) -> None:
    """A clear error when a modality the model needs is missing."""
    if model_name in IMAGE_ONLY_MODELS + MULTIMODAL_MODELS and image_input is None:
        raise ValueError(f"{model_name} requires image_input (NHWC triplets)")
    if model_name in METADATA_ONLY_MODELS + MULTIMODAL_MODELS and metadata_input is None:
        raise ValueError(f"{model_name} requires metadata_input")


class MetadataBranch(nn.Sequential):
    def __init__(self, n_in: int, fc1: int, fc2: int, dropout: float):
        super().__init__(
            nn.BatchNorm1d(n_in, eps=1e-5, momentum=0.1),  # flax momentum 0.9
            nn.Linear(n_in, fc1),
            GELU(),
            nn.Dropout(dropout),
            nn.Linear(fc1, fc2),
            GELU(),
        )


class CombinedHead(nn.Sequential):
    def __init__(self, n_in: int, fc1: int, fc2: int, dropout: float):
        super().__init__(
            nn.Linear(n_in, fc1),
            GELU(),
            nn.Linear(fc1, fc2),
            GELU(),
            nn.Dropout(dropout),
            nn.Linear(fc2, 1),
        )
