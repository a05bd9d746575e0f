"""Shared model building blocks (port of btsbot_tpu.models.common).

* ``gelu`` — the JAX package's dtype rule: the exact erf form in float32,
  the tanh form in bfloat16 (models/common.py:30-42 of the JAX package);
* ``Linear`` / ``Conv2d`` / ``LayerNorm`` — torch's modules with their
  parameters cast to the input's type at use, so float32 parameters serve a
  bfloat16 forward (the JAX package's ``dtype`` with float32
  ``param_dtype``); on float32 input, or parameters already in the input's
  type, the cast is a no-op;
* ``BatchNorm1d`` — eps 1e-5; in eval mode torch's own; in train mode the
  flax rule (models/common.py:79-85 of the JAX package): statistics in
  float32 as E[x²] − E[x]² clipped at 0, and the running variance updated
  with that biased batch variance, momentum 0.9;
* ``Dropout`` — inverted dropout whose mask comes from ``generator`` when
  one is set (``set_dropout_generator``), so a training step's masks follow
  the train state's seed;
* ``MetadataBranch`` — BatchNorm → Linear → GELU → Dropout → Linear → GELU,
  the BatchNorm output cast to the compute type;
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


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class BatchNorm1d(nn.BatchNorm1d):
    def __init__(self, n: int):
        super().__init__(n, eps=1e-5, momentum=0.1)  # flax momentum 0.9

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean(dim=0)
        var = torch.clamp(xf.square().mean(dim=0) - mean.square(), min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class Dropout(nn.Dropout):
    generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        keep = torch.empty_like(x).bernoulli_(1 - self.p, generator=self.generator)
        return x * keep / (1 - self.p)


def set_dropout_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Draw every ``Dropout`` mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def check_inputs(model_name: str, image_input, metadata_input) -> None:
    """A clear error when a modality the model needs is missing."""
    if model_name in IMAGE_ONLY_MODELS + MULTIMODAL_MODELS and image_input is None:
        raise ValueError(f"{model_name} requires image_input (NHWC triplets)")
    if model_name in METADATA_ONLY_MODELS + MULTIMODAL_MODELS and metadata_input is None:
        raise ValueError(f"{model_name} requires metadata_input")


class MetadataBranch(nn.Sequential):
    def __init__(self, n_in: int, fc1: int, fc2: int, dropout: float):
        super().__init__(
            BatchNorm1d(n_in),
            Linear(n_in, fc1),
            GELU(),
            Dropout(dropout),
            Linear(fc1, fc2),
            GELU(),
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """``dtype``: the compute type after the BatchNorm (default x's)."""
        bn, *rest = self
        x = bn(x).to(dtype or x.dtype)
        for layer in rest:
            x = layer(x)
        return x


class CombinedHead(nn.Sequential):
    def __init__(self, n_in: int, fc1: int, fc2: int, dropout: float):
        super().__init__(
            Linear(n_in, fc1),
            GELU(),
            Linear(fc1, fc2),
            GELU(),
            Dropout(dropout),
            Linear(fc2, 1),
        )
