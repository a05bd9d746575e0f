"""Parameter initialisation schemes (port of btsbot_tpu.models.init and the
``init_scheme`` switch of btsbot_tpu.models.factory.init_model).

* ``"torch"`` (the default) keeps torch's module defaults, which are the
  reference's starting point and what the JAX package redraws its flax
  init to: every Conv / Linear weight and bias U(±1/√fan_in), fan_in =
  in/groups · kh · kw (kaiming_uniform with a = √5 has that bound);
  LayerNorm / BatchNorm weight 1, bias 0; layer-scale γ = 1e-6; MaxViT's
  relative-position tables trunc_normal(0.02).
* ``"flax"`` redraws every Conv / Linear weight as flax's lecun_normal —
  variance_scaling(1, "fan_in", "truncated_normal"): a normal truncated at
  ±2σ whose σ is divided by 0.8796, the std of a unit normal truncated
  there, so the drawn std is 1/√fan_in — and zeroes its bias.  γ, the
  rel-pos tables and the norms keep their architecture-defined values, as
  in the JAX scheme.  The draws come from a ``torch.Generator`` seeded
  with ``seed``, module by module in registration order; they are not the
  JAX package's bit for bit (another generator), only the same law.
* anything else raises ``ValueError``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


def fan_in(weight: torch.Tensor) -> int:
    """in/groups · kh · kw of a conv weight (O, I/groups, kh, kw); in of a
    Linear weight (out, in)."""
    return math.prod(weight.shape[1:])


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    std = 1.0 / math.sqrt(fan_in(weight)) / _TRUNC_STD
    draw = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    weight.copy_(draw)


def apply_init_scheme(model: nn.Module, scheme: str, seed: int = 0) -> nn.Module:
    """Initialise ``model`` in place by ``scheme`` (see the module doc)."""
    if scheme == "torch":
        return model
    if scheme != "flax":
        raise ValueError(f"unknown init_scheme: {scheme!r} "
                         "(expected 'torch' or 'flax')")
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    module.bias.zero_()
    return model
