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
  with that biased batch variance, momentum 0.9; ``BatchNorm2d`` the same
  over the channel (last) axis of an NHWC map, eval mode on its NCHW view;
* ``Dropout`` — inverted dropout whose mask comes from ``generator`` when
  one is set (``set_dropout_generator``), so a training step's masks follow
  the train state's seed; ``Dropout2d`` draws one mask entry per (alert,
  channel) of an NHWC map, shape (N, 1, 1, C), as the JAX package's
  ``Dropout(broadcast_dims=(1, 2))`` (models/cnn.py:50-51, 60-61);
* under a mesh with a data axis d > 1 (``set_data_parallel``) each rank
  holds 1/d of the global batch: a train-mode BatchNorm sums x and x² over
  the mesh's data group before it forms the mean and the flax variance
  (flax's statistics cover the global batch; ``SyncBatchNorm``'s variance
  is another), and a Dropout draws the global batch's mask and keeps this
  rank's rows, so the step equals the one-process step;
* ``MetadataBranch`` — BatchNorm → Linear → act → Dropout → Linear → act,
  the BatchNorm output cast to the compute type (the last act left out for
  frozen_fusion's metadata branch);
* ``CombinedHead`` / ``ImageHead`` — Linear → act → Linear → act → Dropout
  → Linear(1).

``act`` is ``"gelu"`` (the JAX dtype rule above) or ``"relu"``, as the JAX
package's ``activation`` argument.  The heads are ``nn.Sequential``s so
their parameters carry the reference's state-dict names
(``metadata_branch.{0,1,4}``, ``combined_head.{0,2,5}``, ``head.{0,2,5}``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import IMAGE_ONLY_MODELS, METADATA_ONLY_MODELS, MULTIMODAL_MODELS
from ..parallel.mesh import all_reduce_sum


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
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def _flax_batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                           dims: tuple[int, ...]) -> torch.Tensor:
    """Train-mode BatchNorm over ``dims`` of x, channels last: the flax
    rule in float32, the running statistics updated in place."""
    xf = x.float()
    if bn.data_group is None:
        mean = xf.mean(dim=dims)
        var = torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
    else:
        group, size = bn.data_group
        count = size * xf.numel() // xf.shape[-1]
        sums = all_reduce_sum(torch.stack([xf.sum(dim=dims), xf.square().sum(dim=dims)]),
                              group)
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean.square(), min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(0.1 * mean)
        bn.running_var.mul_(0.9).add_(0.1 * var)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    return ((xf - mean) * mul + bn.bias.float()).to(x.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    data_group = None   # (group, size) under a mesh with a data axis > 1

    def __init__(self, n: int):
        super().__init__(n, eps=1e-5, momentum=0.1)  # flax momentum 0.9

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm_train(self, x, (0,))


def batch_norm_nhwc(x: torch.Tensor, mean, var, weight, bias, eps: float) -> torch.Tensor:
    """Eval-mode BatchNorm of an NHWC map over its channel axis, on its NCHW
    view: float32 inside whatever the input's type; NHWC out."""
    return F.batch_norm(x.permute(0, 3, 1, 2), mean, var, weight, bias, False, 0.0,
                        eps).permute(0, 2, 3, 1)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm of an NHWC map over its last (channel) axis."""
    data_group = None

    def __init__(self, n: int):
        super().__init__(n, eps=1e-5, momentum=0.1)  # flax momentum 0.9

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return _flax_batch_norm_train(self, x, (0, 1, 2))
        return batch_norm_nhwc(x, self.running_mean, self.running_var, self.weight,
                               self.bias, self.eps)


class Dropout(nn.Dropout):
    generator: torch.Generator | None = None
    rows: tuple[int, int] | None = None   # (data index, data size) under a mesh

    def _mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        shape = self._mask_shape(x)
        if self.rows is None:
            keep = x.new_empty(shape).bernoulli_(1 - self.p, generator=self.generator)
        else:  # the global batch's mask, this rank's rows of it
            index, size = self.rows
            keep = x.new_empty((size * shape[0],) + shape[1:]).bernoulli_(
                1 - self.p, generator=self.generator).narrow(0, index * shape[0], shape[0])
        return x * keep / (1 - self.p)


class Dropout2d(Dropout):
    """Channel-wise dropout of an NHWC map: one draw per (alert, channel)."""

    def _mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        return (x.shape[0], 1, 1, x.shape[3])


def set_dropout_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Draw every ``Dropout`` mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_data_parallel(model: nn.Module, mesh) -> None:
    """Give every train-mode BatchNorm of ``model`` the global batch's
    statistics and every Dropout the global batch's mask under ``mesh``
    (None, or a data axis of 1: this process's batch is the whole batch)."""
    size = 1 if mesh is None else mesh.shape["data"]
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rows = (mesh.data_index, size) if size > 1 else None
        elif isinstance(m, (BatchNorm1d, BatchNorm2d)):
            m.data_group = (mesh.data_group, size) if size > 1 else None


def check_inputs(model_name: str, image_input, metadata_input) -> None:
    """A clear error when a modality the model needs is missing."""
    if model_name in IMAGE_ONLY_MODELS + MULTIMODAL_MODELS and image_input is None:
        raise ValueError(f"{model_name} requires image_input (NHWC triplets)")
    if model_name in METADATA_ONLY_MODELS + MULTIMODAL_MODELS and metadata_input is None:
        raise ValueError(f"{model_name} requires metadata_input")


ACTIVATIONS = {"gelu": GELU, "relu": nn.ReLU}


class MetadataBranch(nn.Sequential):
    def __init__(self, n_in: int, fc1: int, fc2: int, dropout: float,
                 activation: str = "gelu", final_activation: bool = True):
        act = ACTIVATIONS[activation]
        super().__init__(
            BatchNorm1d(n_in),
            Linear(n_in, fc1),
            act(),
            Dropout(dropout),
            Linear(fc1, fc2),
            *([act()] if final_activation else []),
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """``dtype``: the compute type after the BatchNorm (default x's)."""
        bn, *rest = self
        x = bn(x).to(dtype or x.dtype)
        for layer in rest:
            x = layer(x)
        return x


def head_layers(n_in: int, fc1: int, fc2: int, dropout: float,
                activation: str = "gelu") -> list[nn.Module]:
    """Linear → act → Linear → act → Dropout → Linear(1)."""
    act = ACTIVATIONS[activation]
    return [Linear(n_in, fc1), act(), Linear(fc1, fc2), act(), Dropout(dropout),
            Linear(fc2, 1)]


class CombinedHead(nn.Sequential):
    def __init__(self, n_in: int, fc1: int, fc2: int, dropout: float,
                 activation: str = "gelu"):
        super().__init__(*head_layers(n_in, fc1, fc2, dropout, activation))


class ImageHead(CombinedHead):
    """The single-modal models' classifier head (the same layers)."""
