"""The VGG-style CNNs, NHWC (port of btsbot_tpu.models.cnn).

The production BTSbot v1 family (reference ``mm_cnn`` / ``um_cnn``):

* ``CnnBackbone`` — two blocks of [Conv k×k 'same' → ReLU] ×2 → MaxPool
  (2, then 4; floor: 63 → 31 → 7) → channel-wise Dropout2d;
* ``MmCnn`` — the backbone's features concatenated with the metadata
  branch (ReLU), then the combined head (ReLU);
* ``UmCnn`` — the backbone then ``ImageHead`` (ReLU).

Activations stay channels-last (NHWC); each conv and pool sees an NCHW view
of the same memory, which cuDNN takes as a ``channels_last`` tensor without
a copy.  The backbone is the reference's ``conv_layers`` Sequential, so its
convs are ``conv_layers.{0,2,6,8}``.

The final map is flattened in **NCHW order**, as the reference flattens:
reference checkpoints load unchanged.  (The JAX model flattens NHWC and
permutes the first dense layer instead; ``interop.weights`` undoes that
permutation.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    CombinedHead,
    Conv2d,
    Dropout2d,
    ImageHead,
    MetadataBranch,
    check_inputs,
)


class ConvNHWC(Conv2d):
    """A 'same'-padded stride-1 conv on an NHWC map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MaxPoolNHWC(nn.MaxPool2d):
    """k×k / k max-pool (floor) on an NHWC map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x.permute(0, 3, 1, 2), self.kernel_size,
                            self.stride).permute(0, 2, 3, 1)


def cnn_feature_size(config) -> int:
    """Flattened feature count: conv2_channels · (image_size // 8)²."""
    side = int(config.get("image_size", 63)) // 8
    return int(config["conv2_channels"]) * side * side


class CnnBackbone(nn.Sequential):
    """NHWC images → (N, C·H·W) features, flattened in NCHW order."""

    def __init__(self, config):
        c1, c2 = int(config["conv1_channels"]), int(config["conv2_channels"])
        k = int(config["conv_kernel"])
        super().__init__(
            ConvNHWC(3, c1, k, padding="same"), nn.ReLU(),
            ConvNHWC(c1, c1, k, padding="same"), nn.ReLU(),
            MaxPoolNHWC(2), Dropout2d(float(config["conv_dropout1"])),
            ConvNHWC(c1, c2, k, padding="same"), nn.ReLU(),
            ConvNHWC(c2, c2, k, padding="same"), nn.ReLU(),
            MaxPoolNHWC(4), Dropout2d(float(config["conv_dropout2"])),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


class MmCnn(nn.Module):
    """Multi-modal CNN (reference ``mm_cnn``)."""

    def __init__(self, config):
        super().__init__()
        self.conv_layers = CnnBackbone(config)
        self.metadata_branch = MetadataBranch(
            len(config["metadata_cols"]), config["meta_fc1_neurons"],
            config["meta_fc2_neurons"], config["meta_dropout"], "relu")
        self.combined_head = CombinedHead(
            cnn_feature_size(config) + config["meta_fc2_neurons"],
            config["comb_fc1_neurons"], config["comb_fc2_neurons"],
            config["comb_dropout"], "relu")

    def forward(self, image_input=None, metadata_input=None,
                plain: bool = False) -> torch.Tensor:
        """Logits (N, 1); the images' type is the compute type.  ``plain``
        is taken for the common signature (no kernel here)."""
        check_inputs("mm_cnn", image_input, metadata_input)
        x = self.conv_layers(image_input)
        meta = self.metadata_branch(metadata_input, image_input.dtype)
        return self.combined_head(torch.cat([x, meta], dim=1))


class UmCnn(nn.Module):
    """Image-only CNN (reference ``um_cnn``)."""

    def __init__(self, config):
        super().__init__()
        self.conv_layers = CnnBackbone(config)
        self.head = ImageHead(cnn_feature_size(config), config["fc1_neurons"],
                              config["fc2_neurons"], config["dropout"], "relu")

    def forward(self, image_input=None, metadata_input=None,
                plain: bool = False) -> torch.Tensor:
        check_inputs("um_cnn", image_input, metadata_input)
        return self.head(self.conv_layers(image_input))
