"""Metadata-only MLP (port of btsbot_tpu.models.mlp; reference ``um_nn``):
BatchNorm → Linear → ReLU → Dropout → Linear → ReLU → Linear(1), one
Sequential ``network.{0,1,4,6}`` (indices 2, 3 and 5 hold no parameters).

The metadata's type is the compute type (the train and eval steps cast it
to the config's ``compute_dtype``)."""

from __future__ import annotations

import torch
from torch import nn

from .common import Linear, MetadataBranch, check_inputs


class UmNN(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.network = MetadataBranch(
            len(config["metadata_cols"]), config["meta_fc1_neurons"],
            config["meta_fc2_neurons"], config["meta_dropout"], "relu")
        self.network.append(Linear(config["meta_fc2_neurons"], 1))

    def forward(self, image_input=None, metadata_input=None,
                plain: bool = False) -> torch.Tensor:
        check_inputs("um_nn", image_input, metadata_input)
        return self.network(metadata_input)
