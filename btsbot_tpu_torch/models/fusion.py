"""Frozen fusion of two trained single-modal models (port of
btsbot_tpu.models.fusion; reference ``frozen_fusion``).

A trained image model and a trained metadata model lose their heads; both
branches are frozen and a new combined head (ReLU) is trained on their
concatenated features.  Head stripping per branch:

* ``um_cnn`` → the flattened conv map (``image_branch.conv_layers``);
* ``ConvNeXt`` → global pool + head LayerNorm (``image_branch.convnext``
  with ``head.1``), every block through the block kernel on the card;
* ``MaxViT`` → resize to the branch's own native size, backbone, global
  pool (``image_branch.maxvit``, no head parameters; its BatchNorm
  statistics come with the branch);
* ``um_nn`` → BatchNorm → fc1 → ReLU → Dropout → fc2, with no trailing
  ReLU (``meta_branch.network.{0,1,4}``).

Freezing is the train state's business (engine.state): the optimizer takes
only the combined head's parameters.  The branches keep their standalone
names under ``image_branch.`` / ``meta_branch.``, so
``load_fusion_branches`` grafts trained ``best_model.pth`` files (a port
run's or the reference trainer's) onto the fusion model's state dict.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from ..core.config import normalize_config
from ..ops.resize import resize_bilinear
from .cnn import CnnBackbone, cnn_feature_size
from .common import CombinedHead, MetadataBranch, check_inputs
from .convnext import backbone_from_config, convnext_spec
from .maxvit import backbone_from_config as maxvit_backbone_from_config
from .maxvit import feature_size as maxvit_feature_size
from .maxvit import image_size as maxvit_image_size


def resolve_fusion_config(config) -> dict:
    """Fill image_model_config / meta_model_config from the branch model
    dirs' report.json when not given inline."""
    config = dict(config)
    for key, dir_key in (("image_model_config", "image_model_dir"),
                         ("meta_model_config", "meta_model_dir")):
        if config.get(key) is None:
            with open(os.path.join(config[dir_key], "report.json")) as f:
                config[key] = json.load(f)["train_config"]
    return config


class ImageFeatures(nn.Module):
    """Head-stripped image branch: NHWC images → (N, features)."""

    def __init__(self, branch_config):
        super().__init__()
        self.kind = branch_config["model_name"]
        if self.kind == "um_cnn":
            self.conv_layers = CnnBackbone(branch_config)
            self.n_features = cnn_feature_size(branch_config)
        elif self.kind == "ConvNeXt":
            self.convnext = backbone_from_config(branch_config, head_norm=True)
            self.n_features = convnext_spec(branch_config.get(
                "model_kind", "convnext_nano.d1h_in1k"))["dims"][-1]
        elif self.kind == "MaxViT":
            self.maxvit = maxvit_backbone_from_config(branch_config)
            self.image_size = maxvit_image_size(branch_config)
            self.n_features = maxvit_feature_size(branch_config)
        else:
            raise ValueError(f"Model {self.kind} not supported as fusion image branch")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "um_cnn":
            return self.conv_layers(x)
        if self.kind == "MaxViT":
            return self.maxvit(resize_bilinear(x, self.image_size))
        return self.convnext(x)


class MetaFeatures(nn.Module):
    """Head-stripped um_nn: ``network[:-2]`` of the standalone model."""

    def __init__(self, branch_config):
        super().__init__()
        self.network = MetadataBranch(
            len(branch_config["metadata_cols"]), branch_config["meta_fc1_neurons"],
            branch_config["meta_fc2_neurons"], branch_config["meta_dropout"], "relu",
            final_activation=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.network(x, dtype)


class FrozenFusion(nn.Module):
    def __init__(self, config):
        super().__init__()
        cfg = resolve_fusion_config(config)
        img_cfg = normalize_config(cfg["image_model_config"])
        meta_cfg = normalize_config(cfg["meta_model_config"])
        self.image_branch = ImageFeatures(img_cfg)
        self.meta_branch = MetaFeatures(meta_cfg)
        self.combined_head = CombinedHead(
            self.image_branch.n_features + meta_cfg["meta_fc2_neurons"],
            cfg["comb_fc1_neurons"], cfg["comb_fc2_neurons"], cfg["comb_dropout"],
            "relu")

    def forward(self, image_input=None, metadata_input=None) -> torch.Tensor:
        check_inputs("frozen_fusion", image_input, metadata_input)
        img = self.image_branch(image_input)
        meta = self.meta_branch(metadata_input, image_input.dtype)
        return self.combined_head(torch.cat([img, meta], dim=1))


FROZEN_PREFIXES = ("image_branch.", "meta_branch.")


def _branch_entries(name: str, sd: dict) -> dict:
    """A standalone model's state dict → the fusion branch's entries,
    heads stripped as the reference strips them."""
    if name == "um_cnn":
        return {f"image_branch.{k}": v for k, v in sd.items()
                if k.startswith("conv_layers.")}
    if name == "ConvNeXt":
        head = tuple(f"convnext.head.{i}." for i in (3, 5, 8))
        return {f"image_branch.{k}": v for k, v in sd.items()
                if k.startswith("convnext.") and not k.startswith(head)}
    if name == "MaxViT":
        return {f"image_branch.{k}": v for k, v in sd.items()
                if k.startswith("maxvit.") and not k.startswith("maxvit.head.")}
    if name == "um_nn":
        keep = tuple(f"network.{i}." for i in (0, 1, 4))
        return {f"meta_branch.{k}": v for k, v in sd.items() if k.startswith(keep)}
    raise ValueError(f"Model {name} not supported as fusion branch")


def load_fusion_branches(config, state_dict) -> dict:
    """``state_dict`` (a FrozenFusion's, reference names) with both branches
    replaced by the trained weights in ``image_model_dir`` /
    ``meta_model_dir`` (each a run directory holding ``best_model.pth``).
    Raises KeyError when a branch file does not fit the fusion model."""
    from ..engine.checkpoint import load_model_checkpoint

    cfg = resolve_fusion_config(config)
    out = dict(state_dict)
    for cfg_key, dir_key, prefix in (("image_model_config", "image_model_dir", "image_branch."),
                                     ("meta_model_config", "meta_model_dir", "meta_branch.")):
        branch_cfg = normalize_config(cfg[cfg_key])
        entries = _branch_entries(branch_cfg["model_name"],
                                  load_model_checkpoint(branch_cfg, cfg[dir_key]))
        want = {k for k in state_dict if k.startswith(prefix)}
        if set(entries) != want:
            raise KeyError(
                f"{cfg[dir_key]} does not fit the fusion's {prefix[:-1]}: missing "
                f"{sorted(want - set(entries))[:6]}, unexpected "
                f"{sorted(set(entries) - want)[:6]}")
        out.update(entries)
    return out
