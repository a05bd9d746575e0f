"""ConvNeXt backbone and mm_ConvNeXt, NHWC (port of btsbot_tpu.models.convnext).

Same architecture as the JAX package (timm ConvNeXt-v1):

* patchify stem: Conv 4×4/4 + LayerNorm (eps 1e-6);
* stage downsampling: LayerNorm + Conv 2×2/2;
* block: depthwise Conv 7×7 (SAME) → LayerNorm → Linear(4·dim) → GELU →
  Linear(dim) → layer-scale γ (init 1e-6) → residual.  The block's forward
  is ``ops.convnext_block.convnext_block_fused``: the CUDA kernel on the
  card, its plain version on the CPU; in training its backward recomputes
  the plain version.

The images' type is the compute type: the stem, downsample and head layers
(``models.common``) cast float32 parameters to it, as the block kernel
does, so a float32 model trains with a bfloat16 forward.

Activations stay channels-last (NHWC) as in the JAX package; the convs see
an NCHW view of the same memory.  Module and parameter names are the
reference's, so ``interop.weights.state_dict_from_jax`` output and reference
torch checkpoints load with ``strict=True``.

``MmConvNeXt`` keeps both heads: pool + LayerNorm + flatten when "LS" is in
``train_data_version``, else a flatten of the final map (1×1 for 63×63
input), in NHWC order as the JAX model flattens.  ``ConvNeXtClassifier``
(reference ``ConvNeXt``) is image-only: its ``convnext.head`` is the
reference's [pool, norm, flatten, fc1, GELU, fc2, GELU, dropout, out].

Not ported yet (ROADMAP): the ``inceptionnext_*`` mixer and ``DWConvDense``
(a TPU lowering choice with the same math as the depthwise conv, so the
``dwconv_dense`` config key is ignored here).
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
from torch import nn

from ..ops.convnext_block import convnext_block_fused, convnext_block_reference
from .common import (
    CombinedHead,
    Conv2d,
    LayerNorm,
    MetadataBranch,
    check_inputs,
    head_layers,
)

# depths / dims for the timm ConvNeXt model names used by BTSbot checkpoints.
CONVNEXT_CONFIGS: dict[str, dict] = {
    "convnext_atto": {"depths": (2, 2, 6, 2), "dims": (40, 80, 160, 320)},
    "convnext_femto": {"depths": (2, 2, 6, 2), "dims": (48, 96, 192, 384)},
    "convnext_pico": {"depths": (2, 2, 6, 2), "dims": (64, 128, 256, 512)},
    "convnext_nano": {"depths": (2, 2, 8, 2), "dims": (80, 160, 320, 640)},
    "convnext_tiny": {"depths": (3, 3, 9, 3), "dims": (96, 192, 384, 768)},
    "convnext_small": {"depths": (3, 3, 27, 3), "dims": (96, 192, 384, 768)},
    "convnext_base": {"depths": (3, 3, 27, 3), "dims": (128, 256, 512, 1024)},
}


def convnext_spec(model_kind: str) -> dict:
    """Resolve a timm-style model string (e.g. 'convnext_pico.d1_in1k' or
    'mwalmsley/zoobot-encoder-convnext_pico') to depths/dims.

    ``inceptionnext_<size>`` kinds reuse the matching ConvNeXt size with the
    decomposed InceptionNeXt mixer; '.r<k>' sets the block MLP ratio."""
    m = re.search(r"inceptionnext_([a-z]+)", model_kind)
    if m:
        base = f"convnext_{m.group(1)}"
        if base not in CONVNEXT_CONFIGS:
            raise ValueError(
                f"Unknown InceptionNeXt variant in model_kind: {model_kind}")
        spec = {**CONVNEXT_CONFIGS[base], "token_mixer": "inception"}
        r = re.search(r"\.r(\d+)", model_kind)
        if r:
            spec["mlp_ratio"] = int(r.group(1))
        return spec
    m = re.search(r"(convnext_[a-z]+)", model_kind)
    if not m or m.group(1) not in CONVNEXT_CONFIGS:
        raise ValueError(f"Unknown ConvNeXt variant in model_kind: {model_kind}")
    return CONVNEXT_CONFIGS[m.group(1)]


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an ``nn.Conv2d`` to an NHWC tensor, returning NHWC."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """The block MLP's parameters (reference names ``mlp.fc1`` / ``mlp.fc2``);
    the block's kernel applies them."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, ls_init_value: float = 1e-6):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(ls_init_value)))

    def block_params(self) -> tuple:
        return (self.conv_dw.weight, self.conv_dw.bias, self.norm.weight,
                self.norm.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
                self.mlp.fc2.weight, self.mlp.fc2.bias, self.gamma)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x (B, H, W, C).  ``plain=True`` runs the plain PyTorch version on
        any device (for holding the kernel against it)."""
        fn = convnext_block_reference if plain else convnext_block_fused
        return fn(x, *self.block_params())


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool):
        super().__init__()
        self.downsample = nn.Sequential(
            LayerNorm(in_dim, eps=1e-6),
            Conv2d(in_dim, dim, 2, stride=2),
        ) if downsample else None
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim) for _ in range(depth))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if self.downsample is not None:
            x = conv_nhwc(self.downsample[1], self.downsample[0](x))
        for block in self.blocks:
            x = block(x, plain)
        return x


class GlobalAvgPool(nn.Module):
    """(N, H, W, C) → (N, C) mean (timm 'avg' pooling)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2))


class ConvNeXtBackbone(nn.Module):
    """NHWC in; with ``head_norm`` pooled + normed (N, C) out, else the final
    map flattened in NHWC order."""

    def __init__(self, depths: Sequence[int] = (2, 2, 6, 2),
                 dims: Sequence[int] = (64, 128, 256, 512),
                 head_norm: bool = False):
        super().__init__()
        self.stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4),
                                  LayerNorm(dims[0], eps=1e-6))
        self.stages = nn.ModuleList(
            ConvNeXtStage(dims[max(s - 1, 0)], dims[s], depths[s], s > 0)
            for s in range(len(depths)))
        self.head = nn.Sequential(GlobalAvgPool(), LayerNorm(dims[-1], eps=1e-6),
                                  nn.Flatten()) if head_norm else nn.Flatten()

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = self.stem[1](conv_nhwc(self.stem[0], x))
        for stage in self.stages:
            x = stage(x, plain)
        return self.head(x)


def _final_map_size(image_size: int, n_stages: int) -> int:
    s = (image_size - 4) // 4 + 1
    for _ in range(n_stages - 1):
        s = (s - 2) // 2 + 1
    return s


def backbone_from_config(config, head_norm: bool) -> ConvNeXtBackbone:
    spec = convnext_spec(config.get("model_kind", "convnext_nano.d1h_in1k"))
    if spec.get("token_mixer", "dwconv7") != "dwconv7":
        raise NotImplementedError(
            "inceptionnext_* model kinds are not ported yet (ROADMAP "
            "Queue A: InceptionMixer)")
    return ConvNeXtBackbone(spec["depths"], spec["dims"], head_norm)


class ConvNeXtClassifier(nn.Module):
    """Image-only ConvNeXt (reference ``ConvNeXt``): pool → LayerNorm →
    ``ImageHead`` (GELU) inside ``convnext.head``."""

    def __init__(self, config):
        super().__init__()
        self.convnext = backbone_from_config(config, head_norm=True)
        n = convnext_spec(config.get("model_kind", "convnext_nano.d1h_in1k"))["dims"][-1]
        for layer in head_layers(n, config["fc1_neurons"], config["fc2_neurons"],
                                 config["dropout"], "gelu"):
            self.convnext.head.append(layer)

    def forward(self, image_input=None, metadata_input=None,
                plain: bool = False) -> torch.Tensor:
        check_inputs("ConvNeXt", image_input, metadata_input)
        return self.convnext(image_input, plain)


class MmConvNeXt(nn.Module):
    """Multi-modal ConvNeXt (reference ``mm_ConvNeXt``)."""

    def __init__(self, config):
        super().__init__()
        spec = convnext_spec(config.get("model_kind", "convnext_nano.d1h_in1k"))
        head_norm = "LS" in config.get("train_data_version", "")
        self.convnext_backbone = backbone_from_config(config, head_norm)
        side = _final_map_size(int(config.get("image_size", 63)), len(spec["dims"]))
        n_img = spec["dims"][-1] * (1 if head_norm else side * side)
        n_meta = len(config["metadata_cols"])
        self.metadata_branch = MetadataBranch(
            n_meta, config["meta_fc1_neurons"], config["meta_fc2_neurons"],
            config["meta_dropout"])
        self.combined_head = CombinedHead(
            n_img + config["meta_fc2_neurons"], config["comb_fc1_neurons"],
            config["comb_fc2_neurons"], config["comb_dropout"])

    def forward(self, image_input=None, metadata_input=None,
                plain: bool = False) -> torch.Tensor:
        """Logits (N, 1) from NHWC images and (N, n_meta) metadata.  The
        images' type is the compute type: float32 parameters are cast to it
        at use, and the metadata BatchNorm's float32 output too."""
        check_inputs("mm_ConvNeXt", image_input, metadata_input)
        x = self.convnext_backbone(image_input, plain)
        meta = self.metadata_branch(metadata_input, image_input.dtype)
        return self.combined_head(torch.cat([x, meta], dim=1))
