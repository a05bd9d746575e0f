"""MaxViT backbone and the MaxViT / mm_MaxViT models, NHWC (port of
btsbot_tpu.models.maxvit).

Same architecture as the JAX package (MaxViT, Tu et al. 2022, timm's
``maxvit_tiny_rw_224`` layout).  Each stage block is

    MBConv: pre-norm BatchNorm → 1×1 expand ×4 → BatchNorm → GELU →
      depthwise 3×3 (stride 2 in the first block of a stage, symmetric
      (1, 1) padding) → BatchNorm → GELU → squeeze-excite (SiLU, sigmoid;
      width 0.25 × the MBConv's *input* channels) → 1×1 project, plus a
      shortcut (2×2 average pool and a 1×1 conv when the stride is 2 or the
      width changes);
    → window attention over P×P partitions + MLP (pre-LN, eps 1e-5);
    → grid attention over P×P dilated grids + MLP,

with relative-position-biased multi-head attention (head dim 32) and P =
input size / 32 (7 at 224).  The stem is Conv 3×3/2 (no bias) → BatchNorm →
GELU → Conv 3×3.  The models resize the 63×63 triplets to the backbone's
native size first (``ops.resize``) and pool the final map with no norm.

An attention block runs on the map in its natural NHWC order: LN1, ``qkv``
and ``proj`` act on each token alone, so only the attention core needs the
partitions.  LN1 → qkv is ``ops.ln_qkv`` (``csrc/ln_qkv.cu``: one launch,
rounded where the modules round), and ``ops.partition_attention`` gathers
the partitions by index inside its kernel (``csrc/partition_attention.cu``;
on the CPU the plain partition → attention → reverse).  The MLP half,
x + fc2(GELU(fc1(LN2(x)))), is ``ops.ln_mlp.fused_ln_mlp`` with γ = 1 and
eps 1e-5 (``csrc/ln_mlp.cu`` in bfloat16, ``csrc/tf32x3.cu`` in float32).
In eval mode an MBConv's middle, BatchNorm → GELU → depthwise 3×3 →
BatchNorm → GELU, is ``ops.mbconv_dw`` (``csrc/mbconv_dw.cu``: one launch,
rounded where the modules round); in train mode, where BatchNorm takes the
batch's statistics, the modules run it.  So an eval forward runs four
kernels a block in seven launches (the MBConv's; ``ln_qkv``,
``partition_attention`` and ``fused_ln_mlp`` in each attention half), 77 at
maxvit_tiny's depths, and no partition copy.  The stem, the rest of each
MBConv (pre-norm, the cuBLAS 1×1 products, squeeze-excite, the shortcut),
proj and the heads are PyTorch's.  Spans ``maxvit.mbconv`` and
``maxvit.attention`` cover each block's two halves while a profiler
records.

Rounding points are the JAX package's: GELU erf in float32 and tanh in
bfloat16 (``models.common.gelu``); attention scores accumulated in float32
(q·scale in the compute type, both operands widened), the bias table
gathered and cast to the compute type and added in float32, softmax in
float32 then cast back; BatchNorm in float32 inside; the MLP half's as
``ln_mlp_reference`` rounds (each product in the compute type before its
bias).  Each op picks by device: the CPU runs the plain versions, the card
the kernels.

Module and parameter names are the reference's (timm maxxvit under
``maxvit.`` / ``maxvit_backbone.``), so the JAX exporter's state dicts and
reference checkpoints load with ``strict=True``.  The 1×1 convs keep
Conv2d weights (O, I, 1, 1) and run as a product over the channel axis.

A ``maxxvit_rmlp_*`` model kind (``MAXXVIT_CONFIGS``; no JAX counterpart)
gives both models timm's MaxxViT backbone instead (``models.maxxvit``:
ConvNeXt blocks in place of the MBConvs, a bias table made by an MLP,
LayerScale), on this module's attention halves.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ln_mlp import fused_ln_mlp
from ..ops.ln_qkv import ln_qkv
from ..ops.mbconv_dw import mbconv_dw
from ..ops.partition_attention import (  # noqa: F401 — re-exported for callers of the model
    HEAD_DIM,
    grid_partition,
    grid_reverse,
    partition_attention,
    window_partition,
    window_reverse,
)
from ..ops.partition_attention import rel_position_index as _rel_position_index  # noqa: F401
from ..ops.resize import resize_bilinear
from ..utils.profiling import annotate
from .common import (
    BatchNorm2d,
    CombinedHead,
    Conv2d,
    LayerNorm,
    Linear,
    MetadataBranch,
    check_inputs,
    gelu,
    head_layers,
)
from .convnext import GlobalAvgPool

MAXVIT_CONFIGS: dict[str, dict] = {
    "maxvit_tiny": {"depths": (2, 2, 5, 2), "dims": (64, 128, 256, 512),
                    "stem_width": 64},
    "maxvit_small": {"depths": (2, 2, 5, 2), "dims": (96, 192, 384, 768),
                     "stem_width": 64},
    "maxvit_base": {"depths": (2, 6, 14, 2), "dims": (96, 192, 384, 768),
                    "stem_width": 64},
}
# timm's MaxxViT (models/maxxvit.py, ``maxxvit_rmlp_*_rw_256``): ConvNeXt
# blocks in place of the MBConvs, an MLP-made bias, LayerScale; the stem's
# two widths
MAXXVIT_CONFIGS: dict[str, dict] = {
    "maxxvit_rmlp_nano": {"depths": (1, 2, 3, 1), "dims": (64, 128, 256, 512),
                          "stem_width": (32, 64)},
    "maxxvit_rmlp_tiny": {"depths": (2, 2, 5, 2), "dims": (64, 128, 256, 512),
                          "stem_width": (32, 64)},
    "maxxvit_rmlp_small": {"depths": (2, 2, 5, 2), "dims": (96, 192, 384, 768),
                           "stem_width": (48, 96)},
}
DEFAULT_KIND = "maxvit_tiny_rw_224.sw_in1k"
LN_EPS = 1e-5


def maxvit_spec(model_kind: str) -> dict:
    m = re.search(r"(maxvit_[a-z]+)", model_kind)
    if not m or m.group(1) not in MAXVIT_CONFIGS:
        raise ValueError(f"Unknown MaxViT variant in model_kind: {model_kind}")
    return MAXVIT_CONFIGS[m.group(1)]


def is_maxxvit(model_kind: str) -> bool:
    return "maxxvit" in model_kind.lower()


def maxxvit_spec(model_kind: str) -> dict:
    m = re.search(r"(maxxvit_rmlp_[a-z]+)", model_kind)
    if not m or m.group(1) not in MAXXVIT_CONFIGS:
        raise ValueError(f"Unknown MaxxViT variant in model_kind: {model_kind}")
    return MAXXVIT_CONFIGS[m.group(1)]


def get_model_image_size(model_kind: str) -> int:
    """Native input resolution from the timm model string: a terminal
    ``_<res>`` or one before a variant suffix (``maxvit_tiny_rw_224.sw_in1k``,
    ``maxxvit_rmlp_small_rw_256.sw_in1k``); 224 when there is none."""
    if re.search(r"maxx?vit", model_kind.lower()):
        m = re.search(r"_(\d+)(?=\.|$)", model_kind)
        if m:
            return int(m.group(1))
    return 224


def maxvit_window(model_kind: str) -> int:
    """Partition size: the native resolution / 32 (the final map's side)."""
    return max(1, get_model_image_size(model_kind) // 32)


class ConvNHWC(Conv2d):
    """``Conv2d`` on an NHWC map (an NCHW view in, NHWC out)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PointwiseConv(Conv2d):
    """A 1×1 ``Conv2d`` on an NHWC map, as a product over the channel axis."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.out_channels, self.in_channels).to(x.dtype)
        return F.linear(x, w, None if self.bias is None else self.bias.to(x.dtype))


class Stem(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv1 = ConvNHWC(3, width, 3, stride=2, padding=1, bias=False)
        self.norm1 = BatchNorm2d(width)
        self.conv2 = ConvNHWC(width, width, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(gelu(self.norm1(self.conv1(x))))


class SqueezeExcite(nn.Module):
    def __init__(self, mid_chs: int, rd_chs: int):
        super().__init__()
        self.fc1 = PointwiseConv(mid_chs, rd_chs, 1)
        self.fc2 = PointwiseConv(rd_chs, mid_chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.silu(self.fc1(s))))


class Shortcut(nn.Module):
    """2×2 average pool (stride 2 only) → 1×1 conv."""

    def __init__(self, in_chs: int, out_chs: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv = PointwiseConv(in_chs, out_chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return self.conv(x)


class MBConv(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, stride: int, expand: int = 4,
                 se_ratio: float = 0.25):
        super().__init__()
        mid = in_chs * expand
        self.shortcut = (Shortcut(in_chs, out_chs, stride)
                         if stride == 2 or in_chs != out_chs else None)
        self.pre_norm = BatchNorm2d(in_chs)
        self.conv1_1x1 = PointwiseConv(in_chs, mid, 1, bias=False)
        self.norm1 = BatchNorm2d(mid)
        self.conv2_kxk = ConvNHWC(mid, mid, 3, stride=stride, padding=1, groups=mid,
                                  bias=False)
        self.norm2 = BatchNorm2d(mid)
        self.se = SqueezeExcite(mid, max(1, int(in_chs * se_ratio)))
        self.conv3_1x1 = PointwiseConv(mid, out_chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        x = self.conv1_1x1(self.pre_norm(x))
        if self.training:  # batch statistics: the chain as it stands
            x = gelu(self.norm2(self.conv2_kxk(gelu(self.norm1(x)))))
        else:
            x = mbconv_dw(x, _running(self.norm1), self.conv2_kxk.weight, _running(self.norm2),
                          self.conv2_kxk.stride[0], (self.norm1.eps, self.norm2.eps))
        return self.conv3_1x1(self.se(x)) + shortcut


def _running(bn: BatchNorm2d) -> tuple:
    """An eval-mode BatchNorm's (running mean, running var, weight, bias)."""
    return bn.running_mean, bn.running_var, bn.weight, bn.bias


class RelPos(nn.Module):
    """The (2w−1)² × heads bias table (its swin index is
    ``ops.partition_attention.rel_position_index``); a call returns it."""

    def __init__(self, window: int, num_heads: int):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window - 1) ** 2, num_heads), std=0.02))

    def forward(self) -> torch.Tensor:
        return self.relative_position_bias_table


class LayerScale(nn.Module):
    """A per-channel gain γ (timm ``LayerScale``, init 1e-6)."""

    def __init__(self, dim: int, init_value: float = 1e-6):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))


class RelPosAttention(nn.Module):
    """Multi-head self-attention with relative position bias over the P×P
    windows (``grid=False``) or grids of an NHWC map, in its natural order:
    the LayerNorm before it (``norm``, the block's LN1) and qkv in one
    ``ln_qkv`` → ``partition_attention`` → proj.  ``rel_pos`` is a module
    whose call gives the ((2P − 1)², heads) table (default ``RelPos``, a
    learned table); a layer scale ``gamma`` on proj's output is folded into
    proj's weight and bias (in float32, then the map's type)."""

    def __init__(self, dim: int, window: int, grid: bool, rel_pos: nn.Module | None = None):
        super().__init__()
        self.window, self.grid = window, grid
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos = RelPos(window, dim // HEAD_DIM) if rel_pos is None else rel_pos

    def forward(self, x: torch.Tensor, norm: LayerNorm,
                gamma: torch.Tensor | None = None) -> torch.Tensor:
        qkv = ln_qkv(x, norm.weight, norm.bias, self.qkv.weight, self.qkv.bias, norm.eps)
        out = partition_attention(qkv, self.rel_pos(), self.window, self.grid)
        if gamma is None:
            return self.proj(out)
        g = gamma.float()
        return F.linear(out, (self.proj.weight.float() * g[:, None]).to(out.dtype),
                        (self.proj.bias.float() * g).to(out.dtype))


class TransformerMlp(nn.Module):
    """fc1 / fc2 of the MLP half (run by ``fused_ln_mlp``)."""

    def __init__(self, dim: int, expand: int = 4):
        super().__init__()
        self.fc1 = Linear(dim, expand * dim)
        self.fc2 = Linear(expand * dim, dim)


class PartitionAttention(nn.Module):
    """Pre-LN attention + MLP over window (``grid=False``) or grid
    partitions of an NHWC map; ``rel_pos`` as ``RelPosAttention``'s.  With
    ``layer_scale`` (MaxxViT) each half's branch is scaled by its γ (``ls1``
    on the attention's, ``ls2`` on the MLP's); without, the MLP's γ is 1."""

    def __init__(self, dim: int, window: int, grid: bool, rel_pos: nn.Module | None = None,
                 layer_scale: bool = False):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = RelPosAttention(dim, window, grid, rel_pos)
        self.ls1 = LayerScale(dim) if layer_scale else None
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = TransformerMlp(dim)
        self.ls2 = LayerScale(dim) if layer_scale else None
        if not layer_scale:
            self.register_buffer("ones", torch.ones(dim), persistent=False)  # the MLP's γ

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x + self.attn(x, self.norm1, None if self.ls1 is None else self.ls1.gamma)
        rows = x.reshape(-1, c)
        out = fused_ln_mlp(rows, rows, self.norm2.weight, self.norm2.bias,
                           self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight,
                           self.mlp.fc2.bias, self.ones if self.ls2 is None else self.ls2.gamma,
                           eps=LN_EPS)
        return out.reshape(b, h, w, c)


class MaxViTBlock(nn.Module):
    def __init__(self, in_chs: int, dim: int, stride: int, window: int):
        super().__init__()
        self.conv = MBConv(in_chs, dim, stride)
        self.attn_block = PartitionAttention(dim, window, grid=False)
        self.attn_grid = PartitionAttention(dim, window, grid=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("maxvit.mbconv"):
            x = self.conv(x)
        with annotate("maxvit.attention"):
            return self.attn_grid(self.attn_block(x))


class MaxViTStage(nn.Module):
    """``depth`` blocks of ``block`` (MaxViT's or MaxxViT's); the first takes
    ``in_chs`` channels at stride 2."""

    def __init__(self, in_chs: int, dim: int, depth: int, window: int,
                 block: type = MaxViTBlock):
        super().__init__()
        self.blocks = nn.ModuleList(
            block(in_chs if b == 0 else dim, dim, 2 if b == 0 else 1, window)
            for b in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class MaxViTBackbone(nn.Module):
    """NHWC images at the native size → ``head`` of the pooled final map
    (``head`` = [pool] + ``head``; the pool has no parameters)."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int], stem_width: int,
                 window: int, head: Sequence[nn.Module] = ()):
        super().__init__()
        self.stem = Stem(stem_width)
        self.stages = nn.ModuleList(
            MaxViTStage(([stem_width] + list(dims))[s], dims[s], depths[s], window)
            for s in range(len(depths)))
        self.head = nn.Sequential(GlobalAvgPool(), *head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for stage in self.stages:
            x = stage(x)
        return self.head(x)


def backbone_from_config(config, head: Sequence[nn.Module] = ()) -> nn.Module:
    """The MaxViT backbone of the config's ``model_kind``, or the MaxxViT one
    (``models.maxxvit``) for a ``maxxvit_*`` kind."""
    kind = config.get("model_kind", DEFAULT_KIND)
    if is_maxxvit(kind):
        from .maxxvit import MaxxViTBackbone  # it builds on this module's layers

        spec = maxxvit_spec(kind)
        return MaxxViTBackbone(spec["depths"], spec["dims"], spec["stem_width"],
                               maxvit_window(kind), head)
    spec = maxvit_spec(kind)
    return MaxViTBackbone(spec["depths"], spec["dims"], spec["stem_width"],
                          maxvit_window(kind), head)


def feature_size(config) -> int:
    kind = config.get("model_kind", DEFAULT_KIND)
    return (maxxvit_spec(kind) if is_maxxvit(kind) else maxvit_spec(kind))["dims"][-1]


def image_size(config) -> int:
    return get_model_image_size(config.get("model_kind", DEFAULT_KIND))


class MaxViTClassifier(nn.Module):
    """Image-only MaxViT (reference ``MaxViT``): resize → backbone → pool →
    ``ImageHead`` (GELU) inside ``maxvit.head`` (indices 1, 3, 6)."""

    def __init__(self, config):
        super().__init__()
        self.image_size = image_size(config)
        self.maxvit = backbone_from_config(config, head_layers(
            feature_size(config), config["fc1_neurons"], config["fc2_neurons"],
            config["dropout"], "gelu"))

    def forward(self, image_input=None, metadata_input=None) -> torch.Tensor:
        check_inputs("MaxViT", image_input, metadata_input)
        return self.maxvit(resize_bilinear(image_input, self.image_size))


class MmMaxViT(nn.Module):
    """Multi-modal MaxViT (reference ``mm_MaxViT``)."""

    def __init__(self, config):
        super().__init__()
        self.image_size = image_size(config)
        self.maxvit_backbone = backbone_from_config(config)
        self.metadata_branch = MetadataBranch(
            len(config["metadata_cols"]), config["meta_fc1_neurons"],
            config["meta_fc2_neurons"], config["meta_dropout"])
        self.combined_head = CombinedHead(
            feature_size(config) + config["meta_fc2_neurons"], config["comb_fc1_neurons"],
            config["comb_fc2_neurons"], config["comb_dropout"])

    def forward(self, image_input=None, metadata_input=None) -> torch.Tensor:
        """Logits (N, 1); the images' type is the compute type."""
        check_inputs("mm_MaxViT", image_input, metadata_input)
        x = self.maxvit_backbone(resize_bilinear(image_input, self.image_size))
        meta = self.metadata_branch(metadata_input, image_input.dtype)
        return self.combined_head(torch.cat([x, meta], dim=1))
