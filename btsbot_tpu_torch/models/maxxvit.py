"""MaxxViT backbone, NHWC: the backbone of ``MaxViT`` / ``mm_MaxViT`` for a
``maxxvit_rmlp_*`` model kind (``models.maxvit.backbone_from_config``).

timm's MaxxViT (``models/maxxvit.py``, ``maxxvit_rmlp_small_rw_256``: MaxViT,
arXiv:2204.01697, with ConvNeXt blocks, arXiv:2201.03545, in place of the
MBConvs).  With stem widths (S₀, S₁), stage widths C and depths from
``MAXXVIT_CONFIGS``, head dim 32 and P = input size / 32 (8 at 256):

* stem: conv 3×3 / 2 pad 1, 3 → S₀, no bias → LayerNorm (eps 1e-6) → GELU
  → conv 3×3 / 1 pad 1, S₀ → S₁ with bias;
* each block: a ConvNeXt half, window attention + MLP, grid attention + MLP;
* ConvNeXt half (timm's ``ConvNeXtBlock``): x ← shortcut + γ_c ⊙
  fc2(GELU(fc1(LN(h)))), LN eps 1e-6, hidden 4C.  In a stage's first block
  (stride 2) shortcut = 2×2 / 2 average pool, then a 1×1 conv C_in → C
  where C_in ≠ C, and h = depthwise 7×7 / 2 pad 3, groups C_in, C_in → C
  (output channel o reads input channel o // (C / C_in)); elsewhere
  shortcut = x and h = depthwise 7×7 / 1 pad 3;
* attention half: x ← x + γ₁ ⊙ proj(Attn(qkv(LN(x)))), the MLP half x ← x
  + γ₂ ⊙ fc2(GELU(fc1(LN(x)))), LN eps 1e-5 (``maxvit.PartitionAttention``
  with ``layer_scale``);
* bias: a ((2P − 1)², heads) table made each forward by an MLP from the
  log-spaced offsets (timm ``RelPosMlp``, mode "cr"): table = W₂·ReLU(W₁·u
  + b₁) + b₂, u = sign(d)·ln(1 + |d|) for each (dy, dx) ∈ [−(P−1), P−1]²,
  W₁ 512 × 2, W₂ heads × 512, no sigmoid and no gain; the attention
  kernel gathers it at the swin index as it does MaxViT's learned table;
* the final map pooled (mean, no norm).

Kernels: a stride-1 ConvNeXt half is one ``convnext_block_fused`` launch
(``csrc/convnext_block.cu`` in bfloat16, ``csrc/tf32x3.cu`` in float32), as
a ConvNeXt block; a stride-2 one is cuDNN's grouped depthwise conv, then
``fused_ln_mlp`` (eps 1e-6, γ_c) with the pooled (and widened) shortcut as
its residual.  The attention halves run ``ln_qkv`` → ``partition_attention``
→ proj with γ₁ folded into proj's weight and bias, and the MLP halves
``fused_ln_mlp`` with γ₂ (``models.maxvit``).  Each table is built in
float32 from the parameters and cast to the compute type where MaxViT's
table is cast (the kernels' operands, or the plain attention's bias).
Rounding points are the port's: GELU erf in float32 and tanh in bfloat16
(``models.common.gelu``), the kernels' as their plain versions.

Spans ``maxxvit.conv`` (a block's ConvNeXt half), ``maxxvit.attention``
(its two attention halves) and ``maxxvit.relpos`` (each table's MLP), and
the counter ``maxxvit.relpos_tables`` (tables built), record while a
profiler does (``utils.profiling``).

Parameter names follow timm's module tree as ``models.maxvit``'s do
(``conv.conv_dw``, ``conv.norm``, ``conv.mlp.fc1``, ``conv.ls.gamma``,
``attn_block.attn.rel_pos.mlp.fc1``, ``attn_block.ls1.gamma``, ...; the
1×1 shortcut ``conv.shortcut.conv``, timm's ``shortcut.expand``, which
``interop.maxvit_convert`` renames).  The 1×1 convs keep Conv2d weights
(O, I, 1, 1).  Departures from timm: qkv's channels are (3, heads, 32),
the port's layout, where timm's ``head_first`` has (heads, 3, 32); the
table MLP has no dropout (timm's drops 1/8 of its hidden units in
training), so every rank of a mesh builds the same table.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convnext_block import convnext_block_fused
from ..ops.ln_mlp import fused_ln_mlp
from ..utils import profiling
from ..utils.profiling import annotate
from .common import Conv2d, LayerNorm, gelu
from .convnext import GlobalAvgPool, conv_nhwc
from .maxvit import (
    HEAD_DIM,
    ConvNHWC,
    LayerScale,
    MaxViTStage,
    PartitionAttention,
    PointwiseConv,
    Shortcut,
)

CONV_LN_EPS = 1e-6
REL_POS_DIM = 512
TAPS = 7


class Stem(nn.Module):
    def __init__(self, widths: Sequence[int]):
        super().__init__()
        self.conv1 = ConvNHWC(3, widths[0], 3, stride=2, padding=1, bias=False)
        self.norm1 = LayerNorm(widths[0], eps=CONV_LN_EPS)
        self.conv2 = ConvNHWC(widths[0], widths[1], 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(gelu(self.norm1(self.conv1(x))))


class ConvMlp(nn.Module):
    """fc1 / fc2 as 1×1 convs (timm ``ConvMlp``; the kernels apply them)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = PointwiseConv(dim, hidden, 1)
        self.fc2 = PointwiseConv(hidden, dim, 1)


class ConvNeXtHalf(nn.Module):
    """A MaxxViT block's ConvNeXt half (timm ``ConvNeXtBlock``, module
    docstring), NHWC in and out."""

    def __init__(self, in_chs: int, dim: int, stride: int, expand: int = 4):
        super().__init__()
        self.stride = stride
        self.shortcut = Shortcut(in_chs, dim, stride) if in_chs != dim else None
        self.conv_dw = Conv2d(in_chs, dim, TAPS, stride=stride, padding=TAPS // 2,
                              groups=in_chs)
        self.norm = LayerNorm(dim, eps=CONV_LN_EPS)
        self.mlp = ConvMlp(dim, expand * dim)
        self.ls = LayerScale(dim)

    def _mlp_params(self) -> tuple:
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        return (self.norm.weight, self.norm.bias,
                fc1.weight.reshape(fc1.out_channels, fc1.in_channels), fc1.bias,
                fc2.weight.reshape(fc2.out_channels, fc2.in_channels), fc2.bias, self.ls.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            return convnext_block_fused(x, self.conv_dw.weight, self.conv_dw.bias,
                                        *self._mlp_params())
        if self.shortcut is None:
            shortcut = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        else:
            shortcut = self.shortcut(x)
        h = conv_nhwc(self.conv_dw, x)
        c = h.shape[-1]
        out = fused_ln_mlp(h.reshape(-1, c), shortcut.reshape(-1, c), *self._mlp_params(),
                           eps=CONV_LN_EPS)
        return out.reshape(h.shape)


@functools.lru_cache(maxsize=None)
def log_coords(window: int, device: torch.device) -> torch.Tensor:
    """((2P − 1)², 2) float32 offsets (dy, dx), dy major, each as
    sign(d)·ln(1 + |d|): the table MLP's input, in the order of the swin
    index (``ops.partition_attention.rel_position_index``)."""
    with torch.inference_mode(False):  # a normal tensor, as autograd saves it
        d = torch.arange(-(window - 1), window, dtype=torch.float32)
        u = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).reshape(-1, 2)
        return (torch.sign(u) * torch.log1p(u.abs())).to(device)


class TableMlp(nn.Module):
    """u → fc2(ReLU(fc1(u))) in float32, whatever the parameters' type."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.fc1 = nn.Linear(2, hidden)
        self.fc2 = nn.Linear(hidden, heads)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        h = F.relu(F.linear(u, self.fc1.weight.float(), self.fc1.bias.float()))
        return F.linear(h, self.fc2.weight.float(), self.fc2.bias.float())


class RelPosMlp(nn.Module):
    """The bias table made by an MLP from the log-spaced offsets (timm
    ``RelPosMlp``, mode "cr"); a call returns it, ((2P − 1)², heads) in
    float32."""

    def __init__(self, window: int, num_heads: int, hidden: int = REL_POS_DIM):
        super().__init__()
        self.window = window
        self.mlp = TableMlp(hidden, num_heads)

    def forward(self) -> torch.Tensor:
        with annotate("maxxvit.relpos"):
            table = self.mlp(log_coords(self.window, self.mlp.fc1.weight.device))
        profiling.count("maxxvit.relpos_tables")
        return table


class MaxxViTBlock(nn.Module):
    def __init__(self, in_chs: int, dim: int, stride: int, window: int):
        super().__init__()
        self.conv = ConvNeXtHalf(in_chs, dim, stride)
        heads = dim // HEAD_DIM
        self.attn_block = PartitionAttention(dim, window, False, RelPosMlp(window, heads),
                                             layer_scale=True)
        self.attn_grid = PartitionAttention(dim, window, True, RelPosMlp(window, heads),
                                            layer_scale=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("maxxvit.conv"):
            x = self.conv(x)
        with annotate("maxxvit.attention"):
            return self.attn_grid(self.attn_block(x))


class MaxxViTBackbone(nn.Module):
    """NHWC images at the native size → ``head`` of the pooled final map
    (``head`` = [pool] + ``head``; the pool has no parameters)."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int],
                 stem_width: Sequence[int], window: int, head: Sequence[nn.Module] = ()):
        super().__init__()
        self.stem = Stem(stem_width)
        ins = [stem_width[-1]] + list(dims)
        self.stages = nn.ModuleList(
            MaxViTStage(ins[s], dims[s], depths[s], window, MaxxViTBlock)
            for s in range(len(depths)))
        self.head = nn.Sequential(GlobalAvgPool(), *head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for stage in self.stages:
            x = stage(x)
        return self.head(x)
