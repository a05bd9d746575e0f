"""Faults planted in mm_MaxViT-over-MaxxViT, to show that the MaxxViT
cell's ``correct`` catches what is particular to it.  Each is a context
manager that puts a faulty plain version in the place of a part of the
program (on the card too: the kernel it replaces then does not run):

* ``table_zeroed``: every bias table zeroed in the attention;
* ``grid_as_window``: every grid attention run over windows;
* ``layer_scale_dropped``: γ₁ and γ₂ of every attention and MLP half
  taken as 1;
* ``multiplier_mod``: a strided depthwise conv whose output channel o reads
  input channel o % C_in in place of o // (C / C_in);
* ``heads_swapped``: the attention output's first two heads swapped.

The plain attention runs over 256 alerts at a time, so its scores fit the
card beside the served batch.  ``readings_maxxvit.py --fault NAME`` runs a
cell with one planted; the CPU tests (``test_bench_maxxvit.py``) run each.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .faults import patched
from .faults_maxvit import _heads_swapped, _reference

CHUNK = 256


def _attention(fn):
    """``fn(qkv, table, window, grid)`` in the place of the attention, over
    chunks of alerts."""
    from btsbot_tpu_torch.models import maxvit

    def attention(qkv, table, window, grid=False):
        return torch.cat([fn(q, table, window, grid) for q in qkv.split(CHUNK)])
    return patched(maxvit, "partition_attention", attention)


def _unit_scales(self, x):
    """``PartitionAttention.forward`` with γ₁ and γ₂ taken as 1."""
    from btsbot_tpu_torch.models.maxvit import LN_EPS, fused_ln_mlp

    b, h, w, c = x.shape
    x = x + self.attn(x, self.norm1)
    rows = x.reshape(-1, c)
    out = fused_ln_mlp(rows, rows, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                       self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                       torch.ones(c, dtype=x.dtype, device=x.device), eps=LN_EPS)
    return out.reshape(b, h, w, c)


def _multiplier_mod(conv, x):
    """``conv_nhwc`` with a channel multiplier m > 1 read as o % C_in."""
    from btsbot_tpu_torch.models.convnext import conv_nhwc

    c_in, c = conv.in_channels, conv.out_channels
    if c == c_in:
        return conv_nhwc(conv, x)
    idx = torch.arange(c, device=x.device) % c_in
    y = F.conv2d(x[..., idx].permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                 conv.bias.to(x.dtype), conv.stride, conv.padding, groups=c)
    return y.permute(0, 2, 3, 1)


def _maxxvit(attr, value):
    from btsbot_tpu_torch.models import maxxvit
    return patched(maxxvit, attr, value)


def _class(attr, value):
    from btsbot_tpu_torch.models import maxvit
    return patched(maxvit.PartitionAttention, attr, value)


FAULTS = {
    "table_zeroed": lambda: _attention(lambda q, t, w, g: _reference(q, torch.zeros_like(t), w, g)),
    "grid_as_window": lambda: _attention(lambda q, t, w, g: _reference(q, t, w, False)),
    "layer_scale_dropped": lambda: _class("forward", _unit_scales),
    "multiplier_mod": lambda: _maxxvit("conv_nhwc", _multiplier_mod),
    "heads_swapped": lambda: _attention(_heads_swapped),
}
