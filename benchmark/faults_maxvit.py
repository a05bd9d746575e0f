"""Faults planted in mm_MaxViT's attention, to show that the MaxViT cell's
``correct`` catches a wrong attention: each is a context manager that puts
a faulty plain version in the place of the model's ``partition_attention``
(on the card too: the kernel then does not run):

* ``bias_dropped``: the relative-position bias left out;
* ``grid_as_window``: every grid attention run over windows;
* ``pads_unmasked``: each partition's tokens padded to 64 with zero keys
  and values that the softmax is not told to skip;
* ``heads_swapped``: the output channels of a map's first two heads swapped.

``readings_maxvit.py --fault NAME`` runs a cell with one planted; the CPU
tests (``test_bench_maxvit.py``) run each.
"""

from __future__ import annotations

import torch

from .faults import patched

PADDED_TOKENS = 64


def _pads_unmasked(qkv, table, window, grid):
    from btsbot_tpu_torch.ops import partition_attention as pa

    _, h, w, c3 = qkv.shape
    c, n = c3 // 3, window * window
    heads = c // pa.HEAD_DIM
    partition, reverse = ((pa.grid_partition, pa.grid_reverse) if grid
                          else (pa.window_partition, pa.window_reverse))
    t = partition(qkv, window)
    bn = t.shape[0]
    q, k, v = t.reshape(bn, n, 3, heads, pa.HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)
    q = q * pa.HEAD_DIM ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-2, -1))
    s = s + pa.relative_bias(table, window).to(qkv.dtype)
    s = torch.cat([s, s.new_zeros(s.shape[:-1] + (PADDED_TOKENS - n,))], dim=-1)
    s = torch.softmax(s, dim=-1)[..., :n].to(qkv.dtype)
    out = torch.matmul(s, v).transpose(1, 2).reshape(bn, n, c)
    return reverse(out, window, h, w)


def _heads_swapped(qkv, table, window, grid):
    from btsbot_tpu_torch.ops.partition_attention import HEAD_DIM, partition_attention_reference

    out = partition_attention_reference(qkv, table, window, grid)
    d = HEAD_DIM
    return torch.cat([out[..., d:2 * d], out[..., :d], out[..., 2 * d:]], dim=-1)


def _plain(fn):
    from btsbot_tpu_torch.models import maxvit
    return patched(maxvit, "partition_attention",
                   lambda qkv, table, window, grid=False: fn(qkv, table, window, grid))


def _reference(qkv, table, window, grid):
    from btsbot_tpu_torch.ops.partition_attention import partition_attention_reference

    return partition_attention_reference(qkv, table, window, grid)


FAULTS = {
    "bias_dropped": lambda: _plain(lambda q, t, w, g: _reference(q, torch.zeros_like(t), w, g)),
    "grid_as_window": lambda: _plain(lambda q, t, w, g: _reference(q, t, w, False)),
    "pads_unmasked": lambda: _plain(_pads_unmasked),
    "heads_swapped": lambda: _plain(_heads_swapped),
}
