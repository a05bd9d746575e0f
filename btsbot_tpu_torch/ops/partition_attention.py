"""MaxViT's relative-position-biased attention over P×P windows or grids,
from the natural-order qkv map.

* the partitions (``window_partition`` / ``window_reverse``,
  ``grid_partition`` / ``grid_reverse``) and the swin-style bias index
  (``rel_position_index``), as the JAX package's models/maxvit.py has them;
* ``partition_attention_reference`` — the plain version: partition the qkv
  map, multi-head attention in each partition, reverse.  Its rounding
  points are the JAX package's: q·scale in the map's type, scores
  accumulated in float32 from both operands widened, the bias table
  gathered and cast to the map's type and added in float32, softmax in
  float32 then cast back, the second product in the map's type;
* ``partition_attention`` — the wrapper of ``csrc/partition_attention.cu``
  (no Pallas counterpart: the JAX package leaves this to XLA).  On a CUDA
  tensor it launches the kernel (bfloat16 on the tensor cores, float32 on
  the CUDA cores) or raises, and while a profiler records adds the bytes
  a launch moves (qkv read once, the output written once, the table) to
  the counter ``partition_attention.bytes``; only a CPU tensor takes the
  plain version.  Its
  backward recomputes the plain version, as ``fused_ln_mlp``'s does.

The map is (B, H, W, 3C) NHWC with q, k, v each C = heads × 32 channels
(head-major), as ``qkv`` writes them; the output is (B, H, W, C), each
token's heads back at its own pixel.  The table is ((2P − 1)², heads).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import profiling
from . import _build
from ._autograd import recompute_backward

HEAD_DIM = 32
MAX_WINDOW = 8  # the kernel pads a partition's P² tokens to 64


def rel_position_index(win: int) -> np.ndarray:
    """Swin-style (win², win²) index into a (2·win−1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win), indexing="ij"))
    coords = coords.reshape(2, -1)                          # (2, w²)
    rel = coords[:, :, None] - coords[:, None, :]           # (2, w², w²)
    rel = rel.transpose(1, 2, 0) + (win - 1)                # shift to ≥0
    return (rel[..., 0] * (2 * win - 1) + rel[..., 1]).astype(np.int32)


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) → (B·H/w·W/w, w², C): non-overlapping windows."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def window_reverse(x: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def grid_partition(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, H, W, C) → (B·H/g·W/g, g², C): dilated g×g grids (tokens strided
    by H/g, W/g across the whole map)."""
    b, h, w, c = x.shape
    x = x.reshape(b, grid, h // grid, grid, w // grid, c)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, grid * grid, c)


def grid_reverse(x: torch.Tensor, grid: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // grid, w // grid, grid, grid, c)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, h, w, c)


@functools.lru_cache(maxsize=None)
def _index(win: int, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference mode: autograd
    # saves it for the recompute backward of a later training step
    with torch.inference_mode(False):
        return torch.from_numpy(rel_position_index(win).astype(np.int64).reshape(-1)).to(device)


def relative_bias(table: torch.Tensor, win: int) -> torch.Tensor:
    """(heads, w², w²) bias of a ((2w−1)², heads) table, in its type."""
    n = win * win
    return table[_index(win, table.device)].reshape(n, n, -1).permute(2, 0, 1)


def partition_attention_reference(qkv: torch.Tensor, table: torch.Tensor, window: int,
                                  grid: bool) -> torch.Tensor:
    """Plain version: (B, H, W, 3C) → (B, H, W, C) through the partitions."""
    _, h, w, c3 = qkv.shape
    c, n = c3 // 3, window * window
    heads = c // HEAD_DIM
    partition, reverse = ((grid_partition, grid_reverse) if grid
                          else (window_partition, window_reverse))
    t = partition(qkv, window)
    bn = t.shape[0]
    q, k, v = t.reshape(bn, n, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)
    q = q * HEAD_DIM ** -0.5
    attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
    attn = attn + relative_bias(table, window).to(qkv.dtype)
    attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(bn, n, c)
    return reverse(out, window, h, w)


def attention_bytes(qkv: torch.Tensor, table: torch.Tensor) -> int:
    """Bytes a launch moves at least: qkv read once, the output (a third of
    qkv) written once, the table read once, in the map's type."""
    return (qkv.numel() + qkv.numel() // 3 + table.numel()) * qkv.element_size()


def _launch_partition_attention(qkv, table, window: int, grid: bool):
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * HEAD_DIM):
        raise ValueError(f"partition_attention: qkv must be (B, H, W, 3C) with C a multiple "
                         f"of {HEAD_DIM}, got {tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    heads = c3 // 3 // HEAD_DIM
    if not 1 <= window <= MAX_WINDOW or h % window or w % window:
        raise ValueError(f"partition_attention: the kernel takes P <= {MAX_WINDOW} dividing "
                         f"H and W, got P={window} on a {h}x{w} map")
    if table.shape != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"partition_attention: table {tuple(table.shape)} does not fit "
                         f"P={window}, {heads} heads")
    qkv, table = _build.kernel_operands(qkv, (table.contiguous(),), "partition_attention")
    out = qkv.new_empty((b, h, w, c3 // 3))
    err = _build.library().btsbot_partition_attention(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w, c3 // 3, window,
        int(grid), HEAD_DIM ** -0.5, int(qkv.dtype == torch.bfloat16),
        _build.current_stream(qkv))
    _build.check(err, f"partition_attention ({'grid' if grid else 'window'}, P={window}, "
                      f"{tuple(qkv.shape)})")
    profiling.count("partition_attention.bytes", attention_bytes(qkv, table))
    return out


class _PartitionAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, table, window, grid):
        ctx.save_for_backward(qkv, table)
        ctx.window, ctx.grid = window, grid
        return _launch_partition_attention(qkv, table, window, grid)

    @staticmethod
    def backward(ctx, grad_out):
        plain = functools.partial(partition_attention_reference, window=ctx.window,
                                  grid=ctx.grid)
        return recompute_backward(plain, ctx.saved_tensors, ctx.needs_input_grad[:2],
                                  grad_out) + (None, None)


def partition_attention(qkv: torch.Tensor, table: torch.Tensor, window: int,
                        grid: bool = False) -> torch.Tensor:
    """(B, H, W, 3C) natural-order qkv → (B, H, W, C) attention output over
    P×P windows (``grid=False``) or grids.  CUDA tensors go through the
    kernel, CPU tensors through ``partition_attention_reference``."""
    if qkv.device.type == "cpu":
        return partition_attention_reference(qkv, table, window, grid)
    return _PartitionAttention.apply(qkv, table, window, grid)
