"""MaxViT's LN1 → qkv — qkv = LayerNorm(x) · Wqkvᵀ + b over the channel
axis of an NHWC map — in one launch.

* ``ln_qkv_reference`` — the plain version, op for op as the modules of
  ``models.maxvit.PartitionAttention`` ran it: ``F.layer_norm`` (float32
  inside, the map's type out), then ``F.linear`` with the weight and bias
  cast to the map's type;
* ``ln_qkv`` — the wrapper of ``csrc/ln_qkv.cu`` (no Pallas counterpart:
  the JAX package leaves LN1 and qkv to XLA).  On a CUDA tensor it launches
  the kernel (bfloat16 at C = 64 … 512 in steps of 64 on the tensor cores,
  float32 and every other width on the CUDA cores; rounded where the plain
  version rounds) or raises; only a CPU tensor takes the plain version.  Its
  backward recomputes the plain version, as ``fused_ln_mlp``'s does.

x is (..., C) with C a multiple of 8, contiguous; the output (..., 3C):
q, k, v each C channels, head-major, as ``partition_attention`` reads them.
``weight`` is ``qkv.weight`` (3C, C), ``bias`` (3C,), ``ln_w`` / ``ln_b``
the LayerNorm's (C,).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from ._autograd import recompute_backward


def ln_qkv_reference(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version: ``F.linear(F.layer_norm(x))`` in x's type."""
    dtype = x.dtype
    xn = F.layer_norm(x, (x.shape[-1],), ln_w.to(dtype), ln_b.to(dtype), eps)
    return F.linear(xn, weight.to(dtype), bias.to(dtype))


def _launch_ln_qkv(x, ln_w, ln_b, weight, bias, eps: float):
    c = x.shape[-1]
    if x.dim() < 2 or c % 8:
        raise ValueError(f"ln_qkv: x must be (..., C) with C a multiple of 8, "
                         f"got {tuple(x.shape)}")
    if tuple(ln_w.shape) != (c,) or tuple(ln_b.shape) != (c,) or \
            tuple(weight.shape) != (3 * c, c) or tuple(bias.shape) != (3 * c,):
        raise ValueError(f"ln_qkv: LayerNorm {tuple(ln_w.shape)} / {tuple(ln_b.shape)}, "
                         f"qkv {tuple(weight.shape)} / {tuple(bias.shape)} do not fit C={c}")
    if x.dtype not in _build.KERNEL_DTYPES:
        raise TypeError(f"ln_qkv: the kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"ln_qkv: x of shape {tuple(x.shape)} is not contiguous")
    x, ln_w, ln_b, weight, bias = _build.kernel_operands(x, (ln_w, ln_b, weight, bias),
                                                         "ln_qkv")
    out = x.new_empty((*x.shape[:-1], 3 * c))
    err = _build.library().btsbot_ln_qkv(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        out.data_ptr(), x.numel() // c, c, eps, int(x.dtype == torch.bfloat16),
        _build.current_stream(x))
    _build.check(err, f"ln_qkv ({tuple(x.shape)}, {x.dtype})")
    return out


class _LnQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, weight, bias, eps):
        ctx.save_for_backward(x, ln_w, ln_b, weight, bias)
        ctx.eps = eps
        return _launch_ln_qkv(x, ln_w, ln_b, weight, bias, eps)

    @staticmethod
    def backward(ctx, grad_out):
        plain = functools.partial(ln_qkv_reference, eps=ctx.eps)
        return recompute_backward(plain, ctx.saved_tensors, ctx.needs_input_grad[:5],
                                  grad_out) + (None,)


def ln_qkv(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor, eps: float) -> torch.Tensor:
    """qkv of LayerNorm(x), (..., C) → (..., 3C).  CUDA tensors go through
    the kernel, CPU tensors through ``ln_qkv_reference``."""
    if x.device.type == "cpu":
        return ln_qkv_reference(x, ln_w, ln_b, weight, bias, eps)
    return _LnQkv.apply(x, ln_w, ln_b, weight, bias, eps)
