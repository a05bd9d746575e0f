"""MaxViT's MBConv middle — BatchNorm → GELU → depthwise 3×3 → BatchNorm →
GELU on an NHWC map — in one launch.

* ``mbconv_dw_reference`` — the plain version, op for op as the eval-mode
  modules of ``models.maxvit.MBConv`` run it: ``F.batch_norm`` on the
  running statistics (float32 inside, the map's type out), ``gelu`` (erf in
  float32, tanh in bfloat16), ``F.conv2d`` with ``groups`` = C, zero
  padding (1, 1) and the taps cast to the map's type, ``F.batch_norm``,
  ``gelu``;
* ``mbconv_dw`` — the wrapper of ``csrc/mbconv_dw.cu`` (no Pallas
  counterpart: the JAX package leaves the MBConv to XLA).  On a CUDA tensor
  it launches the kernel (bfloat16 or float32, rounded where the plain
  version rounds; BatchNorm folded into a float32 scale and shift in the
  kernel, which reads the taps and the BatchNorm vectors in place) or
  raises; only a CPU tensor takes the plain version.  Its backward
  recomputes the plain version, as ``fused_ln_mlp``'s does.

The map is (B, H, W, C) NHWC with C a multiple of 8; the output (B,
⌈H / s⌉, ⌈W / s⌉, C) at stride s = 1 or 2.  ``norm1`` / ``norm2`` are each
(running_mean, running_var, weight, bias), of shape (C,), and ``eps`` the
two BatchNorms' eps; ``taps`` is the depthwise conv's weight (C, 1, 3, 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.common import batch_norm_nhwc, gelu
from . import _build
from ._autograd import recompute_backward

BN_EPS = 1e-5


def mbconv_dw_reference(h: torch.Tensor, norm1, taps: torch.Tensor, norm2, stride: int,
                        eps=(BN_EPS, BN_EPS)) -> torch.Tensor:
    """Plain version: GELU(BN2(dwconv3×3(GELU(BN1(h))))) of the NHWC map h,
    each op on the view the modules give it (GELU on the NHWC map: the CPU's
    GELU rounds differently on a strided view)."""
    x = gelu(batch_norm_nhwc(h, *norm1, eps[0]))
    x = F.conv2d(x.permute(0, 3, 1, 2), taps.to(x.dtype), None, stride, 1, 1, x.shape[-1])
    return gelu(batch_norm_nhwc(x.permute(0, 2, 3, 1), *norm2, eps[1]))


def _launch_mbconv_dw(h, taps, norm1, norm2, stride: int, eps):
    if h.dim() != 4 or h.shape[-1] % 8:
        raise ValueError(f"mbconv_dw: h must be (B, H, W, C) with C a multiple of 8, "
                         f"got {tuple(h.shape)}")
    b, hh, ww, c = h.shape
    if stride not in (1, 2):
        raise ValueError(f"mbconv_dw: the kernel takes stride 1 or 2, got {stride}")
    if tuple(taps.shape) != (c, 1, 3, 3) or any(tuple(p.shape) != (c,) for p in norm1 + norm2):
        raise ValueError(f"mbconv_dw: taps {tuple(taps.shape)} and BatchNorm vectors "
                         f"{[tuple(p.shape) for p in norm1 + norm2]} do not fit C={c}")
    (h,) = _build.kernel_operands(h, (), "mbconv_dw")
    params = (taps, *norm1, *norm2)
    if any(p.device != h.device for p in params):
        raise ValueError(f"mbconv_dw: parameters not all on {h.device}")
    # the kernel reads them in place where they share float32 or bfloat16
    # (a model cast to its type), else as float32 copies
    kind = taps.dtype if all(p.dtype == taps.dtype for p in params) and \
        taps.dtype in (torch.float32, torch.bfloat16) else torch.float32
    params = [p.to(kind).contiguous() for p in params]
    out = h.new_empty((b, (hh - 1) // stride + 1, (ww - 1) // stride + 1, c))
    err = _build.library().btsbot_mbconv_dw(
        h.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), b, hh, ww, c, stride,
        *eps, int(h.dtype == torch.bfloat16), int(kind == torch.bfloat16),
        _build.current_stream(h))
    _build.check(err, f"mbconv_dw (stride {stride}, {tuple(h.shape)}, {h.dtype})")
    return out


class _MBConvDw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, taps, mean1, var1, weight1, bias1, mean2, var2, weight2, bias2, stride,
                eps):
        ctx.save_for_backward(h, taps, mean1, var1, weight1, bias1, mean2, var2, weight2, bias2)
        ctx.stride, ctx.eps = stride, eps
        return _launch_mbconv_dw(h, taps, (mean1, var1, weight1, bias1),
                                 (mean2, var2, weight2, bias2), stride, eps)

    @staticmethod
    def backward(ctx, grad_out):
        def plain(h, taps, *bn):
            return mbconv_dw_reference(h, bn[:4], taps, bn[4:], ctx.stride, ctx.eps)

        return recompute_backward(plain, ctx.saved_tensors, ctx.needs_input_grad[:10],
                                  grad_out) + (None, None)


def mbconv_dw(h: torch.Tensor, norm1, taps: torch.Tensor, norm2, stride: int,
              eps=(BN_EPS, BN_EPS)) -> torch.Tensor:
    """GELU(BN2(dwconv3×3(GELU(BN1(h))))) of the NHWC map h, eval-mode
    BatchNorms.  CUDA tensors go through the kernel, CPU tensors through
    ``mbconv_dw_reference``."""
    if h.device.type == "cpu":
        return mbconv_dw_reference(h, norm1, taps, norm2, stride, eps)
    return _MBConvDw.apply(h, taps, *norm1, *norm2, stride, eps)
