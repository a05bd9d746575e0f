"""One whole ConvNeXt block in one kernel (NHWC).

Port of btsbot_tpu/ops/pallas_convnext.py:

* ``convnext_block_reference`` — the plain PyTorch version (JAX
  ``_block_reference``): depthwise 7×7 SAME conv with float32 accumulation,
  cast to the storage type, + bias; then the LN → MLP → γ → residual chain
  of ``ops.ln_mlp.ln_mlp_reference`` with the block input as shortcut;
* ``convnext_block_fused`` — the wrapper of the CUDA kernels: the tuned
  ``csrc/convnext_block.cu`` at C = 64 / 128 / 256 / 512, and
  ``csrc/any_width.cu`` at every other width (``_build.kernel_variant``).
  On a CUDA tensor it launches one of them (counted in
  ``convnext_block_fused.launches`` and ``.launches_by_width``) or raises;
  only a CPU tensor takes the plain version.  Its backward recomputes the plain
  version (pallas_convnext.py:187-190);
* ``block_params_apply`` — the block from reference-named parameters.

The kernel adds the depthwise bias in float32 before the LayerNorm, as the
TPU kernel does (pallas_convnext.py:87); the plain version rounds the conv
output to the storage type first (:57).  The two agree exactly in float32
and differ by bf16 rounding in bfloat16.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from . import _build
from ._autograd import recompute_backward
from .ln_mlp import ln_mlp_reference


def depthwise_conv7_reference(x, dw_w, dw_b):
    """Depthwise 7×7 SAME conv on NHWC with float32 accumulation, rounded to
    x's type, + bias in x's type."""
    dtype = x.dtype
    c = x.shape[-1]
    h = F.conv2d(x.permute(0, 3, 1, 2).float(), dw_w.float(), None, 1, 3, groups=c)
    return h.permute(0, 2, 3, 1).to(dtype) + dw_b.to(dtype)


def convnext_block_reference(x, dw_w, dw_b, ln_w, ln_b, fc1_w, fc1_b, fc2_w,
                             fc2_b, gamma):
    """Plain version of the block; x (B, H, W, C), dw_w (C, 1, 7, 7)."""
    c = x.shape[-1]
    h = depthwise_conv7_reference(x, dw_w, dw_b)
    out = ln_mlp_reference(h.reshape(-1, c), x.reshape(-1, c), ln_w, ln_b,
                           fc1_w, fc1_b, fc2_w, fc2_b, gamma)
    return out.reshape(x.shape)


def _launch_block(x, dw_w, dw_b, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma):
    if x.dim() != 4:
        raise ValueError(f"convnext_block_fused: x must be (B, H, W, C), "
                         f"got {tuple(x.shape)}")
    b, hgt, wid, c = x.shape
    hidden = fc1_w.shape[0]
    if dw_w.shape != (c, 1, 7, 7):
        raise ValueError(f"convnext_block_fused: the kernel takes a (C, 1, 7, 7) "
                         f"depthwise weight, got {tuple(dw_w.shape)}")
    if fc1_w.shape != (hidden, c) or fc2_w.shape != (c, hidden):
        raise ValueError(f"convnext_block_fused: fc1 {tuple(fc1_w.shape)} / fc2 "
                         f"{tuple(fc2_w.shape)} do not fit C={c}")
    variant = _build.kernel_variant(c, hidden)
    ops = _build.kernel_operands(
        x, (dw_w, dw_b, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma),
        "convnext_block_fused")
    out = torch.empty_like(ops[0])
    launch = getattr(_build.library(),
                     _build.ENTRY_POINTS["convnext_block"][variant])
    err = launch(*[t.data_ptr() for t in ops], out.data_ptr(), b, hgt, wid, c,
                 hidden, _build.KERNEL_DTYPES[x.dtype], _build.current_stream(x))
    _build.check(err, f"convnext_block_fused ({variant}, C={c})")
    _build.count_launch(convnext_block_fused, c, hidden)
    return out


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch_block(*args)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_backward(convnext_block_reference, ctx.saved_tensors,
                                  ctx.needs_input_grad, grad_out)


def convnext_block_fused(x, dw_w, dw_b, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b,
                         gamma):
    """The whole block on NHWC x.  CUDA tensors go through the kernel, CPU
    tensors through ``convnext_block_reference``."""
    args = (x, dw_w, dw_b, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma)
    if x.device.type == "cpu":
        return convnext_block_reference(*args)
    return _FusedBlock.apply(*args)


convnext_block_fused.launches = 0
convnext_block_fused.launches_by_width = {}  # (C, hidden) -> launches

BLOCK_PARAM_NAMES = ("conv_dw.weight", "conv_dw.bias", "norm.weight", "norm.bias",
                     "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
                     "mlp.fc2.bias", "gamma")


def block_params_apply(params: Mapping, x):
    """The fused block from one block's reference-named parameters
    (``ConvNeXtBlock.state_dict()``)."""
    return convnext_block_fused(x, *[params[k] for k in BLOCK_PARAM_NAMES])
