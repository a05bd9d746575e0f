"""Fused LayerNorm → MLP → layer-scale → residual over (M, C) rows.

Port of btsbot_tpu/ops/pallas_mlp.py.  Three things live here:

* ``ln_mlp_reference`` — the plain PyTorch version (JAX ``_mlp_reference``),
  with the JAX kernel's rounding points: LN statistics in float32, a cast to
  the storage type after the normalisation and after each product, biases,
  γ and the residual added in the storage type;
* ``fused_ln_mlp`` — the wrapper of the CUDA kernels: bfloat16 in
  ``csrc/ln_mlp.cu`` (tuned at C = 64 / 128 / 256 / 512, "wgmma_any" at
  every other width), float32 in ``csrc/tf32x3.cu`` at every width
  ("tf32x3": three TF32 tensor-core products per product;
  ``_build.kernel_variant``, by width and type).  On a CUDA tensor it
  launches one of them or raises; only a CPU tensor takes the plain
  version.  Its backward recomputes the plain version, as the JAX custom
  VJP does (pallas_mlp.py:128-131).  Every ``inceptionnext_*`` block calls it
  (models.convnext.InceptionNeXtBlock), at hidden width ratio·C, and every
  MaxViT attention block's MLP half (models.maxvit.PartitionAttention: γ = 1,
  LN eps 1e-5, an argument of the kernels);
* ``fast_convnext_block`` / ``fast_convnext_backbone`` /
  ``fast_mm_convnext_logits`` — a full eval-mode mm_ConvNeXt forward from a
  reference-named state dict, with the depthwise, stem and downsample
  convolutions outside any kernel and every block's LN → MLP half through
  ``fused_ln_mlp``; its heads (``convnext_head_logits``) also end the int8
  forward of ``ops.quantized``.

Weights keep the layout of ``nn.Linear`` (fc1 (4C, C), fc2 (C, 4C)).
"""

from __future__ import annotations

import functools
from typing import Mapping

import torch
import torch.nn.functional as F

from ..core.config import normalize_config
from ..models.common import gelu
from . import _build
from ._autograd import recompute_backward


def layer_norm_f32(h: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(h - mean) / sqrt(var + eps) over the last axis, in float32."""
    h = h.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = (h - mu).square().mean(dim=-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + eps)


def ln_mlp_reference(h, shortcut, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma,
                     eps: float = 1e-6):
    """Plain version: shortcut + γ·(fc2(GELU(fc1(LN(h))))), h and shortcut
    (M, C); each product is rounded to h's type before its bias; ``eps`` the
    LayerNorm's (1e-6 in the ConvNeXt-family blocks, 1e-5 in MaxViT's)."""
    dtype = h.dtype
    x = layer_norm_f32(h, eps).to(dtype) * ln_w.to(dtype) + ln_b.to(dtype)
    x = gelu(F.linear(x, fc1_w.to(dtype)) + fc1_b.to(dtype))
    x = F.linear(x, fc2_w.to(dtype)) + fc2_b.to(dtype)
    return shortcut + x * gamma.to(dtype)


def _launch_ln_mlp(h, shortcut, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma,
                   eps: float = 1e-6):
    if h.dim() != 2 or shortcut.shape != h.shape:
        raise ValueError(f"fused_ln_mlp: h and shortcut must be one (M, C) shape, "
                         f"got {tuple(h.shape)} and {tuple(shortcut.shape)}")
    m, c = h.shape
    hidden = fc1_w.shape[0]
    if fc1_w.shape != (hidden, c) or fc2_w.shape != (c, hidden):
        raise ValueError(f"fused_ln_mlp: fc1 {tuple(fc1_w.shape)} / fc2 "
                         f"{tuple(fc2_w.shape)} do not fit C={c}")
    ops = _build.kernel_operands(
        h, (shortcut.contiguous(), ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma),
        "fused_ln_mlp")
    variant = _build.kernel_variant(c, hidden, h.dtype)
    out = torch.empty_like(ops[0])
    ws = _build.kernel_workspace(variant, h, m, c, hidden, taps=False)
    launch = getattr(_build.library(), _build.ENTRY_POINTS["ln_mlp"][variant])
    err = launch(*[t.data_ptr() for t in ops], out.data_ptr(), *_build.workspace_args(ws),
                 m, c, hidden, eps, *_build.type_args(variant), _build.current_stream(h))
    _build.check(err, f"fused_ln_mlp ({variant}, C={c}, hidden={hidden})")
    return out


class _FusedLnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, shortcut, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma, eps=1e-6):
        args = (h, shortcut, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma)
        ctx.save_for_backward(*args)
        ctx.eps = eps
        return _launch_ln_mlp(*args, eps)

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_backward(functools.partial(ln_mlp_reference, eps=ctx.eps),
                                   ctx.saved_tensors, ctx.needs_input_grad[:9], grad_out)
        return grads + (None,) * (len(ctx.needs_input_grad) - 9)


def fused_ln_mlp(h, shortcut, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma,
                 eps: float = 1e-6):
    """(M, C) fused LN → MLP → γ + residual.  h: the depthwise conv's output
    (MaxViT: the map itself); shortcut: the block input; ``eps`` the
    LayerNorm's.  CUDA tensors go through the kernel, CPU tensors through
    ``ln_mlp_reference``."""
    args = (h, shortcut, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma)
    if h.device.type == "cpu":
        return ln_mlp_reference(*args, eps=eps)
    return _FusedLnMlp.apply(*args, eps)


# --------------------- fast ConvNeXt forward (serving) ---------------------

def _conv_nhwc(x, weight, bias, stride=1, padding=0, groups=1):
    """Conv2d on an NHWC tensor, product rounded to x's type before the bias
    (the JAX fast path's ``preferred_element_type=f32`` then cast)."""
    dtype = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(dtype), None, stride, padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1) + bias.to(dtype)


def _layernorm(x, weight, bias):
    dtype = x.dtype
    return layer_norm_f32(x).to(dtype) * weight.to(dtype) + bias.to(dtype)


def fast_convnext_block(p: Mapping, prefix: str, x):
    """One block from the state-dict entries under ``prefix``: dwconv
    outside the kernel, then ``fused_ln_mlp``."""
    b, hgt, wid, c = x.shape
    h = _conv_nhwc(x, p[f"{prefix}.conv_dw.weight"], p[f"{prefix}.conv_dw.bias"],
                   padding=3, groups=c)
    out = fused_ln_mlp(
        h.reshape(-1, c), x.reshape(-1, c),
        p[f"{prefix}.norm.weight"], p[f"{prefix}.norm.bias"],
        p[f"{prefix}.mlp.fc1.weight"], p[f"{prefix}.mlp.fc1.bias"],
        p[f"{prefix}.mlp.fc2.weight"], p[f"{prefix}.mlp.fc2.bias"],
        p[f"{prefix}.gamma"])
    return out.reshape(b, hgt, wid, c)


def fast_convnext_backbone(p: Mapping, prefix: str, x, depths):
    """Backbone forward (NHWC) from reference-named state-dict entries."""
    x = _conv_nhwc(x, p[f"{prefix}.stem.0.weight"], p[f"{prefix}.stem.0.bias"],
                   stride=4)
    x = _layernorm(x, p[f"{prefix}.stem.1.weight"], p[f"{prefix}.stem.1.bias"])
    for s, depth in enumerate(depths):
        sp = f"{prefix}.stages.{s}"
        if s > 0:
            x = _layernorm(x, p[f"{sp}.downsample.0.weight"],
                           p[f"{sp}.downsample.0.bias"])
            x = _conv_nhwc(x, p[f"{sp}.downsample.1.weight"],
                           p[f"{sp}.downsample.1.bias"], stride=2)
        for b in range(depth):
            x = fast_convnext_block(p, f"{sp}.blocks.{b}", x)
    return x


def _dense(x, p, prefix):
    dtype = x.dtype
    return F.linear(x, p[f"{prefix}.weight"].to(dtype)) + p[f"{prefix}.bias"].to(dtype)


def fast_mm_convnext_logits(state_dict: Mapping, images, metadata, config):
    """Eval-mode mm_ConvNeXt logits (N,) from a reference-named state dict
    (``MmConvNeXt.state_dict()`` or ``state_dict_from_jax``), computed in
    ``images.dtype`` on ``images.device``."""
    from ..models.convnext import convnext_spec

    config = normalize_config(config)
    dev, dtype = images.device, images.dtype
    p = {k: torch.as_tensor(v, device=dev) for k, v in state_dict.items()}
    spec = convnext_spec(config.get("model_kind", "convnext_nano.d1h_in1k"))

    x = fast_convnext_backbone(p, "convnext_backbone", images, spec["depths"])
    return convnext_head_logits(p, x, metadata, config)


def convnext_head_logits(p: Mapping, x, metadata, config):
    """Logits (N,) of an eval-mode ConvNeXt / mm_ConvNeXt from its final
    backbone map x (N, h, w, C), in x's type, from reference-named state-dict
    tensors ``p``: image-only, pool → LN → fc1 → GELU → fc2 → GELU → out;
    multi-modal, pool → LN ("LS" versions) or a flatten, beside the metadata
    branch, then the combined head."""
    dtype = x.dtype
    if config["model_name"] == "ConvNeXt":
        x = _layernorm(x.mean(dim=(1, 2)), p["convnext.head.1.weight"],
                       p["convnext.head.1.bias"])
        x = gelu(_dense(x, p, "convnext.head.3"))
        x = gelu(_dense(x, p, "convnext.head.5"))
        return _dense(x, p, "convnext.head.8").reshape(-1)
    if "LS" in config.get("train_data_version", ""):
        x = x.mean(dim=(1, 2))
        x = _layernorm(x, p["convnext_backbone.head.1.weight"],
                       p["convnext_backbone.head.1.bias"])
    else:
        x = x.reshape(x.shape[0], -1)

    # metadata branch: BN (running statistics) → fc1 → GELU → fc2 → GELU
    meta = metadata.to(dtype)
    rstd = torch.rsqrt(p["metadata_branch.0.running_var"].float() + 1e-5).to(dtype)
    meta = (meta - p["metadata_branch.0.running_mean"].to(dtype)) * rstd
    meta = meta * p["metadata_branch.0.weight"].to(dtype) \
        + p["metadata_branch.0.bias"].to(dtype)
    meta = gelu(_dense(meta, p, "metadata_branch.1"))
    meta = gelu(_dense(meta, p, "metadata_branch.4"))

    out = torch.cat([x, meta], dim=1)
    out = gelu(_dense(out, p, "combined_head.0"))
    out = gelu(_dense(out, p, "combined_head.2"))
    return _dense(out, p, "combined_head.5").reshape(-1)
