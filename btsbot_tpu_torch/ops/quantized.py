"""int8 quantized serving path for the ConvNeXt family (port of
btsbot_tpu/ops/quantized.py).

A post-training-quantized eval forward for mm_ConvNeXt / ConvNeXt from a
reference-named state dict (``MmConvNeXt.state_dict()`` or
``interop.weights.state_dict_from_jax``), with the JAX package's arithmetic:

* weights: symmetric per-output-channel int8 (``quantize_weight``: the
  stem, downsample and depthwise convs, the block MLPs' fc1 / fc2);
* activations: symmetric per-tensor int8 with static scales, absmax / 127
  recorded by ``prepare_quantized`` on a calibration batch through an f32
  simulation of the quantized forward (``_calibrate``) at the stem input,
  each downsample's input (``s{s}_down``) and each block's input, LN output
  and GELU output (``s{s}b{b}_x`` / ``_h`` / ``_g``);
* products in int8 with exact int32 sums; dequantize, bias, LayerNorm,
  GELU (the tanh form in every block, calibration included), layer scale
  and residual in ``dtype`` (bfloat16 by default); the metadata branch and
  the heads in ``dtype`` as the fast forward computes them
  (``ops.ln_mlp.convnext_head_logits``).

On the card each ConvNeXt block is one launch of the hand-written kernel
``csrc/int8_block.cu`` (``int8_block``: the block input quantized, the 49
taps summed exactly, dequantize + bias, LayerNorm, q_h, fc1 on the int8
tensor cores, GELU, q_g, fc2, γ and the residual); the stem (4×4 stride 4)
and the downsamples (2×2 stride 2) are patchify GEMMs through
``torch._int_mm`` (int8 × int8 → int32, as the JAX package leaves those
products to XLA) with their quantize and dequantize passes.  Calibration
keeps the unfused steps, since it needs each float intermediate's absmax:
there the depthwise step is ``csrc/int8_dwconv.cu`` (``int8_dwconv``).  On
the CPU the same functions run their plain versions
(``int8_block_reference`` is the composition the forward computed before
the fused kernel).  The quantize passes divide by the scale as a tensor on
the data's device: a CUDA division by a Python number is a multiply by its
reciprocal, which rounds differently from the JAX package's IEEE division.

The scales are Python floats taken from float32 values, multiplied as
float32.  Quantized weights are kept in the forward's layouts: the stem's
and each downsample's as (O, kh·kw·Cin) rows in (kh, kw, Cin) order, the
depthwise taps as (7, 7, C), fc1 / fc2 as ``nn.Linear`` weights (out, in);
``qparams_from_jax`` carries the JAX package's qparams (HWIO and (in, out)
numpy arrays) into them.  The int8 path is not wired into the scorers, the
daemon or a CLI, in the JAX package either.
"""

from __future__ import annotations

import weakref
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import normalize_config
from ..core.device import resolve_device
from . import _build
from .ln_mlp import _layernorm, convnext_head_logits, layer_norm_f32

DEFAULT_KIND = "convnext_nano.d1h_in1k"
TAPS = 7


def _div(x: torch.Tensor, scale) -> torch.Tensor:
    """x / scale in float32 as an IEEE division, ``scale`` a Python number or
    a 0-d tensor, taken as a tensor on x's device."""
    return x.float() / torch.as_tensor(scale, dtype=torch.float32, device=x.device)


def _absmax(x: torch.Tensor, dim=None) -> torch.Tensor:
    return x.abs().amax() if dim is None else x.abs().amax(dim=dim)


def quantize_weight(w: torch.Tensor, contract_axes) -> tuple:
    """Symmetric per-output-channel int8: scales over all non-output axes.
    Returns (w_int8, scale[out]); the output axis is the LAST axis."""
    scale = torch.clamp(_div(_absmax(w, tuple(contract_axes)), 127.0), min=1e-12)
    wq = torch.clamp(torch.round(w.float() / scale), -127, 127).to(torch.int8)
    return wq, scale


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """clip(round_half_even(float32(x) / scale), -127, 127) as int8."""
    return torch.clamp(torch.round(_div(x, scale)), -127, 127).to(torch.int8)


# ----------------------------- depthwise 7x7 -----------------------------

def int8_dwconv_accumulate(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain int32 sums of the depthwise 7×7 SAME conv of int8 xq (B, H, W,
    C) with int8 taps wq (7, 7, C): a float32 conv over the integer values,
    exact because |sum| ≤ 49·127² < 2^24."""
    c = xq.shape[-1]
    w = wq.permute(2, 0, 1).unsqueeze(1).float()  # (C, 1, 7, 7)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).float(), w, None, 1, TAPS // 2, groups=c)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def int8_dwconv_reference(x, s_x, wq, w_scale, bias):
    """Plain version of the whole depthwise step in x's type: x quantized
    with ``s_x``, the exact int32 sums, then
    ``dtype(float(acc) · (s_x · w_scale)) + dtype(bias)``."""
    dtype = x.dtype
    acc = int8_dwconv_accumulate(quantize_act(x, s_x), wq)
    scale = torch.as_tensor(s_x, dtype=torch.float32, device=x.device) * w_scale
    return (acc.float() * scale).to(dtype) + bias.to(dtype)


def _launch_int8_dwconv(x, s_x: float, wq, w_scale, bias):
    name = "int8_dwconv"
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _build.KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if tuple(wq.shape) != (TAPS, TAPS, c) or wq.dtype != torch.int8 \
            or tuple(w_scale.shape) != (c,) or w_scale.dtype != torch.float32 \
            or tuple(bias.shape) != (c,):
        raise ValueError(f"{name}: taps {tuple(wq.shape)} {wq.dtype}, scales "
                         f"{tuple(w_scale.shape)} {w_scale.dtype}, bias "
                         f"{tuple(bias.shape)} do not fit C = {c}")
    for t in (wq, w_scale, bias):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is not contiguous")
    x = x.contiguous()
    bias = bias.to(x.dtype)
    out = torch.empty_like(x)
    err = _build.library().btsbot_int8_dwconv(
        x.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        float(s_x), b, h, w, c, int(x.dtype == torch.bfloat16), _build.current_stream(x))
    _build.check(err, "btsbot_int8_dwconv")
    return out


def int8_dwconv(x, s_x, wq, w_scale, bias):
    """The quantized block's depthwise step (JAX quantized.py:199-203) on x
    (B, H, W, C) in float32 or bfloat16, output in x's type: the CUDA kernel
    on a CUDA tensor, its plain version on a CPU tensor.  The calibration's; the forward runs the
    whole block in ``int8_block``."""
    if x.is_cuda:
        return _launch_int8_dwconv(x, float(s_x), wq, w_scale, bias)
    return int8_dwconv_reference(x, s_x, wq, w_scale, bias)


# ------------------------------- int8 GEMMs -------------------------------

def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 times w (N, K) int8 transposed: (M, N) exact int32 sums
    (``torch._int_mm``).  On the card cuBLASLt wants more than 16 rows and
    K, N multiples of 8; a smaller M is padded with zero rows, then cut (on
    both devices, so the host's tests run the same path)."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a.contiguous(), w.t())[:m]


def _patch_conv(xq: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """VALID conv with kernel = stride = k of int8 xq (B, H, W, C) by the
    (O, k·k·C) rows w: int32 (B, H', W', O) through ``int8_matmul``."""
    b, h, wd, c = xq.shape
    ho, wo = (h - k) // k + 1, (wd - k) // k + 1
    p = xq[:, :ho * k, :wo * k].reshape(b, ho, k, wo, k, c).permute(0, 1, 3, 2, 4, 5)
    return int8_matmul(p.reshape(b * ho * wo, k * k * c), w).reshape(b, ho, wo, -1)


def _dequant(acc, scale, w_scale, bias, dtype):
    """dtype(float(acc) · (scale · w_scale)) + dtype(bias); int32 times the
    float32 scales promotes to float32 in the product itself."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=acc.device) * w_scale
    return (acc * s).to(dtype) + bias.to(dtype)


def _int8_dense(h, scale, weight, bias, dtype):
    """h (M, K) quantized with ``scale``, times the (int8 (N, K), scales)
    ``weight``, dequantized and biased in ``dtype``."""
    wq, ws = weight
    return _dequant(int8_matmul(quantize_act(h, scale), wq), scale, ws, bias, dtype)


def _int8_patch_conv(x, scale, weight, bias, k, dtype):
    """The stem (k = 4) or a downsample (k = 2) of x (B, H, W, C) in int8,
    dequantized and biased in ``dtype``."""
    wq, ws = weight
    return _dequant(_patch_conv(quantize_act(x, scale), wq, k), scale, ws, bias, dtype)


def _act_scale(x):
    """absmax(x) / 127 in float32, a 0-d tensor."""
    return _div(_absmax(x), 127.0)


# -------------------------- the block, fused --------------------------

def int8_block_reference(x, s_x, s_h, s_g, dw, dw_b, ln_w, ln_b, fc1, b1, fc2, b2, gamma,
                         debug=False, q_h=None, q_g=None):
    """Plain version of one quantized block (JAX quantized.py:194-218) on x
    (B, H, W, C), in x's type: the composition the forward ran before the
    fused kernel, the depthwise step (``int8_dwconv_reference``), the
    LayerNorm, q_h, fc1 in int8 dequantized and biased, tanh GELU, q_g, fc2
    likewise, then x + γ · that.  ``quantize_act`` is called for x, h and g
    in that order.  ``dw``, ``fc1``, ``fc2``: (int8 weight in the forward's
    layout, float32 scales).  A given ``q_h`` (M, C) or ``q_g`` (M, hidden)
    int8 replaces the block's own and skips the steps before it (the tail
    from there).  With ``debug``: (out, q_h, q_g)."""
    dtype = x.dtype
    if q_g is None:
        if q_h is None:
            h = int8_dwconv_reference(x, s_x, *dw, dw_b)
            h = _layernorm(h, ln_w, ln_b).reshape(-1, x.shape[-1])
            q_h = quantize_act(h, s_h)
        g = F.gelu(_dequant(int8_matmul(q_h, fc1[0]), s_h, fc1[1], b1, dtype),
                   approximate="tanh")
        q_g = quantize_act(g, s_g)
    y = _dequant(int8_matmul(q_g, fc2[0]), s_g, fc2[1], b2, dtype)
    out = x + y.reshape(x.shape) * gamma.to(dtype)
    return (out, q_h, q_g) if debug else out


# derived device copies, by (id(source), tag): a weak reference to the
# source, its version counter when made, the copy
_DERIVED: dict = {}


def _tensor_version(t) -> int:
    try:
        return t._version
    except RuntimeError:  # an inference tensor keeps no version counter
        return -1


def _derived(t: torch.Tensor, tag, make):
    """``make(t)``, made once for the tensor ``t`` and kept while ``t``
    lives unchanged (so once per qparams, never per launch)."""
    key = (id(t), tag)
    hit = _DERIVED.get(key)
    if hit is not None and hit[0]() is t and hit[1] == _tensor_version(t):
        return hit[2]
    value = make(t)
    _DERIVED[key] = (weakref.ref(t, lambda _, key=key: _DERIVED.pop(key, None)),
                     _tensor_version(t), value)
    return value


def _rows16(w: torch.Tensor) -> torch.Tensor:
    """w (N, K) int8 with its rows padded with zeros to a multiple of 16
    bytes, the row stride TMA takes."""
    return F.pad(w, (0, -w.shape[1] % 16)).contiguous()


def _launch_int8_block(x, s_x: float, s_h: float, s_g: float, dw, dw_b, ln_w, ln_b, fc1, b1,
                       fc2, b2, gamma, debug=False):
    name = "int8_block"
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _build.KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    (dw_q, dw_s), (w1, w1_s), (w2, w2_s) = dw, fc1, fc2
    hidden = w1.shape[0]
    _build.int8_block_admit(c, hidden)
    want = {"taps": (dw_q, (TAPS, TAPS, c), torch.int8), "tap scales": (dw_s, (c,), torch.float32),
            "fc1": (w1, (hidden, c), torch.int8), "fc1 scales": (w1_s, (hidden,), torch.float32),
            "fc2": (w2, (c, hidden), torch.int8), "fc2 scales": (w2_s, (c,), torch.float32),
            "dw bias": (dw_b, (c,), None), "LN scale": (ln_w, (c,), None),
            "LN shift": (ln_b, (c,), None), "fc1 bias": (b1, (hidden,), None),
            "fc2 bias": (b2, (c,), None), "gamma": (gamma, (c,), None)}
    for what, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or (dtype is not None and t.dtype != dtype):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} {t.dtype} does not fit "
                             f"C = {c}, hidden = {hidden}")
    for t in [x] + [t for t, _, _ in want.values()]:
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is not contiguous")
    lib = _build.library()
    if lib.btsbot_int8_block_smem(c, h, w) == 0:
        raise ValueError(f"{name}: a {h}x{w} map at C = {c} does not fit a block's shared "
                         f"memory")
    if c % 16:
        w1 = _derived(w1, "rows16", _rows16)
    dw_b, ln_w, ln_b, b1, b2, gamma = (
        t if t.dtype == x.dtype else _derived(t, x.dtype, lambda t: t.to(x.dtype))
        for t in (dw_b, ln_w, ln_b, b1, b2, gamma))
    out = torch.empty_like(x)
    q_h = torch.empty((b * h * w, c), dtype=torch.int8, device=x.device) if debug else None
    q_g = torch.empty((b * h * w, hidden), dtype=torch.int8, device=x.device) if debug else None
    err = lib.btsbot_int8_block(
        *(t.data_ptr() for t in (x, dw_q, dw_s, dw_b, ln_w, ln_b, w1, w1_s, b1, w2, w2_s, b2,
                                 gamma, out)),
        None if q_h is None else q_h.data_ptr(), None if q_g is None else q_g.data_ptr(),
        float(s_x), float(s_h), float(s_g), b, h, w, c, hidden, w1.shape[1],
        int(x.dtype == torch.bfloat16), _build.current_stream(x))
    _build.check(err, "btsbot_int8_block")
    return (out, q_h, q_g) if debug else out


def int8_block(x, s_x, s_h, s_g, dw, dw_b, ln_w, ln_b, fc1, b1, fc2, b2, gamma, debug=False):
    """One quantized ConvNeXt block (JAX quantized.py:194-218) on x (B, H, W,
    C) in float32 or bfloat16, output in x's type: the CUDA kernel
    ``csrc/int8_block.cu`` on a CUDA tensor, ``int8_block_reference`` on a
    CPU tensor.  ``s_x``,
    ``s_h``, ``s_g``: the block's activation scales as Python floats;
    ``dw``, ``fc1``, ``fc2``: (int8 weight in the forward's layout, float32
    scales).  With ``debug``: (out, q_h (M, C), q_g (M, hidden))."""
    if x.is_cuda:
        return _launch_int8_block(x, s_x, s_h, s_g, dw, dw_b, ln_w, ln_b, fc1, b1, fc2, b2,
                                  gamma, debug=debug)
    return int8_block_reference(x, s_x, s_h, s_g, dw, dw_b, ln_w, ln_b, fc1, b1, fc2, b2, gamma,
                                debug=debug)


# ------------------------------ calibration ------------------------------

def forward_layout(name: str, wq):
    """A quantized weight from the JAX package's layout (HWIO convs, (in,
    out) dense kernels) to the forward's (module docstring)."""
    if name.endswith("_dw"):
        return wq.reshape(wq.shape[0], wq.shape[1], -1).contiguous()
    if name.endswith(("_fc1", "_fc2")):
        return wq.t().contiguous()
    return wq.reshape(-1, wq.shape[-1]).t().contiguous()


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """A torch conv weight (O, I, kh, kw) as the JAX package's HWIO kernel."""
    return w.permute(2, 3, 1, 0)


def _backbone_prefix(config) -> str:
    return "convnext" if config["model_name"] == "ConvNeXt" else "convnext_backbone"


def _ln_f32(x, p, prefix):
    """Calibration's LayerNorm (JAX quantized.py:58): all in float32."""
    return layer_norm_f32(x) * p[f"{prefix}.weight"].float() + p[f"{prefix}.bias"].float()


def _calibrate(p: Mapping, prefix: str, images: torch.Tensor, depths) -> tuple:
    """Quantize the weights and simulate the quantized forward in float32 on
    the calibration batch, recording per-tensor activation scales.  Returns
    (scales of 0-d float32 tensors, weights of (int8 in the forward's
    layout, float32 scale))."""
    x = images.float()
    f32 = torch.float32
    scales: dict = {}
    weights: dict = {}

    def qw(name, w, contract_axes):
        wq, ws = quantize_weight(w.float(), contract_axes)
        weights[name] = (forward_layout(name, wq), ws)

    scales["stem_in"] = _act_scale(x)
    qw("stem", _hwio(p[f"{prefix}.stem.0.weight"]), (0, 1, 2))
    x = _int8_patch_conv(x, scales["stem_in"], weights["stem"], p[f"{prefix}.stem.0.bias"],
                         4, f32)
    x = _ln_f32(x, p, f"{prefix}.stem.1")

    for s, depth in enumerate(depths):
        sp = f"{prefix}.stages.{s}"
        if s > 0:
            x = _ln_f32(x, p, f"{sp}.downsample.0")
            key = f"s{s}_down"
            scales[key] = _act_scale(x)
            qw(key, _hwio(p[f"{sp}.downsample.1.weight"]), (0, 1, 2))
            x = _int8_patch_conv(x, scales[key], weights[key], p[f"{sp}.downsample.1.bias"],
                                 2, f32)
        for b in range(depth):
            bp, pre = f"{sp}.blocks.{b}", f"s{s}b{b}"
            c = x.shape[-1]
            scales[pre + "_x"] = _act_scale(x)
            qw(pre + "_dw", _hwio(p[f"{bp}.conv_dw.weight"]), (0, 1, 2))
            h = int8_dwconv(x, float(scales[pre + "_x"]), *weights[pre + "_dw"],
                            p[f"{bp}.conv_dw.bias"].float())
            h = _ln_f32(h, p, f"{bp}.norm").reshape(-1, c)
            scales[pre + "_h"] = _act_scale(h)
            qw(pre + "_fc1", p[f"{bp}.mlp.fc1.weight"].t(), (0,))
            h = F.gelu(_int8_dense(h, scales[pre + "_h"], weights[pre + "_fc1"],
                                   p[f"{bp}.mlp.fc1.bias"], f32), approximate="tanh")
            scales[pre + "_g"] = _act_scale(h)
            qw(pre + "_fc2", p[f"{bp}.mlp.fc2.weight"].t(), (0,))
            h = _int8_dense(h, scales[pre + "_g"], weights[pre + "_fc2"],
                            p[f"{bp}.mlp.fc2.bias"], f32)
            x = x + h.reshape(x.shape) * p[f"{bp}.gamma"].float()
    return scales, weights


def _depths(config) -> tuple:
    from ..models.convnext import convnext_spec

    spec = convnext_spec(config.get("model_kind") or DEFAULT_KIND)
    if spec.get("token_mixer", "dwconv7") != "dwconv7":
        raise ValueError("the int8 path takes ConvNeXt blocks (a 7x7 depthwise conv), "
                         f"not {config.get('model_kind')}")
    return tuple(spec["depths"])


def _input_device(images, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if isinstance(images, torch.Tensor):
        return images.device
    return resolve_device(None)


def _on(state_dict: Mapping, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in state_dict.items()}


def prepare_quantized(state_dict: Mapping, config, images, metadata=None,
                      device=None) -> dict:
    """Calibrate and quantize.  ``images``: a representative calibration
    batch of preprocessed triplets (N, 63, 63, 3).  Runs on ``device``, else
    on the images' device if they are a tensor, else on the card.  Returns
    the qparams ``quantized_convnext_logits`` takes."""
    config = normalize_config(config)
    dev = _input_device(images, device)
    depths = _depths(config)
    p = _on(state_dict, dev)
    with torch.no_grad():
        scales, weights = _calibrate(p, _backbone_prefix(config),
                                     torch.as_tensor(images, device=dev), depths)
        scales = {k: float(v) for k, v in scales.items()}
    return {"depths": depths, "scales": scales, "weights": weights, "state_dict": p,
            "config": config, "device": dev}


def qparams_from_jax(jax_qparams: Mapping, state_dict: Mapping, device=None) -> dict:
    """The JAX package's ``prepare_quantized`` result as the port's qparams:
    its scales and int8 weights (numpy, or anything ``np.asarray`` reads),
    each weight in the forward's layout, beside ``state_dict`` (the same
    model's reference-named weights, e.g. ``state_dict_from_jax``).  Runs on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    weights = {name: (forward_layout(name, torch.as_tensor(np.array(wq), device=dev)),
                      torch.as_tensor(np.array(ws), dtype=torch.float32, device=dev))
               for name, (wq, ws) in jax_qparams["weights"].items()}
    config = normalize_config(dict(jax_qparams["config"]))
    return {"depths": tuple(jax_qparams["depths"]),
            "scales": {k: float(v) for k, v in jax_qparams["scales"].items()},
            "weights": weights, "state_dict": _on(state_dict, dev), "config": config,
            "device": dev}


# -------------------------------- forward --------------------------------

def quantized_convnext_logits(qparams: Mapping, images, metadata=None,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """int8 eval forward for mm_ConvNeXt / ConvNeXt with calibrated qparams;
    logits (N,) in ``dtype``, on the qparams' device.  Elementwise math in
    ``dtype`` (bfloat16 default)."""
    config, dev = qparams["config"], qparams["device"]
    p, scales, weights = qparams["state_dict"], qparams["scales"], qparams["weights"]
    prefix = _backbone_prefix(config)

    with torch.inference_mode():
        # every scale on the device in one copy, as 0-d views
        names = list(scales)
        st = torch.tensor([scales[k] for k in names], dtype=torch.float32, device=dev)
        sc = {k: st[i] for i, k in enumerate(names)}
        x = torch.as_tensor(images, device=dev).to(dtype)
        x = _int8_patch_conv(x, sc["stem_in"], weights["stem"], p[f"{prefix}.stem.0.bias"], 4,
                             dtype)
        x = _layernorm(x, p[f"{prefix}.stem.1.weight"], p[f"{prefix}.stem.1.bias"])
        for s, depth in enumerate(qparams["depths"]):
            sp = f"{prefix}.stages.{s}"
            if s > 0:
                x = _layernorm(x, p[f"{sp}.downsample.0.weight"], p[f"{sp}.downsample.0.bias"])
                key = f"s{s}_down"
                x = _int8_patch_conv(x, sc[key], weights[key], p[f"{sp}.downsample.1.bias"], 2,
                                     dtype)
            for b in range(depth):
                bp, pre = f"{sp}.blocks.{b}", f"s{s}b{b}"
                x = int8_block(x, scales[pre + "_x"], scales[pre + "_h"], scales[pre + "_g"],
                               weights[pre + "_dw"], p[f"{bp}.conv_dw.bias"],
                               p[f"{bp}.norm.weight"], p[f"{bp}.norm.bias"],
                               weights[pre + "_fc1"], p[f"{bp}.mlp.fc1.bias"],
                               weights[pre + "_fc2"], p[f"{bp}.mlp.fc2.bias"],
                               p[f"{bp}.gamma"])
        meta = None if metadata is None else torch.as_tensor(metadata, device=dev)
        return convnext_head_logits(p, x, meta, config)


def verify_quantized_parity(qparams: Mapping, images, metadata=None,
                            tol: float = 0.015) -> dict:
    """Compare int8 scores with the port's bfloat16 model on the same
    weights and data: {"close": max |Δscore| ≤ tol, "max_score_diff"}."""
    from ..models.factory import build_model

    config, dev = qparams["config"], qparams["device"]
    model = build_model(config, dtype=torch.float32, device=dev)
    model.load_state_dict(qparams["state_dict"])
    images = torch.as_tensor(images, device=dev)
    with torch.inference_mode():
        ref_logits = model(images.to(torch.bfloat16),
                           None if metadata is None
                           else torch.as_tensor(metadata, device=dev).to(torch.bfloat16))
        ref = torch.sigmoid(ref_logits.reshape(-1).float())
        qs = torch.sigmoid(quantized_convnext_logits(qparams, images, metadata).float())
        max_diff = float((ref - qs).abs().max())
    return {"close": max_diff <= tol, "max_score_diff": max_diff}
