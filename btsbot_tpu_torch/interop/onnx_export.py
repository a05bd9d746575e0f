"""Direct ONNX emission for every BTSbot model family, from the port's own
weights (port of btsbot_tpu.interop.onnx_export; no ``onnx`` dependency).

The reference deploys to brokers as ONNX graphs with dynamic batch axes,
inputs ``image`` (NCHW) / ``metadata`` and output ``logits`` (its
``to_onnx.py``).  This module emits the same contract from a port model's
``state_dict()``, which already carries the reference's names: each family's
inference graph spelled out in ONNX ops (opset 17) around those weights,
including the in-graph bilinear resize of MaxViT (half_pixel, torch's
``align_corners=False``), both mm_ConvNeXt heads (pool + LayerNorm when
"LS" is in ``train_data_version``, else a flatten) and frozen_fusion.  The
graph builder is the JAX package's, unchanged, so the same weights give the
same bytes.

``verify_onnx`` (the analog of the reference's ``verify_pth_vs_onnx``) runs
the emitted graph through the in-repo numpy evaluator (``onnx_numpy``; and
onnxruntime too, when installed) against the port's own float32 eval
forward on the given device (the card by default: the ConvNeXt blocks in
``convnext_block_fused``, InceptionNeXt's in ``fused_ln_mlp``), at rtol 1e-4
/ atol 1e-5, with TF32 off for matmuls and cuDNN for the comparison (cuDNN's
TF32 is on by default and would use up the atol).

Conventions baked into the graphs:
* image input is NCHW float32 like the reference's ONNX artifacts;
* Dropout is inference-elided; BatchNorm uses running stats;
* GELU is decomposed exactly (x·0.5·(1+erf(x/√2))).
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from ..core.config import Config, normalize_config
from ..core.device import resolve_device
from ..models.convnext import convnext_spec
from ..models.factory import build_model
from ..models.fusion import resolve_fusion_config
from ..models.maxvit import _rel_position_index, get_model_image_size, maxvit_spec
from .onnx_proto import F32, Graph, Node, Tensor, encode_model

SQRT2 = float(np.sqrt(2.0))


class OnnxBuilder:
    """Tiny functional graph builder over onnx_proto."""

    def __init__(self, name: str):
        self.g = Graph(name)
        self._n = 0

    def _fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def input(self, name: str, shape) -> str:
        self.g.inputs.append((name, shape, F32))
        return name

    def output(self, name: str, shape) -> None:
        self.g.outputs.append((name, shape, F32))

    def init(self, array, hint: str = "w") -> str:
        name = self._fresh(hint)
        self.g.initializers.append(
            Tensor(name, np.ascontiguousarray(array)))
        return name

    def n(self, op: str, inputs: list[str], hint: str | None = None,
          **attrs) -> str:
        out = self._fresh(hint or op.lower())
        self.g.nodes.append(Node(op, list(inputs), [out], attrs))
        return out

    def const_f32(self, value, hint: str = "c") -> str:
        return self.init(np.asarray(value, np.float32), hint)

    def model_bytes(self, opset: int = 17) -> bytes:
        return encode_model(self.g, opset=opset)

    # ---------------- layer helpers over a torch state dict ----------------

    def gemm(self, x: str, sd, prefix: str) -> str:
        w = self.init(np.asarray(sd[f"{prefix}.weight"], np.float32),
                      f"{prefix}.weight")
        bias = self.init(np.asarray(sd[f"{prefix}.bias"], np.float32),
                         f"{prefix}.bias")
        return self.n("Gemm", [x, w, bias], transB=1)

    def matmul_bias(self, x: str, w_oi: np.ndarray, bias: np.ndarray,
                    hint: str = "mm") -> str:
        """Rank-N x · Wᵀ + b (for token tensors where Gemm needs rank 2)."""
        w = self.init(np.ascontiguousarray(np.asarray(w_oi, np.float32).T),
                      hint)
        y = self.n("MatMul", [x, w])
        return self.n("Add", [y, self.init(np.asarray(bias, np.float32),
                                           f"{hint}.bias")])

    def conv(self, x: str, sd, prefix: str, strides=(1, 1), pads=(0, 0),
             group: int = 1) -> str:
        w = np.asarray(sd[f"{prefix}.weight"], np.float32)
        inputs = [x, self.init(w, f"{prefix}.weight")]
        if f"{prefix}.bias" in sd:
            inputs.append(self.init(
                np.asarray(sd[f"{prefix}.bias"], np.float32),
                f"{prefix}.bias"))
        return self.n(
            "Conv", inputs, kernel_shape=list(w.shape[2:]),
            strides=list(strides),
            pads=[pads[0], pads[1], pads[0], pads[1]], group=group)

    def bn(self, x: str, sd, prefix: str, eps: float = 1e-5) -> str:
        args = [x] + [
            self.init(np.asarray(sd[f"{prefix}.{k}"], np.float32),
                      f"{prefix}.{k}")
            for k in ("weight", "bias", "running_mean", "running_var")]
        return self.n("BatchNormalization", args, epsilon=eps)

    def layernorm(self, x: str, sd, prefix: str, eps: float) -> str:
        scale = self.init(np.asarray(sd[f"{prefix}.weight"], np.float32),
                          f"{prefix}.weight")
        bias = self.init(np.asarray(sd[f"{prefix}.bias"], np.float32),
                         f"{prefix}.bias")
        return self.n("LayerNormalization", [x, scale, bias], axis=-1,
                      epsilon=eps)

    def gelu(self, x: str) -> str:
        scaled = self.n("Div", [x, self.const_f32(SQRT2)])
        erf = self.n("Erf", [scaled])
        one = self.n("Add", [erf, self.const_f32(1.0)])
        half = self.n("Mul", [x, one])
        return self.n("Mul", [half, self.const_f32(0.5)])

    def act(self, x: str, kind: str) -> str:
        return self.n("Relu", [x]) if kind == "relu" else self.gelu(x)

    def reshape(self, x: str, shape, hint: str = "reshape") -> str:
        return self.n("Reshape",
                      [x, self.init(np.asarray(shape, np.int64), "shape")],
                      hint)

    def transpose(self, x: str, perm, hint: str = "transpose") -> str:
        return self.n("Transpose", [x], hint, perm=list(perm))


# --------------------------- shared sub-graphs ---------------------------

def _metadata_branch(b: OnnxBuilder, x: str, sd, prefix: str,
                     activation: str) -> str:
    """BatchNorm1d → Linear → act → (Dropout) → Linear → act
    (reference architectures.py:68-75, 283-291)."""
    x = b.bn(x, sd, f"{prefix}.0", eps=1e-5)
    x = b.act(b.gemm(x, sd, f"{prefix}.1"), activation)
    return b.act(b.gemm(x, sd, f"{prefix}.4"), activation)


def _mlp_head(b: OnnxBuilder, x: str, sd, keys: tuple[str, str, str],
              activation: str) -> str:
    """Linear → act → Linear → act → (Dropout) → Linear(1)."""
    x = b.act(b.gemm(x, sd, keys[0]), activation)
    x = b.act(b.gemm(x, sd, keys[1]), activation)
    return b.gemm(x, sd, keys[2])


def _cnn_backbone(b: OnnxBuilder, x: str, sd, config, prefix: str = "") -> str:
    """VGG-style 2-block CNN → NCHW flatten (architectures.py:180-202)."""
    k = int(config["conv_kernel"])
    p = (k - 1) // 2  # torch padding='same' for odd kernels
    pre = f"{prefix}conv_layers"
    x = b.n("Relu", [b.conv(x, sd, f"{pre}.0", pads=(p, p))])
    x = b.n("Relu", [b.conv(x, sd, f"{pre}.2", pads=(p, p))])
    x = b.n("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = b.n("Relu", [b.conv(x, sd, f"{pre}.6", pads=(p, p))])
    x = b.n("Relu", [b.conv(x, sd, f"{pre}.8", pads=(p, p))])
    x = b.n("MaxPool", [x], kernel_shape=[4, 4], strides=[4, 4])
    return b.n("Flatten", [x], axis=1)


def _channel_slice(b: OnnxBuilder, x: str, start: int, end: int) -> str:
    return b.n("Slice", [
        x, b.init(np.asarray([start], np.int64), "starts"),
        b.init(np.asarray([end], np.int64), "ends"),
        b.init(np.asarray([1], np.int64), "axes")])


def _inception_mixer(b: OnnxBuilder, x: str, sd, bp: str, dim: int) -> str:
    g = max(1, dim // 8)
    band = np.asarray(sd[f"{bp}.mixer.dw_band_w.weight"]).shape[-1]
    pad = (band - 1) // 2
    y0 = b.conv(_channel_slice(b, x, 0, g), sd, f"{bp}.mixer.dw_square",
                pads=(1, 1), group=g)
    y1 = b.conv(_channel_slice(b, x, g, 2 * g), sd, f"{bp}.mixer.dw_band_w",
                pads=(0, pad), group=g)
    y2 = b.conv(_channel_slice(b, x, 2 * g, 3 * g), sd,
                f"{bp}.mixer.dw_band_h", pads=(pad, 0), group=g)
    rest = _channel_slice(b, x, 3 * g, dim)
    return b.n("Concat", [y0, y1, y2, rest], axis=1)


def _convnext_backbone(b: OnnxBuilder, x: str, sd, prefix: str,
                       model_kind: str) -> str:
    """timm ConvNeXt stages in NCHW with NHWC norm/MLP islands; returns the
    final NCHW feature map."""
    spec = convnext_spec(model_kind)
    p = f"{prefix}." if prefix else ""
    x = b.conv(x, sd, f"{p}stem.0", strides=(4, 4))
    t = b.transpose(x, (0, 2, 3, 1))
    t = b.layernorm(t, sd, f"{p}stem.1", eps=1e-6)
    x = b.transpose(t, (0, 3, 1, 2))
    for s, depth in enumerate(spec["depths"]):
        if s > 0:
            t = b.transpose(x, (0, 2, 3, 1))
            t = b.layernorm(t, sd, f"{p}stages.{s}.downsample.0", eps=1e-6)
            x = b.transpose(t, (0, 3, 1, 2))
            x = b.conv(x, sd, f"{p}stages.{s}.downsample.1", strides=(2, 2))
        for blk in range(depth):
            bp = f"{p}stages.{s}.blocks.{blk}"
            dim = spec["dims"][s]
            if f"{bp}.mixer.dw_square.weight" in sd:
                # InceptionNeXt mixer (models/convnext.py): channel
                # split → dw3×3 / dw1×11 / dw11×1 / identity
                h = _inception_mixer(b, x, sd, bp, dim)
            else:
                h = b.conv(x, sd, f"{bp}.conv_dw", pads=(3, 3), group=dim)
            t = b.transpose(h, (0, 2, 3, 1))
            t = b.layernorm(t, sd, f"{bp}.norm", eps=1e-6)
            t = b.matmul_bias(t, sd[f"{bp}.mlp.fc1.weight"],
                              sd[f"{bp}.mlp.fc1.bias"], f"{bp}.fc1")
            t = b.gelu(t)
            t = b.matmul_bias(t, sd[f"{bp}.mlp.fc2.weight"],
                              sd[f"{bp}.mlp.fc2.bias"], f"{bp}.fc2")
            if f"{bp}.gamma" in sd:
                t = b.n("Mul", [t, b.init(
                    np.asarray(sd[f"{bp}.gamma"], np.float32),
                    f"{bp}.gamma")])
            h = b.transpose(t, (0, 3, 1, 2))
            x = b.n("Add", [x, h])
    return x


def _pool_norm_flatten(b: OnnxBuilder, x: str, sd, norm_prefix: str) -> str:
    """timm head surgery keep: global pool → LayerNorm → flatten."""
    x = b.n("GlobalAveragePool", [x])
    x = b.n("Flatten", [x], axis=1)
    return b.layernorm(x, sd, norm_prefix, eps=1e-6)


# ------------------------------- MaxViT -------------------------------

def _resize_to(b: OnnxBuilder, x: str, size: int) -> str:
    """Dynamic-batch bilinear resize NCHW → (N, 3, size, size), torch
    align_corners=False semantics (reference architectures.py:44-50)."""
    shape = b.n("Shape", [x])
    batch = b.n("Slice", [
        shape, b.init(np.asarray([0], np.int64), "starts"),
        b.init(np.asarray([1], np.int64), "ends")])
    sizes = b.n("Concat", [
        batch, b.init(np.asarray([3, size, size], np.int64), "hw")], axis=0)
    roi = b.init(np.asarray([], np.float32), "roi")
    scales = b.init(np.asarray([], np.float32), "scales")
    return b.n("Resize", [x, roi, scales, sizes], mode="linear",
               coordinate_transformation_mode="half_pixel")


def _mbconv(b: OnnxBuilder, x: str, sd, prefix: str, in_chs: int,
            out_chs: int, stride: int) -> str:
    shortcut = x
    if stride == 2:
        shortcut = b.n("AveragePool", [shortcut], kernel_shape=[2, 2],
                       strides=[2, 2])
    if stride == 2 or in_chs != out_chs:
        shortcut = b.conv(shortcut, sd, f"{prefix}.shortcut.conv")
    h = b.bn(x, sd, f"{prefix}.pre_norm")
    h = b.conv(h, sd, f"{prefix}.conv1_1x1")
    h = b.gelu(b.bn(h, sd, f"{prefix}.norm1"))
    mid = in_chs * 4
    h = b.conv(h, sd, f"{prefix}.conv2_kxk", strides=(stride, stride),
               pads=(1, 1), group=mid)
    h = b.gelu(b.bn(h, sd, f"{prefix}.norm2"))
    # squeeze-excite (silu gate)
    s = b.n("GlobalAveragePool", [h])
    s = b.conv(s, sd, f"{prefix}.se.fc1")
    s = b.n("Mul", [s, b.n("Sigmoid", [s])])
    s = b.conv(s, sd, f"{prefix}.se.fc2")
    h = b.n("Mul", [h, b.n("Sigmoid", [s])])
    h = b.conv(h, sd, f"{prefix}.conv3_1x1")
    return b.n("Add", [h, shortcut])


def _rel_pos_bias(sd, prefix: str, win: int) -> np.ndarray:
    table = np.asarray(sd[f"{prefix}.attn.rel_pos."
                          f"relative_position_bias_table"], np.float32)
    index = _rel_position_index(win)
    n = win * win
    bias = table[index.reshape(-1)].reshape(n, n, -1)
    return np.ascontiguousarray(bias.transpose(2, 0, 1)[None])  # (1,h,n,n)


def _attention(b: OnnxBuilder, tok: str, sd, prefix: str, dim: int,
               win: int) -> str:
    """Pre-LN rel-pos MHSA + MLP on (B', n, C) tokens."""
    heads, hd = dim // 32, 32
    n = win * win
    h = b.layernorm(tok, sd, f"{prefix}.norm1", eps=1e-5)
    qkv_w = np.asarray(sd[f"{prefix}.attn.qkv.weight"], np.float32)
    qkv_b = np.asarray(sd[f"{prefix}.attn.qkv.bias"], np.float32)
    parts = []
    for i in range(3):
        p = b.matmul_bias(h, qkv_w[i * dim:(i + 1) * dim],
                          qkv_b[i * dim:(i + 1) * dim], f"{prefix}.qkv{i}")
        p = b.reshape(p, (0, n, heads, hd))
        parts.append(b.transpose(p, (0, 2, 1, 3)))
    q, k, v = parts
    q = b.n("Mul", [q, b.const_f32(hd ** -0.5)])
    kt = b.transpose(k, (0, 1, 3, 2))
    scores = b.n("MatMul", [q, kt])
    scores = b.n("Add", [scores, b.init(_rel_pos_bias(sd, prefix, win),
                                        f"{prefix}.relpos")])
    attn = b.n("Softmax", [scores], axis=-1)
    o = b.n("MatMul", [attn, v])
    o = b.reshape(b.transpose(o, (0, 2, 1, 3)), (0, n, dim))
    o = b.matmul_bias(o, sd[f"{prefix}.attn.proj.weight"],
                      sd[f"{prefix}.attn.proj.bias"], f"{prefix}.proj")
    tok = b.n("Add", [tok, o])
    h = b.layernorm(tok, sd, f"{prefix}.norm2", eps=1e-5)
    h = b.matmul_bias(h, sd[f"{prefix}.mlp.fc1.weight"],
                      sd[f"{prefix}.mlp.fc1.bias"], f"{prefix}.fc1")
    h = b.gelu(h)
    h = b.matmul_bias(h, sd[f"{prefix}.mlp.fc2.weight"],
                      sd[f"{prefix}.mlp.fc2.bias"], f"{prefix}.fc2")
    return b.n("Add", [tok, h])


def _maxvit_backbone(b: OnnxBuilder, x: str, sd, prefix: str,
                     model_kind: str) -> str:
    """NCHW input → pooled (N, dims[-1]) feature (architectures.py:32-33)."""
    spec = maxvit_spec(model_kind)
    size = get_model_image_size(model_kind)
    win = max(1, size // 32)
    p = f"{prefix}." if prefix else ""

    x = _resize_to(b, x, size)
    x = b.conv(x, sd, f"{p}stem.conv1", strides=(2, 2), pads=(1, 1))
    x = b.gelu(b.bn(x, sd, f"{p}stem.norm1"))
    x = b.conv(x, sd, f"{p}stem.conv2", pads=(1, 1))

    in_chs, hw = spec["stem_width"], size // 2
    for s, (depth, dim) in enumerate(zip(spec["depths"], spec["dims"])):
        for blk in range(depth):
            stride = 2 if blk == 0 else 1
            hw //= stride
            bp = f"{p}stages.{s}.blocks.{blk}"
            x = _mbconv(b, x, sd, f"{bp}.conv", in_chs, dim, stride)
            t = b.transpose(x, (0, 2, 3, 1))  # NHWC for token ops
            # window partition (models/maxvit.py window_partition)
            w = b.reshape(t, (0, hw // win, win, hw // win, win, dim))
            w = b.transpose(w, (0, 1, 3, 2, 4, 5))
            w = b.reshape(w, (-1, win * win, dim))
            w = _attention(b, w, sd, f"{bp}.attn_block", dim, win)
            w = b.reshape(w, (-1, hw // win, hw // win, win, win, dim))
            w = b.transpose(w, (0, 1, 3, 2, 4, 5))
            t = b.reshape(w, (-1, hw, hw, dim))
            # grid partition
            g = b.reshape(t, (0, win, hw // win, win, hw // win, dim))
            g = b.transpose(g, (0, 2, 4, 1, 3, 5))
            g = b.reshape(g, (-1, win * win, dim))
            g = _attention(b, g, sd, f"{bp}.attn_grid", dim, win)
            g = b.reshape(g, (-1, hw // win, hw // win, win, win, dim))
            g = b.transpose(g, (0, 3, 1, 4, 2, 5))
            t = b.reshape(g, (-1, hw, hw, dim))
            x = b.transpose(t, (0, 3, 1, 2))
            in_chs = dim
    pooled = b.n("GlobalAveragePool", [x])
    return b.n("Flatten", [pooled], axis=1)


# ------------------------------ model graphs ------------------------------

def _build_graph(config: Config, sd) -> OnnxBuilder:
    name = config["model_name"]
    b = OnnxBuilder(f"btsbot_{name}")
    img = meta = None
    if config.need_triplets:
        s = int(config.get("image_size", 63))
        img = b.input("image", (None, 3, s, s))
    if config.need_metadata:
        meta = b.input("metadata", (None, len(config["metadata_cols"])))

    if name == "um_nn":
        x = _metadata_branch(b, meta, sd, "network", "relu")
        logits = b.gemm(x, sd, "network.6")
    elif name == "um_cnn":
        x = _cnn_backbone(b, img, sd, config)
        logits = _mlp_head(b, x, sd, ("head.0", "head.2", "head.5"), "relu")
    elif name == "mm_cnn":
        x = _cnn_backbone(b, img, sd, config)
        m = _metadata_branch(b, meta, sd, "metadata_branch", "relu")
        x = b.n("Concat", [x, m], axis=1)
        logits = _mlp_head(
            b, x, sd, ("combined_head.0", "combined_head.2",
                       "combined_head.5"), "relu")
    elif name == "ConvNeXt":
        x = _convnext_backbone(b, img, sd, "convnext", config.model_kind)
        x = _pool_norm_flatten(b, x, sd, "convnext.head.1")
        logits = _mlp_head(
            b, x, sd, ("convnext.head.3", "convnext.head.5",
                       "convnext.head.8"), "gelu")
    elif name == "mm_ConvNeXt":
        x = _convnext_backbone(b, img, sd, "convnext_backbone",
                               config.model_kind)
        if "LS" in config.get("train_data_version", ""):
            x = _pool_norm_flatten(b, x, sd, "convnext_backbone.head.1")
        else:
            x = b.n("Flatten", [x], axis=1)
        m = _metadata_branch(b, meta, sd, "metadata_branch", "gelu")
        x = b.n("Concat", [x, m], axis=1)
        logits = _mlp_head(
            b, x, sd, ("combined_head.0", "combined_head.2",
                       "combined_head.5"), "gelu")
    elif name == "MaxViT":
        x = _maxvit_backbone(b, img, sd, "maxvit", config.model_kind)
        logits = _mlp_head(b, x, sd, ("maxvit.head.1", "maxvit.head.3",
                                      "maxvit.head.6"), "gelu")
    elif name == "mm_MaxViT":
        x = _maxvit_backbone(b, img, sd, "maxvit_backbone",
                             config.model_kind)
        m = _metadata_branch(b, meta, sd, "metadata_branch", "gelu")
        x = b.n("Concat", [x, m], axis=1)
        logits = _mlp_head(
            b, x, sd, ("combined_head.0", "combined_head.2",
                       "combined_head.5"), "gelu")
    elif name == "frozen_fusion":
        cfg = resolve_fusion_config(dict(config))
        img_cfg = normalize_config(cfg["image_model_config"])
        img_name = img_cfg["model_name"]
        if img_name == "um_cnn":
            # head → Identity; emitted combined_head weights are in
            # NCHW-flatten order, matching this graph's Flatten
            x = _cnn_backbone(b, img, sd, img_cfg, prefix="image_branch.")
        elif img_name == "ConvNeXt":
            x = _convnext_backbone(b, img, sd, "image_branch.convnext",
                                   img_cfg["model_kind"])
            x = _pool_norm_flatten(b, x, sd, "image_branch.convnext.head.1")
        elif img_name == "MaxViT":
            x = _maxvit_backbone(b, img, sd, "image_branch.maxvit",
                                 img_cfg["model_kind"])
        else:
            raise NotImplementedError(
                f"frozen_fusion image branch {img_name}")
        # head-stripped um_nn: BN → fc1 → ReLU → (Dropout) → fc2, no
        # trailing activation (architectures.py:300-302)
        m = b.bn(meta, sd, "meta_branch.network.0", eps=1e-5)
        m = b.n("Relu", [b.gemm(m, sd, "meta_branch.network.1")])
        m = b.gemm(m, sd, "meta_branch.network.4")
        x = b.n("Concat", [x, m], axis=1)
        logits = _mlp_head(
            b, x, sd, ("combined_head.0", "combined_head.2",
                       "combined_head.5"), "relu")
    else:
        raise NotImplementedError(f"No ONNX emitter for model {name}")

    final = b.reshape(logits, (-1,), "logits_flat")
    b.g.nodes[-1].outputs[0] = "logits"
    b.output("logits", (None,))
    return b


def numpy_state_dict(weights) -> dict:
    """A model's (or a state dict's) entries as numpy arrays."""
    sd = weights.state_dict() if isinstance(weights, torch.nn.Module) else weights
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def export_onnx(config, weights, path: str) -> str:
    """Emit ``<path>`` (.onnx) for the model whose weights are ``weights`` (a
    port model or its reference-named state dict): dynamic batch axis,
    inputs image / metadata, output logits."""
    config = config if isinstance(config, Config) else normalize_config(config)
    data = _build_graph(config, numpy_state_dict(weights)).model_bytes()
    with open(path, "wb") as f:
        f.write(data)
    return path


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN inside, the previous settings back
    after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def port_logits(config, weights, triplets=None, metadata=None, device=None) -> np.ndarray:
    """The port's float32 eval-mode logits (N,) on ``device`` (default the
    card) for NHWC triplets and metadata, TF32 off."""
    config = config if isinstance(config, Config) else normalize_config(config)
    dev = resolve_device(device)
    sd = weights.state_dict() if isinstance(weights, torch.nn.Module) else weights

    def on_device(x):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    with float32_exact():
        model = build_model(config, dtype=torch.float32, device=dev)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
        with torch.inference_mode():
            logits = model(image_input=on_device(triplets), metadata_input=on_device(metadata))
    return logits.reshape(-1).float().cpu().numpy()


def verify_onnx(path: str, config, weights, triplets=None, metadata=None, device=None,
                rtol: float = 1e-4, atol: float = 1e-5,
                report_path: str | None = None) -> dict:
    """Execute the emitted graph (numpy evaluator; onnxruntime too when
    installed) against the port's float32 forward on ``device`` at rtol 1e-4
    / atol 1e-5.  NHWC triplets are transposed to the graph's NCHW input
    here."""
    from .onnx_numpy import run_model

    dev = resolve_device(device)
    feeds = {}
    if triplets is not None:
        feeds["image"] = np.ascontiguousarray(
            np.asarray(triplets, np.float32).transpose(0, 3, 1, 2))
    if metadata is not None:
        feeds["metadata"] = np.asarray(metadata, np.float32)
    want = port_logits(config, weights, triplets, metadata, device=dev)

    with open(path, "rb") as fh:
        model_bytes = fh.read()
    got = run_model(model_bytes, feeds)["logits"]
    report = {
        "close": bool(np.allclose(got, want, rtol=rtol, atol=atol)),
        "max_diff": float(np.max(np.abs(got - want))) if want.size else 0.0,
        "n": int(want.size), "rtol": rtol, "atol": atol,
        "artifact": "onnx", "runtime": "btsbot_tpu_torch.interop.onnx_numpy",
        "reference": f"btsbot_tpu_torch float32 forward on {dev}",
    }
    try:
        import onnxruntime as ort
    except ImportError:
        report["onnxruntime"] = "not installed; verified with in-repo evaluator"
    else:
        sess = ort.InferenceSession(model_bytes, providers=["CPUExecutionProvider"])
        ort_got = sess.run(["logits"], feeds)[0]
        report["onnxruntime_close"] = bool(np.allclose(ort_got, want, rtol=rtol, atol=atol))
        report["onnxruntime_max_diff"] = float(np.max(np.abs(ort_got - want)))
    if report_path:
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=1)
    return report


def export_and_verify_onnx(config, weights, path: str, triplets=None, metadata=None,
                           device=None) -> dict:
    """One call → artifact + verification report (<path>.verification.json)."""
    export_onnx(config, weights, path)
    return verify_onnx(path, config, weights, triplets, metadata, device=device,
                       report_path=f"{os.path.splitext(path)[0]}.verification.json")
