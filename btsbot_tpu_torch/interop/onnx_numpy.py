"""Numpy evaluator for the ONNX graphs this repo emits; a copy of
btsbot_tpu.interop.onnx_numpy (pure numpy, scipy's erf when installed).

onnxruntime is not a dependency of the port, so cross-runtime
verification of interop/onnx_export.py artifacts (the analog of the
reference's ``verify_pth_vs_onnx``, to_onnx.py:110-143) runs through this
independent executor: it parses the .onnx protobuf back with
interop/onnx_proto.py and evaluates node-by-node in numpy — a separate
implementation of every op's semantics (im2col convs, manual bilinear
resize, ...), so agreement with the port's own forward (PyTorch, the CUDA
kernels on the card) is a genuine two-runtime
check of both the emitted graph structure and the serialized weights.

Supports exactly the op set the emitters produce (opset 17 semantics):
Conv (grouped/depthwise), BatchNormalization, LayerNormalization, Gemm,
MatMul, Relu, Erf, Sigmoid, Softmax, Add/Sub/Mul/Div, MaxPool, AveragePool,
GlobalAveragePool, Flatten, Reshape, Transpose, Concat, Shape, Slice,
Resize (linear, half_pixel), Identity.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .onnx_proto import Node, decode_model

try:
    from scipy.special import erf as _erf  # vectorized (scipy ships with sklearn)
except ImportError:  # pragma: no cover
    _erf = np.vectorize(math.erf, otypes=[np.float32])


def _conv(x, w, b, attrs):
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("pads", [0, 0, 0, 0])
    group = int(attrs.get("group", 1))
    n, c, _, _ = x.shape
    o, cg, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    sw = sliding_window_view(xp, (kh, kw), axis=(2, 3))
    sw = sw[:, :, ::strides[0], ::strides[1]]           # (N,C,Ho,Wo,kh,kw)
    ho, wo = sw.shape[2], sw.shape[3]
    sw = sw.reshape(n, group, c // group, ho, wo, kh, kw)
    wg = w.reshape(group, o // group, cg, kh, kw)
    out = np.einsum("ngchwij,gocij->ngohw", sw, wg,
                    dtype=np.float32).reshape(n, o, ho, wo)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out.astype(np.float32)


def _pool(x, attrs, op):
    kh, kw = attrs["kernel_shape"]
    sh, sw_ = attrs.get("strides", [kh, kw])
    v = sliding_window_view(x, (kh, kw), axis=(2, 3))[:, :, ::sh, ::sw_]
    return (v.max(axis=(-2, -1)) if op == "max"
            else v.mean(axis=(-2, -1), dtype=np.float32)).astype(np.float32)


def _resize_linear(x, sizes):
    """Bilinear, half_pixel (torch align_corners=False)."""
    n, c, hi, wi = x.shape
    ho, wo = int(sizes[2]), int(sizes[3])

    def axis_coords(out_len, in_len):
        coords = (np.arange(out_len, dtype=np.float64) + 0.5) \
            * (in_len / out_len) - 0.5
        lo = np.clip(np.floor(coords).astype(np.int64), 0, in_len - 1)
        hi_ = np.clip(lo + 1, 0, in_len - 1)
        frac = np.clip(coords - np.floor(coords), 0.0, 1.0)
        frac = np.where(coords < 0, 0.0, frac)  # clamp below zero
        return lo, hi_, frac.astype(np.float32)

    l0, h0, f0 = axis_coords(ho, hi)
    rows = x[:, :, l0] * (1 - f0)[None, None, :, None] \
        + x[:, :, h0] * f0[None, None, :, None]
    l1, h1, f1 = axis_coords(wo, wi)
    out = rows[:, :, :, l1] * (1 - f1) + rows[:, :, :, h1] * f1
    return out.astype(np.float32)


def _reshape(x, shape):
    target = []
    for i, d in enumerate(shape.tolist()):
        target.append(x.shape[i] if d == 0 else int(d))
    return x.reshape(target)


def _gemm(x, w, b, attrs):
    if attrs.get("transA"):
        x = x.T
    if attrs.get("transB"):
        w = w.T
    y = x @ w
    return (y + b if b is not None else y).astype(np.float32)


def _batchnorm(x, scale, bias, mean, var, attrs):
    eps = attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = 1.0 / np.sqrt(var.reshape(shape) + eps)
    return ((x - mean.reshape(shape)) * inv * scale.reshape(shape)
            + bias.reshape(shape)).astype(np.float32)


def _layernorm(x, scale, bias, attrs):
    eps = attrs.get("epsilon", 1e-5)
    mean = x.mean(axis=-1, keepdims=True, dtype=np.float32)
    var = x.var(axis=-1, keepdims=True, dtype=np.float32)
    return ((x - mean) / np.sqrt(var + eps) * scale + bias).astype(np.float32)


def _softmax(x, attrs):
    axis = attrs.get("axis", -1)
    z = x - x.max(axis=axis, keepdims=True)
    e = np.exp(z, dtype=np.float32)
    return e / e.sum(axis=axis, keepdims=True, dtype=np.float32)


def _slice(data, starts, ends, axes=None, steps=None):
    axes = range(len(starts)) if axes is None else [int(a) for a in axes]
    steps = [1] * len(starts) if steps is None else [int(s) for s in steps]
    idx = [slice(None)] * data.ndim
    for a, s, e, st in zip(axes, starts.tolist(), ends.tolist(), steps):
        idx[a] = slice(int(s), int(e), st)
    return data[tuple(idx)]


def _eval_node(node: Node, vals: dict) -> np.ndarray:
    def inp(i, default=None):
        if i >= len(node.inputs) or not node.inputs[i]:
            return default
        return vals[node.inputs[i]]

    op, a = node.op_type, node.attrs
    x = inp(0)
    if op == "Conv":
        return _conv(x, inp(1), inp(2), a)
    if op == "BatchNormalization":
        return _batchnorm(x, inp(1), inp(2), inp(3), inp(4), a)
    if op == "LayerNormalization":
        return _layernorm(x, inp(1), inp(2), a)
    if op == "Gemm":
        return _gemm(x, inp(1), inp(2), a)
    if op == "MatMul":
        return (x @ inp(1)).astype(np.float32)
    if op == "Relu":
        return np.maximum(x, 0)
    if op == "Erf":
        return np.asarray(_erf(x), np.float32)
    if op == "Sigmoid":
        return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    if op == "Softmax":
        return _softmax(x, a)
    if op == "Add":
        return x + inp(1)
    if op == "Sub":
        return x - inp(1)
    if op == "Mul":
        return x * inp(1)
    if op == "Div":
        return x / inp(1)
    if op == "MaxPool":
        return _pool(x, a, "max")
    if op == "AveragePool":
        return _pool(x, a, "avg")
    if op == "GlobalAveragePool":
        return x.mean(axis=(2, 3), keepdims=True, dtype=np.float32)
    if op == "Flatten":
        return x.reshape(x.shape[0], -1)
    if op == "Reshape":
        return _reshape(x, inp(1))
    if op == "Transpose":
        return np.transpose(x, a["perm"])
    if op == "Concat":
        return np.concatenate([vals[i] for i in node.inputs],
                              axis=a.get("axis", 0))
    if op == "Shape":
        return np.asarray(x.shape, np.int64)
    if op == "Slice":
        return _slice(x, inp(1), inp(2), inp(3), inp(4))
    if op == "Resize":
        assert a.get("mode", "nearest") == "linear" and \
            a.get("coordinate_transformation_mode") == "half_pixel", \
            "only linear/half_pixel Resize is emitted"
        return _resize_linear(x, inp(3))
    if op == "Identity":
        return x
    raise NotImplementedError(f"Op {op} not supported by the numpy evaluator")


def run_model(model_bytes: bytes, feeds: Mapping[str, np.ndarray]) -> dict:
    """Execute a serialized ONNX model on the given input feeds; returns
    {output_name: array}."""
    graph = decode_model(model_bytes)
    vals: dict[str, np.ndarray] = {t.name: t.array
                                   for t in graph.initializers}
    for name, _shape, _elem in graph.inputs:
        if name not in feeds:
            raise KeyError(f"Missing input feed {name!r}")
        vals[name] = np.asarray(feeds[name])
    for node in graph.nodes:
        vals[node.outputs[0]] = _eval_node(node, vals)
    return {name: vals[name] for name, _s, _e in graph.outputs}
