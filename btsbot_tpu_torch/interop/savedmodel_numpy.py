"""Numpy evaluator for the TF SavedModels ``interop.savedmodel`` writes.

The machine with the card has no TensorFlow, so this is how the artifact
is verified there (as ``onnx_numpy`` serves the ONNX artifact): it parses
``saved_model.pb`` back with ``protowire`` (MetaGraphDef tagged ``serve``,
its GraphDef and the ``serving_default`` SignatureDef) and evaluates the
signature's outputs node by node in numpy, with TF's semantics for each op
(NHWC layouts, SAME / VALID padding as TF computes it, half-pixel bilinear
resize).  The convolution, pooling, resize and softmax arithmetic is
``onnx_numpy``'s, applied through the layout each TF op defines.

Supports exactly the op set the writer emits: Placeholder, Const, Identity,
Transpose, Reshape, Shape, StridedSlice (begin / end masks), ConcatV2, Pad,
Conv2D, DepthwiseConv2dNative, MaxPool, AvgPool, Mean, MatMul,
BatchMatMulV2, AddV2, Sub, Mul, RealDiv, SquaredDifference, Rsqrt, Relu,
Erf, Sigmoid, Softmax, ResizeBilinear (half-pixel centers).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from .onnx_numpy import _conv, _erf, _pool, _resize_linear, _softmax
from .protowire import fields, packed_varints, read_map_entry, signed

DT_TO_NP = {1: np.dtype(np.float32), 3: np.dtype(np.int32)}   # DT_FLOAT, DT_INT32


@dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    inputs: list[str] = field(default_factory=list)
    attrs: dict[str, Any] = field(default_factory=dict)


@dataclass
class MetaGraph:
    tags: list[str]
    nodes: list[NodeDef]
    signatures: dict[str, dict]   # key → {"inputs": {k: tensor info}, "outputs": {...}}


# ----------------------------- decoding -----------------------------

def _shape(buf: bytes) -> list[int]:
    dims = []
    for fno, _, dim in fields(buf):
        if fno == 2:
            size = 0
            for f2, _, v in fields(dim):
                if f2 == 1:
                    size = signed(v)
            dims.append(size)
    return dims


def _tensor(buf: bytes) -> np.ndarray:
    dtype, dims, content = None, [], b""
    for fno, _, val in fields(buf):
        if fno == 1:
            dtype = DT_TO_NP[val]
        elif fno == 2:
            dims = _shape(val)
        elif fno == 4:
            content = val
        elif fno in (5, 7, 10):
            raise ValueError("only tensor_content tensors are read")
    return np.frombuffer(content, dtype.newbyteorder("<")).astype(dtype).reshape(dims)


def _attr(buf: bytes) -> Any:
    for fno, _, val in fields(buf):
        if fno == 1:                       # ListValue
            out = []
            for f2, wire, v in fields(val):
                if f2 == 2:
                    out.append(v.decode())
                elif f2 in (3, 6):
                    out.extend(packed_varints(v) if wire == 2 else [signed(v)])
            return out
        if fno == 2:
            return val.decode()
        if fno == 3:
            return signed(val)
        if fno == 4:
            return float(val)
        if fno == 5:
            return bool(val)
        if fno == 6:
            return DT_TO_NP.get(val, val)
        if fno == 7:
            return _shape(val)
        if fno == 8:
            return _tensor(val)
    return None


def _node(buf: bytes) -> NodeDef:
    node = NodeDef()
    for fno, _, val in fields(buf):
        if fno == 1:
            node.name = val.decode()
        elif fno == 2:
            node.op = val.decode()
        elif fno == 3:
            node.inputs.append(val.decode())
        elif fno == 5:
            key, value = read_map_entry(val)
            node.attrs[key] = _attr(value)
    return node


def _tensor_info(buf: bytes) -> dict:
    info = {"name": "", "dtype": None, "shape": None}
    for fno, _, val in fields(buf):
        if fno == 1:
            info["name"] = val.decode()
        elif fno == 2:
            info["dtype"] = DT_TO_NP.get(val, val)
        elif fno == 3:
            info["shape"] = _shape(val)
    return info


def _signature(buf: bytes) -> dict:
    sig = {"inputs": {}, "outputs": {}}
    for fno, _, val in fields(buf):
        if fno in (1, 2):
            key, value = read_map_entry(val)
            sig["inputs" if fno == 1 else "outputs"][key] = _tensor_info(value)
    return sig


def _meta_graph(buf: bytes) -> MetaGraph:
    mg = MetaGraph([], [], {})
    for fno, _, val in fields(buf):
        if fno == 1:
            mg.tags += [v.decode() for f2, _, v in fields(val) if f2 == 4]
        elif fno == 2:
            mg.nodes += [_node(v) for f2, _, v in fields(val) if f2 == 1]
        elif fno == 5:
            key, value = read_map_entry(val)
            mg.signatures[key] = _signature(value)
    return mg


def decode_saved_model(data: bytes, tag: str = "serve") -> MetaGraph:
    """The MetaGraphDef of ``saved_model.pb`` bytes that carries ``tag``."""
    for fno, _, val in fields(data):
        if fno == 2:
            mg = _meta_graph(val)
            if tag in mg.tags:
                return mg
    raise ValueError(f"No MetaGraphDef tagged {tag!r}")


# ----------------------------- ops -----------------------------

def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF's SAME padding: the output is ceil(size / s), the extra row at
    the end."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_nhwc(x, filt, a, depthwise: bool):
    if a.get("data_format", "NHWC") != "NHWC" or any(d != 1 for d in a.get("dilations", [])):
        raise NotImplementedError("Conv other than NHWC, dilation 1")
    kh, kw = filt.shape[:2]
    _, sh, sw, _ = a["strides"]
    if a["padding"] == "SAME":
        (t, b), (l, r) = _same_pads(x.shape[1], kh, sh), _same_pads(x.shape[2], kw, sw)
    elif a["padding"] == "VALID":
        t = b = l = r = 0
    else:
        raise NotImplementedError(f"padding {a['padding']}")
    if depthwise:     # (kh, kw, C, m) → OIHW (C·m, 1, kh, kw), C groups
        c = filt.shape[2]
        w, group = filt.transpose(2, 3, 0, 1).reshape(-1, 1, kh, kw), c
    else:             # HWIO → OIHW
        w, group = filt.transpose(3, 2, 0, 1), 1
    y = _conv(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), np.ascontiguousarray(w), None,
              {"strides": [sh, sw], "pads": [t, l, b, r], "group": group})
    return y.transpose(0, 2, 3, 1)


def _pool_nhwc(x, a, op: str):
    if a.get("padding") != "VALID" or a.get("data_format", "NHWC") != "NHWC":
        raise NotImplementedError("pool other than VALID NHWC")
    attrs = {"kernel_shape": a["ksize"][1:3], "strides": a["strides"][1:3]}
    return _pool(x.transpose(0, 3, 1, 2), attrs, op).transpose(0, 2, 3, 1)


def _strided_slice(x, begin, end, strides, a):
    if any(a.get(k, 0) for k in ("ellipsis_mask", "new_axis_mask", "shrink_axis_mask")):
        raise NotImplementedError("StridedSlice with ellipsis / new-axis / shrink masks")
    idx = []
    for i, (b, e, s) in enumerate(zip(begin.tolist(), end.tolist(), strides.tolist())):
        idx.append(slice(None if a.get("begin_mask", 0) >> i & 1 else b,
                         None if a.get("end_mask", 0) >> i & 1 else e, s))
    return x[tuple(idx)]


def _resize_bilinear(x, size, a):
    if a.get("align_corners") or not a.get("half_pixel_centers"):
        raise NotImplementedError("ResizeBilinear other than half-pixel centers")
    n, _, _, c = x.shape
    y = _resize_linear(x.transpose(0, 3, 1, 2), (n, c, int(size[0]), int(size[1])))
    return y.transpose(0, 2, 3, 1)


def _eval(node: NodeDef, args: list) -> np.ndarray:
    op, a = node.op, node.attrs
    x = args[0] if args else None
    if op == "Const":
        return a["value"]
    if op == "Identity":
        return x
    if op == "Transpose":
        return np.transpose(x, args[1].tolist())
    if op == "Reshape":
        return x.reshape(args[1].tolist())
    if op == "Shape":
        return np.asarray(x.shape, a.get("out_type", np.dtype(np.int32)))
    if op == "StridedSlice":
        return _strided_slice(x, *args[1:4], a)
    if op == "ConcatV2":
        return np.concatenate(args[:-1], axis=int(args[-1]))
    if op == "Pad":
        return np.pad(x, args[1].tolist())
    if op == "Conv2D":
        return _conv_nhwc(x, args[1], a, depthwise=False)
    if op == "DepthwiseConv2dNative":
        return _conv_nhwc(x, args[1], a, depthwise=True)
    if op == "MaxPool":
        return _pool_nhwc(x, a, "max")
    if op == "AvgPool":
        return _pool_nhwc(x, a, "avg")
    if op == "Mean":
        return x.mean(axis=tuple(np.atleast_1d(args[1]).tolist()),
                      keepdims=bool(a.get("keep_dims")), dtype=np.float32)
    if op in ("MatMul", "BatchMatMulV2"):
        if any(a.get(k) for k in ("transpose_a", "transpose_b", "adj_x", "adj_y")):
            raise NotImplementedError(f"{op} of transposed operands")
        return np.matmul(x, args[1]).astype(np.float32)
    if op == "AddV2":
        return x + args[1]
    if op == "Sub":
        return x - args[1]
    if op == "Mul":
        return x * args[1]
    if op == "RealDiv":
        return x / args[1]
    if op == "SquaredDifference":
        return np.square(x - args[1])
    if op == "Rsqrt":
        return (1.0 / np.sqrt(x)).astype(np.float32)
    if op == "Relu":
        return np.maximum(x, 0)
    if op == "Erf":
        return np.asarray(_erf(x), np.float32)
    if op == "Sigmoid":
        return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    if op == "Softmax":
        return _softmax(x, {"axis": -1})
    if op == "ResizeBilinear":
        return _resize_bilinear(x, args[1], a)
    raise NotImplementedError(f"Op {op} not supported by the numpy evaluator")


def _node_name(ref: str) -> str:
    if ref.startswith("^"):
        raise NotImplementedError("control inputs")
    name, _, port = ref.partition(":")
    if port not in ("", "0"):
        raise NotImplementedError(f"output {ref} of a multi-output op")
    return name


def run_graph(mg: MetaGraph, feeds: Mapping[str, np.ndarray],
              signature: str = "serving_default") -> dict:
    """Evaluate ``signature``'s outputs on ``feeds`` ({input key: array});
    returns {output key: array}."""
    sig = mg.signatures[signature]
    nodes = {n.name: n for n in mg.nodes}
    vals: dict[str, np.ndarray] = {}
    for key, info in sig["inputs"].items():
        if key not in feeds:
            raise KeyError(f"Missing input feed {key!r}")
        vals[_node_name(info["name"])] = np.asarray(feeds[key], info["dtype"])
    for info in sig["outputs"].values():      # depth-first, without recursion
        stack = [_node_name(info["name"])]
        while stack:
            name = stack[-1]
            if name in vals:
                stack.pop()
                continue
            node = nodes[name]
            if node.op == "Placeholder":
                raise KeyError(f"Placeholder {name!r} is not a signature input")
            deps = [_node_name(i) for i in node.inputs]
            missing = [d for d in deps if d not in vals]
            if missing:
                stack += missing
                continue
            vals[name] = _eval(node, [vals[d] for d in deps])
            stack.pop()
    return {key: vals[_node_name(info["name"])] for key, info in sig["outputs"].items()}


def run_saved_model(path: str, feeds: Mapping[str, np.ndarray]) -> dict:
    """Evaluate the ``serving_default`` signature of the SavedModel at
    ``path`` (a directory or its ``saved_model.pb``) on ``feeds``."""
    if os.path.isdir(path):
        path = os.path.join(path, "saved_model.pb")
    with open(path, "rb") as fh:
        return run_graph(decode_saved_model(fh.read()), feeds)
