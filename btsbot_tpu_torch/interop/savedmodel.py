"""The TF SavedModel deployment artifact, written with no TensorFlow, no
``protobuf`` package and no JAX (port of btsbot_tpu.interop.savedmodel,
which lowers the flax forward through jax2tf).

The contract is the JAX artifact's: tag ``serve``, signature
``serving_default`` (method ``tensorflow/serving/predict``) with inputs
``image`` (float32 NHWC ``[-1, S, S, 3]``, S the config's ``image_size``)
and/or ``metadata`` (float32 ``[-1, n_meta]``), each present only when the
family needs it, and output ``logits`` (float32 ``[-1]``), the batch axis
dynamic.  TF-Serving, ``saved_model_cli`` and
``tf.saved_model.load(d).signatures["serving_default"](image=..., metadata=...)``
all make that call.

The graph is the one ``onnx_export._build_graph`` builds for every family
(verified on the card against the port's forward), translated node by node
into native TF ops: weights are ``Const`` nodes (TensorProto
``tensor_content``, little-endian), so the GraphDef has no variables and the
directory an empty ``variables/`` (TF1 SavedModel format, no ``saver_def``:
TF's loader and TF-Serving restore nothing).  The ONNX graph is NCHW; the
translation keeps each value in whichever layout its producer left it and
records the permutation that gives the ONNX layout, so convolutions and
pools run in NHWC (the layout every TF CPU kernel supports), the image
placeholder feeds them with no transpose, and a ``Transpose`` is emitted
only where an op needs the ONNX layout itself (a flatten, a LayerNorm over
the last axis, a product).  BatchNorm is folded into a constant multiply
and add; LayerNorm is spelled ``Mean`` → ``SquaredDifference`` → ``Mean`` →
``Rsqrt``; GELU keeps the graph's exact erf form.

``verify_saved_model`` evaluates the artifact with the in-repo numpy
evaluator (``savedmodel_numpy``; the machine with the card has no
TensorFlow) against the port's float32 forward on ``device`` at rtol 1e-4 /
atol 1e-5, and also through TensorFlow's loaded signature where TensorFlow
is installed.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

import numpy as np

from ..core.config import Config, normalize_config
from ..core.device import resolve_device
from .onnx_export import _build_graph, numpy_state_dict, port_logits
from .onnx_proto import Graph
from .protowire import fs, fv, map_entry, varint

DEFAULT_TOLERANCE = {"rtol": 1e-4, "atol": 1e-5}
SERVING_TAG = "serve"
SIGNATURE_KEY = "serving_default"
PREDICT_METHOD = "tensorflow/serving/predict"
# GraphDef versions.producer: TF 2.15's graph version; every op emitted here
# predates it
PRODUCER = 1645

# tensorflow/core/framework/types.proto
DT_FLOAT, DT_INT32 = 1, 3
NP_TO_DT = {np.dtype(np.float32): DT_FLOAT, np.dtype(np.int32): DT_INT32}

NHWC = (0, 2, 3, 1)        # NCHW value → NHWC storage
FROM_NHWC = (0, 3, 1, 2)   # NHWC storage → the NCHW value it holds


# ----------------------------- message encoding -----------------------------

def shape_proto(dims) -> bytes:
    """TensorShapeProto; -1 for an unknown dimension."""
    return b"".join(fs(2, fv(1, d)) for d in dims)


def tensor_proto(array: np.ndarray) -> bytes:
    a = np.asarray(array)    # (np.ascontiguousarray would make a scalar 1-d)
    return (fv(1, NP_TO_DT[a.dtype]) + fs(2, shape_proto(a.shape))
            + fs(4, a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()))


def attr_type(dtype) -> bytes:
    return fv(6, NP_TO_DT[np.dtype(dtype)])


def attr_int(n: int) -> bytes:
    return fv(3, n)


def attr_bool(b: bool) -> bytes:
    return fv(5, int(b))


def attr_str(s: str) -> bytes:
    return fs(2, s)


def attr_ints(values) -> bytes:
    return fs(1, fs(3, b"".join(varint(v) for v in values)))


def attr_shape(dims) -> bytes:
    return fs(7, shape_proto(dims))


def attr_tensor(array: np.ndarray) -> bytes:
    return fs(8, tensor_proto(array))


@dataclass
class TfNode:
    name: str
    op: str
    inputs: list[str]
    attrs: dict[str, bytes] = field(default_factory=dict)   # name → AttrValue bytes

    def encode(self) -> bytes:
        out = fs(1, self.name) + fs(2, self.op)
        out += b"".join(fs(3, i) for i in self.inputs)
        return out + b"".join(map_entry(5, k, self.attrs[k]) for k in sorted(self.attrs))


def _tensor_info(name: str, dims) -> bytes:
    return fs(1, f"{name}:0") + fv(2, DT_FLOAT) + fs(3, shape_proto(dims))


def encode_saved_model(nodes: list[TfNode], inputs: dict, outputs: dict) -> bytes:
    """``saved_model.pb``: one MetaGraphDef tagged ``serve`` holding the
    GraphDef and the ``serving_default`` SignatureDef over ``inputs`` /
    ``outputs`` ({key: (node name, dims)})."""
    graph = b"".join(fs(1, n.encode()) for n in nodes) + fs(4, fv(1, PRODUCER))
    signature = b"".join(map_entry(1, k, _tensor_info(*v)) for k, v in inputs.items())
    signature += b"".join(map_entry(2, k, _tensor_info(*v)) for k, v in outputs.items())
    signature += fs(3, PREDICT_METHOD)
    # stripped_default_attrs: loaders add every attribute left at its default
    meta_info = fs(4, SERVING_TAG) + fv(7, 1)
    meta_graph = fs(1, meta_info) + fs(2, graph) + map_entry(5, SIGNATURE_KEY, signature)
    return fv(1, 1) + fs(2, meta_graph)


# ----------------------------- ONNX → TF -----------------------------

def _compose(have: tuple, perm) -> tuple:
    """transpose(transpose(a, have), perm) == transpose(a, result)."""
    return tuple(have[p] for p in perm)


class _Translator:
    """ONNX graph (``onnx_proto.Graph``) → TF ``NodeDef`` list.

    ``vals[onnx name] = (tf name, perm)``: the ONNX value is
    ``transpose(tf value, perm)``; ``len(perm)`` is its rank."""

    def __init__(self, graph: Graph, config: Config):
        self.graph = graph
        self.inits = {t.name: t.array for t in graph.initializers}
        self.producer = {n.outputs[0]: n for n in graph.nodes}
        self.nodes: list[TfNode] = []
        self.names = {"image", "metadata", "logits"}
        self.vals: dict[str, tuple[str, tuple]] = {}
        self._layouts: dict[tuple, str] = {}
        self.signature_inputs = {}
        if config.need_triplets:
            s = int(config.get("image_size", 63))
            self._placeholder("image", (-1, s, s, 3), FROM_NHWC)
        if config.need_metadata:
            self._placeholder("metadata", (-1, len(config["metadata_cols"])), (0, 1))

    # ---------------- emission ----------------

    def emit(self, op: str, inputs: list[str], hint: str, **attrs) -> str:
        base = re.sub(r"[^A-Za-z0-9_.\-/]", "_", hint)
        base = base if re.match(r"[A-Za-z0-9.]", base) else f"n{base}"
        name, i = base, 0
        while name in self.names:
            i += 1
            name = f"{base}_{i}"
        self.names.add(name)
        self.nodes.append(TfNode(name, op, list(inputs), attrs))
        return name

    def f32(self, op: str, inputs: list[str], hint: str | None = None, **attrs) -> str:
        return self.emit(op, inputs, hint or op, T=attr_type(np.float32), **attrs)

    def const(self, array, hint: str = "const") -> str:
        a = np.asarray(array)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return self.emit("Const", [], hint, dtype=attr_type(a.dtype), value=attr_tensor(a))

    def ints(self, values, hint: str) -> str:
        return self.const(np.asarray(values, np.int32), hint)

    def _placeholder(self, name: str, dims, perm: tuple) -> None:
        self.nodes.append(TfNode(name, "Placeholder", [], {
            "dtype": attr_type(np.float32), "shape": attr_shape(dims)}))
        self.vals[name] = (name, perm)
        self.signature_inputs[name] = (name, dims)

    # ---------------- layouts ----------------

    def layout(self, name: str, perm: tuple | None = None) -> str:
        """A TF tensor holding ``transpose(onnx value, perm)`` (``perm``
        None: the ONNX layout itself)."""
        src, have = self.vals[name]
        total = have if perm is None else _compose(have, perm)
        if total == tuple(range(len(total))):
            return src
        key = (src, total)
        if key not in self._layouts:
            self._layouts[key] = self.emit(
                "Transpose", [src, self.ints(total, "perm")], "transpose",
                T=attr_type(np.float32), Tperm=attr_type(np.int32))
        return self._layouts[key]

    def rank(self, name: str) -> int:
        return len(self.vals[name][1])

    def stored_const(self, array: np.ndarray, perm: tuple) -> np.ndarray:
        """A constant operand broadcast against an ONNX value, laid out as
        that value is stored (``transpose(stored, perm)`` is the ONNX
        layout)."""
        a = np.asarray(array, np.float32)
        if a.size <= 1 or perm == tuple(range(len(perm))):
            return a
        a = a.reshape((1,) * (len(perm) - a.ndim) + a.shape)
        return np.ascontiguousarray(np.transpose(a, np.argsort(perm)))

    # ---------------- translation ----------------

    def _needed(self) -> list:
        """The ONNX nodes the outputs depend on, in graph order (a Resize's
        sizes are read as constants, so their Shape/Slice/Concat go)."""
        need, stack = set(), [o[0] for o in self.graph.outputs]
        while stack:
            node = self.producer.get(stack.pop())
            if node is None or id(node) in need:
                continue
            need.add(id(node))
            stack += node.inputs[:1] if node.op_type == "Resize" else node.inputs
        return [n for n in self.graph.nodes if id(n) in need]

    def run(self) -> tuple[list[TfNode], dict, dict]:
        for node in self._needed():
            self.vals[node.outputs[0]] = self.translate(node)
        out = self.graph.outputs[0][0]
        self.nodes.append(TfNode("logits", "Identity", [self.layout(out)],
                                 {"T": attr_type(np.float32)}))
        return self.nodes, self.signature_inputs, {"logits": ("logits", (-1,))}

    def translate(self, node) -> tuple[str, tuple]:
        op, a, ins = node.op_type, node.attrs, node.inputs
        hint = node.outputs[0]
        if op == "Transpose":
            src, have = self.vals[ins[0]]
            return src, _compose(have, a["perm"])
        if op == "Identity":
            return self.vals[ins[0]]
        if op in ("Add", "Sub", "Mul", "Div"):
            return self._binary({"Add": "AddV2", "Sub": "Sub", "Mul": "Mul",
                                 "Div": "RealDiv"}[op], ins, hint)
        if op in ("Relu", "Erf", "Sigmoid"):
            src, perm = self.vals[ins[0]]
            return self.f32(op, [src], hint), perm
        if op == "Conv":
            return self._conv(ins, a, hint)
        if op in ("MaxPool", "AveragePool"):
            if any(a.get("pads", [])):
                raise NotImplementedError(f"padded {op}")
            k, s = a["kernel_shape"], a.get("strides", a["kernel_shape"])
            y = self.f32("MaxPool" if op == "MaxPool" else "AvgPool",
                         [self.layout(ins[0], NHWC)], hint, ksize=attr_ints([1, *k, 1]),
                         strides=attr_ints([1, *s, 1]), padding=attr_str("VALID"),
                         data_format=attr_str("NHWC"))
            return y, FROM_NHWC
        if op == "GlobalAveragePool":
            return self._mean(self.layout(ins[0], NHWC), [1, 2], hint), FROM_NHWC
        if op == "BatchNormalization":
            return self._batchnorm(ins, a, hint)
        if op == "LayerNormalization":
            return self._layernorm(ins, a, hint)
        if op == "Gemm":
            return self._gemm(ins, a, hint)
        if op == "MatMul":
            return self._matmul(ins, hint)
        if op == "Softmax":
            if a.get("axis", -1) not in (-1, self.rank(ins[0]) - 1):
                raise NotImplementedError("Softmax over an axis other than the last")
            return self.f32("Softmax", [self.layout(ins[0])], hint), self._identity(ins[0])
        if op == "Flatten":
            return self._flatten(ins, a, hint)
        if op == "Reshape":
            return self._reshape(ins, hint)
        if op == "Concat":
            return self._concat(ins, a, hint)
        if op == "Slice":
            return self._slice(ins, hint)
        if op == "Resize":
            return self._resize(ins, a, hint)
        raise NotImplementedError(f"No TF translation for ONNX op {op}")

    def _identity(self, name: str) -> tuple:
        return tuple(range(self.rank(name)))

    def _binary(self, tf_op: str, ins: list[str], hint: str) -> tuple[str, tuple]:
        x, y = ins
        if x in self.inits or y in self.inits:
            var = y if x in self.inits else x
            src, perm = self.vals[var]
            c = self.const(self.stored_const(self.inits[x if var == y else y], perm),
                           f"{hint}/c")
            return self.f32(tf_op, [c, src] if var == y else [src, c], hint), perm
        (sx, px), (sy, py) = self.vals[x], self.vals[y]
        if px == py:
            return self.f32(tf_op, [sx, sy], hint), px
        out = self.f32(tf_op, [self.layout(x), self.layout(y)], hint)
        return out, tuple(range(max(len(px), len(py))))

    def _mean(self, x: str, axes, hint: str) -> str:
        return self.emit("Mean", [x, self.ints(axes, f"{hint}/axes")], hint,
                         T=attr_type(np.float32), Tidx=attr_type(np.int32),
                         keep_dims=attr_bool(True))

    def _conv(self, ins, a, hint) -> tuple[str, tuple]:
        w = self.inits[ins[1]]
        group = int(a.get("group", 1))
        kh, kw = w.shape[2:]
        sh, sw = a.get("strides", [1, 1])
        top, left, bottom, right = a.get("pads", [0, 0, 0, 0])
        x = self.layout(ins[0], NHWC)
        if all(s == 1 and k % 2 and p0 == p1 == (k - 1) // 2
               for s, k, p0, p1 in ((sh, kh, top, bottom), (sw, kw, left, right))):
            padding = "SAME"
        else:
            padding = "VALID"
            if any((top, left, bottom, right)):
                x = self.emit("Pad", [x, self.ints([[0, 0], [top, bottom], [left, right],
                                                    [0, 0]], f"{hint}/pads")],
                              f"{hint}/pad", T=attr_type(np.float32),
                              Tpaddings=attr_type(np.int32))
        common = dict(strides=attr_ints([1, sh, sw, 1]), padding=attr_str(padding),
                      data_format=attr_str("NHWC"))
        if group == 1:
            y = self.f32("Conv2D", [x, self.const(w.transpose(2, 3, 1, 0), f"{hint}/filter")],
                         hint, **common)
        elif w.shape[1] == 1:    # depthwise: ONNX (C·m, 1, kh, kw) → (kh, kw, C, m)
            filt = w.reshape(group, -1, kh, kw).transpose(2, 3, 0, 1)
            y = self.f32("DepthwiseConv2dNative", [x, self.const(filt, f"{hint}/filter")],
                         hint, **common)
        else:
            raise NotImplementedError(f"grouped Conv with {group} groups of "
                                      f"{w.shape[1]} channels")
        if len(ins) > 2:
            y = self.f32("AddV2", [y, self.const(self.inits[ins[2]], f"{hint}/bias")],
                         f"{hint}/bias_add")
        return y, FROM_NHWC

    def _batchnorm(self, ins, a, hint) -> tuple[str, tuple]:
        """y = x·scale + shift with scale = γ/√(var + eps), shift = β -
        mean·scale (in float64, rounded once)."""
        g, b, mean, var = (self.inits[i].astype(np.float64) for i in ins[1:5])
        scale = g / np.sqrt(var + float(a.get("epsilon", 1e-5)))
        src, perm = self.vals[ins[0]]
        bshape = (1, -1) + (1,) * (len(perm) - 2)
        s = self.const(self.stored_const(scale.reshape(bshape), perm), f"{hint}/scale")
        t = self.const(self.stored_const((b - mean * scale).reshape(bshape), perm),
                       f"{hint}/shift")
        return self.f32("AddV2", [self.f32("Mul", [src, s], f"{hint}/mul"), t], hint), perm

    def _layernorm(self, ins, a, hint) -> tuple[str, tuple]:
        if a.get("axis", -1) not in (-1, self.rank(ins[0]) - 1):
            raise NotImplementedError("LayerNormalization over other than the last axis")
        x = self.layout(ins[0])
        mean = self._mean(x, [-1], f"{hint}/mean")
        var = self._mean(self.f32("SquaredDifference", [x, mean], f"{hint}/sqdiff"), [-1],
                         f"{hint}/var")
        eps = self.const(np.float32(a.get("epsilon", 1e-5)), f"{hint}/eps")
        inv = self.f32("Rsqrt", [self.f32("AddV2", [var, eps], f"{hint}/var_eps")],
                       f"{hint}/rsqrt")
        y = self.f32("Mul", [self.f32("Sub", [x, mean], f"{hint}/centred"), inv],
                     f"{hint}/normed")
        y = self.f32("Mul", [y, self.const(self.inits[ins[1]], f"{hint}/gamma")],
                     f"{hint}/scaled")
        y = self.f32("AddV2", [y, self.const(self.inits[ins[2]], f"{hint}/beta")], hint)
        return y, self._identity(ins[0])

    def _gemm(self, ins, a, hint) -> tuple[str, tuple]:
        if a.get("transA") or a.get("alpha", 1.0) != 1.0 or a.get("beta", 1.0) != 1.0:
            raise NotImplementedError("Gemm with transA, alpha or beta")
        w = self.inits[ins[1]]
        w = w.T if a.get("transB") else w
        y = self.f32("MatMul", [self.layout(ins[0]), self.const(w, f"{hint}/w")],
                     f"{hint}/matmul")
        if len(ins) > 2:
            y = self.f32("AddV2", [y, self.const(self.inits[ins[2]], f"{hint}/b")], hint)
        return y, (0, 1)

    def _matmul(self, ins, hint) -> tuple[str, tuple]:
        x = self.layout(ins[0])
        if ins[1] in self.inits:
            w, rw = self.const(self.inits[ins[1]], f"{hint}/w"), self.inits[ins[1]].ndim
        else:
            w, rw = self.layout(ins[1]), self.rank(ins[1])
        r = max(self.rank(ins[0]), rw)
        op = "MatMul" if r == 2 else "BatchMatMulV2"
        return self.f32(op, [x, w], hint), tuple(range(r))

    def _batch_and(self, x: str, rest, hint: str) -> str:
        """int32 shape [batch of x, *rest] (the batch axis is dynamic)."""
        shape = self.emit("Shape", [x], f"{hint}/shape", T=attr_type(np.float32),
                          out_type=attr_type(np.int32))
        batch = self.emit("StridedSlice", [shape, self.ints([0], f"{hint}/b0"),
                                           self.ints([1], f"{hint}/b1"),
                                           self.ints([1], f"{hint}/b2")],
                          f"{hint}/batch", T=attr_type(np.int32), Index=attr_type(np.int32))
        return self.emit("ConcatV2", [batch, self.ints(rest, f"{hint}/rest"),
                                      self.ints(0, f"{hint}/axis")],
                         f"{hint}/target", N=attr_int(2), T=attr_type(np.int32),
                         Tidx=attr_type(np.int32))

    def _flatten(self, ins, a, hint) -> tuple[str, tuple]:
        if a.get("axis", 1) != 1:
            raise NotImplementedError("Flatten at an axis other than 1")
        x = self.layout(ins[0])
        return self.emit("Reshape", [x, self._batch_and(x, [-1], hint)], hint,
                         T=attr_type(np.float32), Tshape=attr_type(np.int32)), (0, 1)

    def _reshape(self, ins, hint) -> tuple[str, tuple]:
        shape = [int(d) for d in self.inits[ins[1]]]
        if 0 in shape[1:] or (shape[0] == 0 and -1 in shape):
            raise NotImplementedError(f"Reshape to {shape}")
        shape[0] = -1 if shape[0] == 0 else shape[0]
        y = self.emit("Reshape", [self.layout(ins[0]), self.ints(shape, f"{hint}/shape")],
                      hint, T=attr_type(np.float32), Tshape=attr_type(np.int32))
        return y, tuple(range(len(shape)))

    def _concat(self, ins, a, hint) -> tuple[str, tuple]:
        perms = {self.vals[i][1] for i in ins}
        if len(perms) == 1:
            perm, xs = perms.pop(), [self.vals[i][0] for i in ins]
        else:
            perm, xs = self._identity(ins[0]), [self.layout(i) for i in ins]
        axis = a.get("axis", 0) % len(perm)
        y = self.emit("ConcatV2", [*xs, self.ints(perm[axis], f"{hint}/axis")], hint,
                      N=attr_int(len(xs)), T=attr_type(np.float32), Tidx=attr_type(np.int32))
        return y, perm

    def _slice(self, ins, hint) -> tuple[str, tuple]:
        src, perm = self.vals[ins[0]]
        begin, end = [0] * len(perm), [0] * len(perm)
        mask = (1 << len(perm)) - 1
        axes = self.inits[ins[3]] if len(ins) > 3 else range(len(self.inits[ins[1]]))
        if len(ins) > 4 and np.any(self.inits[ins[4]] != 1):
            raise NotImplementedError("Slice with steps")
        for ax, s, e in zip(axes, self.inits[ins[1]], self.inits[ins[2]]):
            stored = perm[int(ax) % len(perm)]
            begin[stored], end[stored] = int(s), int(e)
            mask &= ~(1 << stored)
        y = self.emit("StridedSlice", [src, self.ints(begin, f"{hint}/begin"),
                                       self.ints(end, f"{hint}/end"),
                                       self.ints([1] * len(perm), f"{hint}/strides")],
                      hint, T=attr_type(np.float32), Index=attr_type(np.int32),
                      begin_mask=attr_int(mask), end_mask=attr_int(mask))
        return y, perm

    def _static_sizes(self, name: str) -> np.ndarray:
        """A Resize's output sizes: a constant, or the constant tail of the
        Concat that prepends the dynamic batch (``_resize_to``)."""
        if name in self.inits:
            return self.inits[name]
        node = self.producer[name]
        if node.op_type == "Concat" and node.inputs[-1] in self.inits:
            return self.inits[node.inputs[-1]]
        raise NotImplementedError("Resize with computed sizes")

    def _resize(self, ins, a, hint) -> tuple[str, tuple]:
        if a.get("mode") != "linear" or a.get("coordinate_transformation_mode") != "half_pixel":
            raise NotImplementedError("Resize other than linear / half_pixel")
        h, w = (int(v) for v in self._static_sizes(ins[3])[-2:])
        y = self.f32("ResizeBilinear", [self.layout(ins[0], NHWC), self.ints([h, w],
                                                                              f"{hint}/size")],
                     hint, align_corners=attr_bool(False), half_pixel_centers=attr_bool(True))
        return y, FROM_NHWC


# ----------------------------- public API -----------------------------

def export_saved_model(config, weights, out_dir: str) -> str:
    """Write a TF SavedModel directory (``saved_model.pb`` + an empty
    ``variables/``) of the float32 scoring graph of the model whose weights
    are ``weights`` (a port model or its reference-named state dict), with a
    dynamic batch axis; load it with ``tf.saved_model.load(out_dir)`` and
    call ``.signatures["serving_default"]``."""
    config = config if isinstance(config, Config) else normalize_config(config)
    graph = _build_graph(config, numpy_state_dict(weights)).g
    data = encode_saved_model(*_Translator(graph, config).run())
    os.makedirs(os.path.join(out_dir, "variables"), exist_ok=True)
    with open(os.path.join(out_dir, "saved_model.pb"), "wb") as fh:
        fh.write(data)
    return out_dir


def verify_saved_model(out_dir: str, config, weights, triplets=None, metadata=None,
                       device=None, rtol: float = DEFAULT_TOLERANCE["rtol"],
                       atol: float = DEFAULT_TOLERANCE["atol"],
                       report_path: str | None = None) -> dict:
    """Evaluate the artifact (numpy evaluator; TensorFlow's loaded signature
    too, when installed) against the port's float32 forward on ``device``
    at rtol 1e-4 / atol 1e-5.  Returns {'close', 'max_diff', 'n', 'rtol',
    'atol', 'artifact', 'runtime', 'reference', ...} and optionally writes
    it as JSON."""
    from .savedmodel_numpy import run_saved_model

    dev = resolve_device(device)
    feeds = {k: np.ascontiguousarray(v, dtype=np.float32)
             for k, v in (("image", triplets), ("metadata", metadata)) if v is not None}
    want = port_logits(config, weights, triplets, metadata, device=dev)
    got = run_saved_model(out_dir, feeds)["logits"]
    report = {
        "close": bool(np.allclose(got, want, rtol=rtol, atol=atol)),
        "max_diff": float(np.max(np.abs(got - want))) if want.size else 0.0,
        "n": int(want.size), "rtol": rtol, "atol": atol,
        "artifact": "tf_saved_model", "runtime": "btsbot_tpu_torch.interop.savedmodel_numpy",
        "reference": f"btsbot_tpu_torch float32 forward on {dev}",
    }
    try:
        import tensorflow as tf
    except ImportError:
        report["tensorflow"] = "not installed; verified with in-repo evaluator"
    else:
        signature = tf.saved_model.load(out_dir).signatures[SIGNATURE_KEY]
        tf_got = signature(**{k: tf.constant(v) for k, v in feeds.items()})["logits"].numpy()
        report["tensorflow_close"] = bool(np.allclose(tf_got, want, rtol=rtol, atol=atol))
        report["tensorflow_max_diff"] = float(np.max(np.abs(tf_got - want))) \
            if want.size else 0.0
    if report_path:
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=1)
    return report


def export_and_verify(config, weights, out_dir: str, triplets=None, metadata=None,
                      device=None) -> dict:
    """One call → artifact + verification report
    (``<out_dir>/verification.json``)."""
    export_saved_model(config, weights, out_dir)
    return verify_saved_model(out_dir, config, weights, triplets, metadata, device=device,
                              report_path=os.path.join(out_dir, "verification.json"))
