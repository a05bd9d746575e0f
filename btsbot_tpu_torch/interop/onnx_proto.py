"""Minimal ONNX protobuf writer/reader (no ``onnx`` / ``protobuf`` deps); a
copy of btsbot_tpu.interop.onnx_proto (pure Python) over ``protowire``.

The reference ships its models to brokers as ONNX graphs (its
``to_onnx.py``).  The ``onnx`` package is not a dependency of the port (the
card machine has none), so this module hand-encodes the stable
subset of the public ONNX schema (onnx/onnx.proto3, IR version 8 / opset 17)
in protobuf wire format: ModelProto, GraphProto, NodeProto, AttributeProto,
TensorProto, ValueInfoProto, TypeProto, TensorShapeProto,
OperatorSetIdProto.

The writer produces standard ``.onnx`` files loadable by onnxruntime /
netron / the ``onnx`` package; the reader parses the same subset back so the
in-repo numpy evaluator (interop/onnx_numpy.py) can execute emitted graphs
for cross-runtime verification without onnxruntime.

The wire format itself (varints, tags, length-delimited fields) is
``protowire``, shared with the TF SavedModel writer.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .protowire import fields as _fields
from .protowire import ff, fs, fv, read_varint as _read_varint, signed as _signed, tag as _tag

# ONNX TensorProto.DataType values (onnx.proto3)
F32, F64 = 1, 11
I32, I64 = 6, 7
BOOL = 9

NP_TO_ONNX = {np.dtype(np.float32): F32, np.dtype(np.float64): F64,
              np.dtype(np.int32): I32, np.dtype(np.int64): I64,
              np.dtype(np.bool_): BOOL}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# AttributeProto.AttributeType values
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR = 1, 2, 3, 4
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


# ----------------------------- message model -----------------------------

@dataclass
class Tensor:
    name: str
    array: np.ndarray

    def encode(self) -> bytes:
        a = np.ascontiguousarray(self.array)
        if a.dtype not in NP_TO_ONNX:
            raise TypeError(f"Unsupported tensor dtype {a.dtype}")
        out = b"".join(fv(1, d) for d in a.shape)     # dims
        out += fv(2, NP_TO_ONNX[a.dtype])             # data_type
        out += fs(8, self.name)                       # name
        out += fs(9, a.tobytes())                     # raw_data (little-endian)
        return out


@dataclass
class Attr:
    name: str
    value: Any

    def encode(self) -> bytes:
        out = fs(1, self.name)
        v = self.value
        if isinstance(v, bool):
            out += fv(3, int(v)) + fv(20, AT_INT)
        elif isinstance(v, int):
            out += fv(3, v) + fv(20, AT_INT)
        elif isinstance(v, float):
            out += ff(2, v) + fv(20, AT_FLOAT)
        elif isinstance(v, (str, bytes)):
            out += fs(4, v) + fv(20, AT_STRING)
        elif isinstance(v, Tensor):
            out += fs(5, v.encode()) + fv(20, AT_TENSOR)
        elif isinstance(v, (list, tuple)) and v and \
                all(isinstance(x, float) for x in v):
            out += b"".join(_tag(7, 5) + struct.pack("<f", x) for x in v)
            out += fv(20, AT_FLOATS)
        elif isinstance(v, (list, tuple)):
            if all(isinstance(x, (str, bytes)) for x in v):
                out += b"".join(fs(9, x) for x in v) + fv(20, AT_STRINGS)
            else:
                out += b"".join(fv(8, int(x)) for x in v) + fv(20, AT_INTS)
        else:
            raise TypeError(f"Unsupported attribute {self.name}={v!r}")
        return out


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any] = field(default_factory=dict)
    name: str = ""

    def encode(self) -> bytes:
        out = b"".join(fs(1, i) for i in self.inputs)
        out += b"".join(fs(2, o) for o in self.outputs)
        if self.name:
            out += fs(3, self.name)
        out += fs(4, self.op_type)
        out += b"".join(fs(5, Attr(k, v).encode())
                        for k, v in self.attrs.items())
        return out


def _value_info(name: str, shape, elem_type: int = F32) -> bytes:
    dims = b""
    for d in shape:
        if d is None or isinstance(d, str):
            dims += fs(1, fs(2, d if isinstance(d, str) else "batch"))
        else:
            dims += fs(1, fv(1, int(d)))
    tensor_type = fv(1, elem_type) + fs(2, dims)
    return fs(1, name) + fs(2, fs(1, tensor_type))


@dataclass
class Graph:
    name: str
    nodes: list[Node] = field(default_factory=list)
    initializers: list[Tensor] = field(default_factory=list)
    inputs: list[tuple] = field(default_factory=list)   # (name, shape, type)
    outputs: list[tuple] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b"".join(fs(1, n.encode()) for n in self.nodes)
        out += fs(2, self.name)
        out += b"".join(fs(5, t.encode()) for t in self.initializers)
        out += b"".join(fs(11, _value_info(*io)) for io in self.inputs)
        out += b"".join(fs(12, _value_info(*io)) for io in self.outputs)
        return out


def encode_model(graph: Graph, opset: int = 17, ir_version: int = 8,
                 producer: str = "btsbot-tpu") -> bytes:
    out = fv(1, ir_version)
    out += fs(2, producer)
    out += fs(7, graph.encode())
    out += fs(8, fs(1, "") + fv(2, opset))  # opset_import {domain:"", version}
    return out


# ----------------------------- decoding -----------------------------

def _decode_tensor(buf: bytes) -> Tensor:
    dims, dtype, name, raw = [], F32, "", b""
    float_data, int64_data = [], []
    for fno, wire, val in _fields(buf):
        if fno == 1:
            dims.append(val)
        elif fno == 2:
            dtype = val
        elif fno == 8:
            name = val.decode()
        elif fno == 9:
            raw = val
        elif fno == 4:
            float_data.extend(np.frombuffer(val, "<f4")) if wire == 2 \
                else float_data.append(val)
        elif fno == 7:
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                int64_data.append(v)
    np_dtype = ONNX_TO_NP[dtype]
    if raw:
        arr = np.frombuffer(raw, np_dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, np_dtype).reshape(dims)
    else:
        arr = np.asarray(int64_data, np_dtype).reshape(dims)
    return Tensor(name, arr)


def _decode_attr(buf: bytes) -> tuple[str, Any]:
    name, atype = "", None
    fvals: dict[int, Any] = {}
    ints, floats, strings = [], [], []
    for fno, wire, val in _fields(buf):
        if fno == 1:
            name = val.decode()
        elif fno == 20:
            atype = val
        elif fno == 8:
            ints.append(_signed(val))
        elif fno == 7:
            floats.append(val)
        elif fno == 9:
            strings.append(val.decode())
        else:
            fvals[fno] = val
    if atype == AT_INT:
        return name, _signed(fvals[3])
    if atype == AT_FLOAT:
        return name, fvals[2]
    if atype == AT_STRING:
        return name, fvals[4].decode()
    if atype == AT_TENSOR:
        return name, _decode_tensor(fvals[5])
    if atype == AT_INTS:
        return name, ints
    if atype == AT_FLOATS:
        return name, floats
    if atype == AT_STRINGS:
        return name, strings
    raise ValueError(f"Unsupported attribute type {atype} for {name}")


def _decode_node(buf: bytes) -> Node:
    node = Node("", [], [])
    for fno, _, val in _fields(buf):
        if fno == 1:
            node.inputs.append(val.decode())
        elif fno == 2:
            node.outputs.append(val.decode())
        elif fno == 3:
            node.name = val.decode()
        elif fno == 4:
            node.op_type = val.decode()
        elif fno == 5:
            k, v = _decode_attr(val)
            node.attrs[k] = v
    return node


def _decode_value_info(buf: bytes) -> tuple[str, list, int]:
    name, shape, elem = "", [], F32
    for fno, _, val in _fields(buf):
        if fno == 1:
            name = val.decode()
        elif fno == 2:
            for f2, _, tt in _fields(val):
                if f2 != 1:
                    continue
                for f3, _, v3 in _fields(tt):
                    if f3 == 1:
                        elem = v3
                    elif f3 == 2:
                        for f4, _, dim in _fields(v3):
                            if f4 != 1:
                                continue
                            dv: Any = None
                            for f5, _, v5 in _fields(dim):
                                if f5 == 1:
                                    dv = v5
                                elif f5 == 2:
                                    dv = v5.decode()
                            shape.append(dv)
    return name, shape, elem


def decode_model(buf: bytes) -> Graph:
    """Parse a .onnx file (the subset this module writes) into a Graph."""
    graph_buf = None
    for fno, _, val in _fields(buf):
        if fno == 7:
            graph_buf = val
    if graph_buf is None:
        raise ValueError("No graph in model")
    g = Graph("")
    for fno, _, val in _fields(graph_buf):
        if fno == 1:
            g.nodes.append(_decode_node(val))
        elif fno == 2:
            g.name = val.decode()
        elif fno == 5:
            g.initializers.append(_decode_tensor(val))
        elif fno == 11:
            g.inputs.append(_decode_value_info(val))
        elif fno == 12:
            g.outputs.append(_decode_value_info(val))
    return g
