"""Protobuf wire format, hand-encoded (no ``protobuf`` dependency): the
helpers that the ONNX writer (``onnx_proto``) and the TF SavedModel writer
(``savedmodel``) share, and the reader their evaluators parse files with.

Every field is ``tag || payload`` where ``tag = (field_number << 3) |
wire_type``; wire types used here are 0 (varint), 1 (64-bit), 2
(length-delimited: strings, sub-messages, packed arrays) and 5 (32-bit).
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

# ----------------------------- encoding -----------------------------


def varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # protobuf encodes negatives as 10-byte two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def tag(fieldno: int, wire: int) -> bytes:
    return varint((fieldno << 3) | wire)


def fv(fieldno: int, n: int) -> bytes:
    """varint field"""
    return tag(fieldno, 0) + varint(int(n))


def fs(fieldno: int, data: bytes | str) -> bytes:
    """length-delimited field (string / bytes / sub-message)"""
    if isinstance(data, str):
        data = data.encode()
    return tag(fieldno, 2) + varint(len(data)) + data


def ff(fieldno: int, x: float) -> bytes:
    """32-bit float field"""
    return tag(fieldno, 5) + struct.pack("<f", float(x))


def map_entry(fieldno: int, key: str, value: bytes) -> bytes:
    """One entry of a ``map<string, Message>`` field."""
    return fs(fieldno, fs(1, key) + fs(2, value))


# ----------------------------- decoding -----------------------------


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message payload."""
    pos = 0
    while pos < len(buf):
        t, pos = read_varint(buf, pos)
        fieldno, wire = t >> 3, t & 7
        if wire == 0:
            val, pos = read_varint(buf, pos)
        elif wire == 2:
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            val = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"Unsupported wire type {wire}")
        yield fieldno, wire, val


def signed(v: int) -> int:
    """Recover a negative int64 from its unsigned varint encoding."""
    return v - (1 << 64) if v >= (1 << 63) else v


def packed_varints(buf: bytes) -> list[int]:
    """The signed values of a packed repeated varint field."""
    out, pos = [], 0
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(signed(v))
    return out


def read_map_entry(buf: bytes) -> tuple[str, bytes]:
    """(key, value) of one ``map<string, Message>`` entry."""
    key, value = "", b""
    for fno, _, val in fields(buf):
        if fno == 1:
            key = val.decode()
        elif fno == 2:
            value = val
    return key, value
