"""Dependency-free Avro Object Container File codec for ZTF alert packets.

A copy of ``btsbot_tpu/data/avro.py`` (standard library only), kept in the
port so that it imports nothing of the JAX package.

The production wire format of the broker path is Avro OCF: ZTF distributes
each alert as a single-record container file (magic ``Obj\\x01``, schema
embedded in the header — the packets `alert_utils.py:110-196` consumes after
the broker's own deserialization).  The reference never decodes these itself
(Kowalski does); the serving daemon here scores straight off the broker, so
the wire format must be decodable in-repo.  ``fastavro`` is not a baked-in
dependency — like the ONNX path (interop/onnx_proto.py), the format is
small enough to implement directly from the spec, which also gives an
encoder for fixtures and archival sinks.

Supports the full type surface the ZTF alert schema uses: records, unions,
arrays, maps, enums, fixed, all primitives, named-type references, and the
``null``/``deflate`` codecs.  Spec: Apache Avro 1.11 binary encoding + OCF.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, Iterator

OCF_MAGIC = b"Obj\x01"
_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double",
               "bytes", "string"}


# ----------------------------- primitives ---------------------------------

def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_long(buf: io.BytesIO, n: int) -> None:
    n = _zigzag_encode(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes((b | 0x80,)))
        else:
            buf.write(bytes((b,)))
            return


def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        raw = buf.read(1)
        if not raw:
            raise EOFError("truncated Avro varint")
        b = raw[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(acc)
        shift += 7
        if shift > 70:
            raise ValueError("Avro varint too long")


def _read_exact(buf: io.BytesIO, n: int) -> bytes:
    data = buf.read(n)
    if len(data) != n:
        raise EOFError(f"truncated Avro data: wanted {n}, got {len(data)}")
    return data


# ------------------------------- schema -----------------------------------

def _resolve(schema, names: dict):
    """Normalize a schema node; register/resolve named types."""
    if isinstance(schema, str):
        if schema in _PRIMITIVES:
            return schema
        if schema in names:
            return names[schema]
        raise ValueError(f"unknown Avro type reference {schema!r}")
    if isinstance(schema, list):  # union
        return ["union", [_resolve(s, names) for s in schema]]
    if isinstance(schema, dict):
        t = schema["type"]
        if t in _PRIMITIVES and len(schema) == 1:
            return t
        if t in ("record", "error"):
            name = schema.get("name", "")
            full = _fullname(name, schema.get("namespace"))
            node = ["record", full, []]
            names[full] = node
            if name:
                names.setdefault(name, node)
            node[2] = [(f["name"], _resolve(f["type"], names))
                       for f in schema["fields"]]
            return node
        if t == "enum":
            full = _fullname(schema["name"], schema.get("namespace"))
            node = ["enum", full, list(schema["symbols"])]
            names[full] = node
            names.setdefault(schema["name"], node)
            return node
        if t == "fixed":
            full = _fullname(schema["name"], schema.get("namespace"))
            node = ["fixed", full, int(schema["size"])]
            names[full] = node
            names.setdefault(schema["name"], node)
            return node
        if t == "array":
            return ["array", _resolve(schema["items"], names)]
        if t == "map":
            return ["map", _resolve(schema["values"], names)]
        if t in _PRIMITIVES:  # e.g. {"type": "int", "doc": ...}
            return t
        if isinstance(t, (list, dict)):
            return _resolve(t, names)
    raise ValueError(f"unsupported Avro schema node: {schema!r}")


def _fullname(name: str, namespace) -> str:
    if "." in name or not namespace:
        return name
    return f"{namespace}.{name}"


def parse_schema(schema: str | dict | list):
    """Parse a JSON Avro schema into the internal resolved form."""
    if isinstance(schema, str):
        schema = json.loads(schema)
    return _resolve(schema, {})


# ------------------------------- decode -----------------------------------

def _decode(buf: io.BytesIO, schema) -> Any:
    if isinstance(schema, str):
        if schema == "null":
            return None
        if schema == "boolean":
            return _read_exact(buf, 1) != b"\x00"
        if schema in ("int", "long"):
            return _read_long(buf)
        if schema == "float":
            return struct.unpack("<f", _read_exact(buf, 4))[0]
        if schema == "double":
            return struct.unpack("<d", _read_exact(buf, 8))[0]
        if schema == "bytes":
            return _read_exact(buf, _read_long(buf))
        if schema == "string":
            return _read_exact(buf, _read_long(buf)).decode("utf-8")
        raise ValueError(schema)
    tag = schema[0]
    if tag == "record":
        return {name: _decode(buf, s) for name, s in schema[2]}
    if tag == "union":
        return _decode(buf, schema[1][_read_long(buf)])
    if tag == "array":
        out = []
        while True:
            count = _read_long(buf)
            if count == 0:
                return out
            if count < 0:
                count = -count
                _read_long(buf)  # block byte size (skippable framing)
            out.extend(_decode(buf, schema[1]) for _ in range(count))
    if tag == "map":
        out = {}
        while True:
            count = _read_long(buf)
            if count == 0:
                return out
            if count < 0:
                count = -count
                _read_long(buf)
            for _ in range(count):
                key = _read_exact(buf, _read_long(buf)).decode("utf-8")
                out[key] = _decode(buf, schema[1])
    if tag == "enum":
        return schema[2][_read_long(buf)]
    if tag == "fixed":
        return _read_exact(buf, schema[2])
    raise ValueError(f"cannot decode Avro type {tag}")


# ------------------------------- encode -----------------------------------

def _union_branch(schemas, value) -> int:
    """Pick the union branch for a Python value (ZTF unions are
    [null, X] — keep matching simple and deterministic)."""
    for i, s in enumerate(schemas):
        if value is None and s == "null":
            return i
        if value is not None and s != "null":
            if isinstance(value, bool):
                if s == "boolean":
                    return i
                continue
            if isinstance(value, int) and s in ("int", "long"):
                return i
            if isinstance(value, (int, float)) and s in ("float", "double"):
                # a Python int fits a float/double branch too (spec-legal
                # promotion) — ZTF candidate unions are [null, double] but
                # JSON-decoded counts arrive as ints
                return i
            if isinstance(value, float) and s in ("int", "long"):
                # only a lossless demotion may take the int branch; a
                # fractional float must NOT be silently truncated by the
                # int encoder — fall through to the no-branch error
                if value.is_integer():
                    return i
                continue
            if isinstance(value, str) and (s == "string"
                                           or (isinstance(s, list)
                                               and s[0] == "enum")):
                return i
            if isinstance(value, (bytes, bytearray)) and (
                    s == "bytes" or (isinstance(s, list) and s[0] == "fixed")):
                return i
            if isinstance(value, dict) and isinstance(s, list) \
                    and s[0] in ("record", "map"):
                return i
            if isinstance(value, (list, tuple)) and isinstance(s, list) \
                    and s[0] == "array":
                return i
    raise ValueError(f"no union branch for {type(value).__name__} "
                     f"in {schemas!r}")


def _encode(buf: io.BytesIO, schema, value) -> None:
    if isinstance(schema, str):
        if schema == "null":
            return
        if schema == "boolean":
            buf.write(b"\x01" if value else b"\x00")
        elif schema in ("int", "long"):
            _write_long(buf, int(value))
        elif schema == "float":
            buf.write(struct.pack("<f", float(value)))
        elif schema == "double":
            buf.write(struct.pack("<d", float(value)))
        elif schema == "bytes":
            _write_long(buf, len(value))
            buf.write(bytes(value))
        elif schema == "string":
            raw = value.encode("utf-8")
            _write_long(buf, len(raw))
            buf.write(raw)
        else:
            raise ValueError(schema)
        return
    tag = schema[0]
    if tag == "record":
        for name, s in schema[2]:
            _encode(buf, s, value.get(name) if isinstance(value, dict)
                    else getattr(value, name))
    elif tag == "union":
        i = _union_branch(schema[1], value)
        _write_long(buf, i)
        _encode(buf, schema[1][i], value)
    elif tag == "array":
        if value:
            _write_long(buf, len(value))
            for item in value:
                _encode(buf, schema[1], item)
        _write_long(buf, 0)
    elif tag == "map":
        if value:
            _write_long(buf, len(value))
            for k, v in value.items():
                raw = k.encode("utf-8")
                _write_long(buf, len(raw))
                buf.write(raw)
                _encode(buf, schema[1], v)
        _write_long(buf, 0)
    elif tag == "enum":
        _write_long(buf, schema[2].index(value))
    elif tag == "fixed":
        if len(value) != schema[2]:
            raise ValueError(f"fixed size mismatch: {len(value)} != "
                             f"{schema[2]}")
        buf.write(bytes(value))
    else:
        raise ValueError(f"cannot encode Avro type {tag}")


# ----------------------------- container file -----------------------------

def _read_ocf_header(buf) -> tuple[dict, list, str, bytes]:
    """Parse magic + metadata map + sync: (schema_json, schema, codec, sync)."""
    if _read_exact(buf, 4) != OCF_MAGIC:
        raise ValueError("not an Avro object container file (bad magic)")
    meta_schema = parse_schema({"type": "map", "values": "bytes"})
    meta = _decode(buf, meta_schema)
    if "avro.schema" not in meta:
        raise ValueError("OCF header missing avro.schema metadata")
    schema_json = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported Avro codec {codec!r}")
    sync = _read_exact(buf, 16)
    return schema_json, parse_schema(schema_json), codec, sync


def _iter_ocf_records(buf, schema, codec: str, sync: bytes) -> Iterator[dict]:
    """Yield records one data block at a time (peak memory = one block).
    EOF is probed with a single-byte read so non-seekable sources (e.g.
    ``tarfile.extractfile`` streams) work."""
    while True:
        head = buf.read(1)
        if not head:
            return  # clean EOF between blocks
        # finish the count varint whose first byte is `head`
        shift, acc = 0, 0
        b = head[0]
        while True:
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 70:
                raise ValueError("Avro varint too long")
            b = _read_exact(buf, 1)[0]
        count = _zigzag_decode(acc)
        size = _read_long(buf)
        block = _read_exact(buf, size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bbuf = io.BytesIO(block)
        for _ in range(count):
            yield _decode(bbuf, schema)
        if _read_exact(buf, 16) != sync:
            raise ValueError("Avro block sync marker mismatch")


def read_ocf(data: bytes) -> tuple[dict, list]:
    """Decode an Avro OCF: returns (schema_json_dict, records)."""
    buf = io.BytesIO(data)
    schema_json, schema, codec, sync = _read_ocf_header(buf)
    return schema_json, list(_iter_ocf_records(buf, schema, codec, sync))


def write_ocf(schema: str | dict, records: list, codec: str = "null",
              sync: bytes = b"\x00" * 16,
              block_records: int | None = None) -> bytes:
    """Encode records into an Avro OCF.  ``block_records`` caps records per
    data block (default: one block holds everything — the single-alert
    broker message shape)."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported Avro codec {codec!r}")
    if len(sync) != 16:
        raise ValueError("sync marker must be 16 bytes")
    schema_json = schema if isinstance(schema, str) else json.dumps(schema)
    parsed = parse_schema(schema_json)

    out = io.BytesIO()
    out.write(OCF_MAGIC)
    meta_schema = parse_schema({"type": "map", "values": "bytes"})
    _encode(out, meta_schema, {
        "avro.schema": schema_json.encode("utf-8"),
        "avro.codec": codec.encode("utf-8"),
    })
    out.write(sync)

    step = block_records or max(1, len(records))
    for start in range(0, len(records), step):
        chunk = records[start:start + step]
        body = io.BytesIO()
        for rec in chunk:
            _encode(body, parsed, rec)
        payload = body.getvalue()
        if codec == "deflate":
            payload = zlib.compress(payload)[2:-4]  # raw deflate per spec
        _write_long(out, len(chunk))
        _write_long(out, len(payload))
        out.write(payload)
        out.write(sync)
    return out.getvalue()


def iter_ocf_stream(fileobj) -> Iterator[dict]:
    """Stream records from a file-like OCF source (archival tarballs of
    nightly alerts) incrementally: only the header and one data block are
    ever resident, so multi-GB nightly files don't load into memory.  Works
    on non-seekable sources (``tarfile.extractfile`` streams)."""
    _, schema, codec, sync = _read_ocf_header(fileobj)
    yield from _iter_ocf_records(fileobj, schema, codec, sync)


# --------------------------- ZTF alert schema -----------------------------

PROD_METADATA_FIELDS = [
    "sgscore1", "distpsnr1", "sgscore2", "distpsnr2", "fwhm", "magpsf",
    "sigmapsf", "chipsf", "ra", "dec", "diffmaglim", "ndethist", "nmtchps",
    "age", "days_since_peak", "days_to_peak", "peakmag_so_far", "new_drb",
    "ncovhist", "nnotdet", "chinr", "sharpnr", "scorr", "sky",
    "maxmag_so_far",
]


def ztf_alert_schema(metadata_fields=None) -> dict:
    """The subset of the ZTF alert schema the scorer consumes
    (alert_utils.py:110-196: three gzip-FITS cutout blobs + the candidate
    metadata record).  ``metadata_fields`` defaults to the 25 production
    columns; pass the config's metadata_cols to match a custom model."""
    fields = list(metadata_fields or PROD_METADATA_FIELDS)
    cutout = {
        "type": "record", "name": "Cutout",
        "namespace": "ztf.alert",
        "fields": [
            {"name": "fileName", "type": "string"},
            {"name": "stampData", "type": "bytes"},
        ],
    }
    return {
        "type": "record", "name": "alert", "namespace": "ztf",
        "fields": [
            {"name": "objectId", "type": "string"},
            {"name": "candid", "type": "long"},
            {"name": "candidate", "type": {
                "type": "record", "name": "Candidate",
                "namespace": "ztf.alert",
                "fields": [{"name": f, "type": ["null", "double"],
                            "default": None} for f in fields],
            }},
            {"name": "cutoutScience", "type": ["null", cutout],
             "default": None},
            {"name": "cutoutTemplate", "type": ["null", "ztf.alert.Cutout"],
             "default": None},
            {"name": "cutoutDifference", "type": ["null", "ztf.alert.Cutout"],
             "default": None},
        ],
    }
