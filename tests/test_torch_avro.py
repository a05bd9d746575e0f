"""The port's Avro OCF codec (``btsbot_tpu_torch/data/avro.py``) against the
JAX package's (CPU, standard library only on both sides).

Records written by either codec read back identically with the other;
``write_ocf`` produces the same bytes under the ``null`` and ``deflate``
codecs; ``iter_ocf_stream`` yields the same records from a non-seekable
stream; ``synthetic_avro_ocf`` gives the same blob in both packages, but
for the second gzip writes into each cutout.
"""

import io
import time

import numpy as np
import pytest

from btsbot_tpu.data import avro as jax_avro
from btsbot_tpu.data.synthetic import synthetic_avro_ocf as jax_synthetic_avro_ocf
from btsbot_tpu_torch.data import avro
from btsbot_tpu_torch.data.synthetic import synthetic_avro_ocf

COMPLEX_SCHEMA = {
    "type": "record", "name": "Everything", "namespace": "test",
    "fields": [
        {"name": "s", "type": "string"},
        {"name": "i", "type": "int"},
        {"name": "l", "type": "long"},
        {"name": "f", "type": "float"},
        {"name": "d", "type": "double"},
        {"name": "b", "type": "boolean"},
        {"name": "raw", "type": "bytes"},
        {"name": "maybe", "type": ["null", "double"]},
        {"name": "arr", "type": {"type": "array", "items": "long"}},
        {"name": "m", "type": {"type": "map", "values": "string"}},
        {"name": "e", "type": {"type": "enum", "name": "Color",
                               "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "fx", "type": {"type": "fixed", "name": "Sync", "size": 4}},
        {"name": "nested", "type": {
            "type": "record", "name": "Inner",
            "fields": [{"name": "x", "type": "double"},
                       {"name": "again", "type": ["null", "Inner"]}]}},
        {"name": "inner2", "type": ["null", "Inner"]},
    ],
}


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        out.append({
            "s": f"héllo ζτφ {k}", "i": int(rng.integers(-2**31, 2**31)),
            "l": int(rng.integers(-2**62, 2**62)), "f": 1.5 * k,
            "d": float(rng.normal()), "b": bool(k % 2),
            "raw": bytes(rng.integers(0, 256, size=k % 7, dtype=np.uint8)),
            "maybe": None if k % 3 else float(rng.normal()),
            "arr": [int(v) for v in rng.integers(-2**40, 2**40, size=k % 4)],
            "m": {f"k{j}": str(j) for j in range(k % 3)},
            "e": ["RED", "GREEN", "BLUE"][k % 3], "fx": bytes([k % 256]) * 4,
            "nested": {"x": float(k), "again": {"x": -1.0, "again": None}},
            "inner2": None if k % 2 else {"x": 9.0, "again": None},
        })
    return out


def _ztf_records(n, seed=0):
    rng = np.random.default_rng(seed)
    cols = ["magpsf", "sgscore1", "ndethist"]
    return cols, [{"objectId": f"ZTF25x{k}", "candid": 10**12 + k,
                   "candidate": {c: float(rng.normal()) for c in cols},
                   "cutoutScience": {"fileName": f"{k}.fits.gz",
                                     "stampData": rng.bytes(50 + k)},
                   "cutoutTemplate": None,
                   "cutoutDifference": {"fileName": f"{k}d.fits.gz",
                                        "stampData": rng.bytes(3)}}
                  for k in range(n)]


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("block_records", [None, 1, 4])
def test_write_ocf_bytes_identical_to_jax(codec, block_records):
    records = _records(9)
    sync = bytes(range(16))
    got = avro.write_ocf(COMPLEX_SCHEMA, records, codec=codec, sync=sync,
                         block_records=block_records)
    want = jax_avro.write_ocf(COMPLEX_SCHEMA, records, codec=codec, sync=sync,
                              block_records=block_records)
    assert got == want


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_records_round_trip_both_ways(codec):
    records = _records(7, seed=1)
    schema_a, port_read_jax = avro.read_ocf(
        jax_avro.write_ocf(COMPLEX_SCHEMA, records, codec=codec))
    schema_b, jax_read_port = jax_avro.read_ocf(
        avro.write_ocf(COMPLEX_SCHEMA, records, codec=codec))
    assert port_read_jax == jax_read_port == records
    assert schema_a == schema_b


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_ztf_schema_and_iter_ocf_stream_match_jax(codec):
    cols, records = _ztf_records(11, seed=2)
    assert avro.ztf_alert_schema(cols) == jax_avro.ztf_alert_schema(cols)
    assert avro.ztf_alert_schema() == jax_avro.ztf_alert_schema()
    blob = avro.write_ocf(avro.ztf_alert_schema(cols), records, codec=codec,
                          block_records=3)

    class _OneWay(io.RawIOBase):
        """A non-seekable stream that hands out a few bytes a read."""
        def __init__(self, data):
            self._buf = io.BytesIO(data)

        def readable(self):
            return True

        def readinto(self, b):
            chunk = self._buf.read(min(len(b), 5))
            b[:len(chunk)] = chunk
            return len(chunk)

    got = list(avro.iter_ocf_stream(io.BufferedReader(_OneWay(blob))))
    want = list(jax_avro.iter_ocf_stream(io.BytesIO(blob)))
    assert got == want == records


def _stamps_without_mtime(blob):
    """The OCF header bytes and the decoded records, each gzip member of the
    cutouts with its MTIME field (bytes 4-7, the second it was written)
    zeroed: every other byte of the blob's content is kept."""
    buf = io.BytesIO(blob)
    avro._read_ocf_header(buf)
    header = blob[:buf.tell()]
    _, records = avro.read_ocf(blob)
    for rec in records:
        for key, cut in rec.items():
            if key.startswith("cutout"):
                stamp = cut["stampData"]
                assert stamp[:2] == b"\x1f\x8b"  # a gzip member
                cut["stampData"] = stamp[:4] + bytes(4) + stamp[8:]
    return header, records


@pytest.mark.parametrize("clock", ["real", "two_seconds"])
def test_synthetic_avro_ocf_matches_jax(clock, monkeypatch):
    """Both packages write the same archive.  gzip stamps each cutout with
    the current second, so the two blobs are compared without it;
    ``two_seconds`` puts the two calls on different seconds."""
    cols = ["magpsf", "sgscore1"]
    if clock == "two_seconds":
        monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    got = synthetic_avro_ocf(5, cols, seed=3, codec="deflate", block_records=2)
    if clock == "two_seconds":
        monkeypatch.setattr(time, "time", lambda: 1_700_000_001.0)
    want = jax_synthetic_avro_ocf(5, cols, seed=3, codec="deflate", block_records=2)
    assert _stamps_without_mtime(got) == _stamps_without_mtime(want)
    if clock == "two_seconds":
        assert got != want  # the case the raw comparison failed on
    _, records = avro.read_ocf(got)
    assert [r["candid"] for r in records] == list(range(5))


def test_corrupt_container_raises_in_both():
    blob = avro.write_ocf(COMPLEX_SCHEMA, _records(3), codec="deflate")
    bad = blob[:-20] + bytes(20)
    for read in (avro.read_ocf, jax_avro.read_ocf):
        with pytest.raises((ValueError, EOFError)):
            read(bad)
