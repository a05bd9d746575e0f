"""Minimal FITS image I/O for ZTF cutout stamps.

ZTF alert ``stampData`` blobs are gzip-compressed single-HDU FITS files with
a small 2-D image (BITPIX −32, ≤63×63).  The reference depends on astropy
for this (reference alert_utils.py:4,144); this module
implements the needed subset of the FITS standard directly (2880-byte header
blocks of 80-char cards, big-endian data, BSCALE/BZERO) so the ingest path
has no heavyweight dependency.  The port's copy of btsbot_tpu.data.fits.
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPES = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


def _parse_header(buf: bytes) -> tuple[dict, int]:
    """Parse header cards until END; returns (header dict, data offset)."""
    header: dict[str, object] = {}
    offset = 0
    while True:
        if offset + BLOCK > len(buf):
            raise ValueError("FITS header: missing END card")
        block = buf[offset:offset + BLOCK]
        offset += BLOCK
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return header, offset
            if card[8:10] != "= ":
                continue
            value = card[10:].split("/")[0].strip()
            if value.startswith("'"):
                header[key] = value.strip("'").strip()
            elif value in ("T", "F"):
                header[key] = value == "T"
            else:
                try:
                    header[key] = int(value)
                except ValueError:
                    try:
                        header[key] = float(value)
                    except ValueError:
                        header[key] = value


def read_fits_image(buf: bytes) -> np.ndarray:
    """Primary-HDU image data as a native-endian float32/original-dtype
    array (NAXIS ≤ 2; applies BSCALE/BZERO)."""
    header, offset = _parse_header(buf)
    bitpix = int(header["BITPIX"])
    naxis = int(header["NAXIS"])
    if naxis == 0:
        return np.zeros((0,), np.float32)
    shape = tuple(int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
    dtype = _BITPIX_DTYPES[bitpix]
    count = int(np.prod(shape))
    data = np.frombuffer(buf, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape)
    bscale = header.get("BSCALE", 1)
    bzero = header.get("BZERO", 0)
    if bscale != 1 or bzero != 0:
        data = data * bscale + bzero
    return np.ascontiguousarray(
        data.astype(data.dtype.newbyteorder("=")))


def _card(key: str, value) -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
    elif isinstance(value, (int, np.integer)):
        v = str(int(value))
    elif isinstance(value, float):
        v = f"{value:.10G}"
    else:
        v = f"'{value}'"
    return f"{key:<8}= {v:>20}".ljust(CARD).encode("ascii")


def write_fits_image(arr: np.ndarray) -> bytes:
    """Serialize a 2-D array as a single-HDU FITS file (test/tool helper)."""
    arr = np.asarray(arr)
    dtype_to_bitpix = {np.dtype(np.float32): -32, np.dtype(np.float64): -64,
                       np.dtype(np.int16): 16, np.dtype(np.int32): 32,
                       np.dtype(np.int64): 64}
    bitpix = dtype_to_bitpix[arr.dtype]
    cards = [
        _card("SIMPLE", True),
        _card("BITPIX", bitpix),
        _card("NAXIS", arr.ndim),
    ]
    for i, n in enumerate(reversed(arr.shape)):
        cards.append(_card(f"NAXIS{i + 1}", n))
    cards.append(b"END".ljust(CARD))
    header = b"".join(cards)
    header += b" " * (-len(header) % BLOCK)
    data = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    data += b"\0" * (-len(data) % BLOCK)
    return header + data
