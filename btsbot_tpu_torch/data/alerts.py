"""Host-side stamp decode: gunzip + FITS-parse one cutout blob (the port's
copy of btsbot_tpu.data.alerts ``decode_stamp``).  The pure-Python fallback
of ``native.decode_stamps``, which pads what it returns."""

from __future__ import annotations

import gzip
import io

import numpy as np

from .fits import read_fits_image


def decode_stamp(stamp_data: bytes) -> np.ndarray:
    """Gunzip + FITS-parse one cutout's ``stampData`` blob → 2-D float32."""
    with gzip.open(io.BytesIO(stamp_data), "rb") as f:
        buf = f.read()
    return read_fits_image(buf).astype(np.float32)
