"""Synthetic alert packets (port of btsbot_tpu.data.synthetic.synthetic_packets).

Packets have the shape ``AlertStreamScorer`` consumes:
``cutout{Science,Template,Difference}.stampData`` gzip+FITS blobs plus a
``candidate`` dict carrying the configured metadata columns.
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

from .fits import write_fits_image

CUTOUT_KEYS = ("cutoutScience", "cutoutTemplate", "cutoutDifference")


def synthetic_packets(n: int, meta_cols, seed: int = 0,
                      unique_stamps: bool = False) -> Iterator[dict]:
    """Yield n alert packets with gzip+FITS cutout blobs.

    unique_stamps=False reuses one encoded blob for speed (the decode does
    the same work per blob either way); True gives every packet its own
    pixels."""
    rng = np.random.default_rng(seed)

    def blob():
        return gzip.compress(write_fits_image(
            rng.normal(size=(63, 63)).astype(np.float32)))

    shared = None if unique_stamps else blob()
    for i in range(n):
        yield {
            "candid": i,
            "candidate": {c: float(rng.normal()) for c in meta_cols},
            **{k: {"stampData": shared if shared is not None else blob()}
               for k in CUTOUT_KEYS},
        }
