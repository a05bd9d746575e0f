"""The MBConv kernel's bound from shapes: each MBConv's middle (BatchNorm →
GELU → depthwise 3×3 → BatchNorm → GELU, one launch of
``csrc/mbconv_dw.cu`` in an eval-mode forward) reads its (rows, side, side,
mid) input map once, writes its (rows, ⌈side / s⌉, ⌈side / s⌉, mid) output
once, and reads its 9 taps a channel in the compute type and four float32
vectors a channel (the two BatchNorms' scale and shift), at the HBM rate.
Its 9 multiply-adds an output are far below what the card computes in that
time, so bytes alone bound it.

Nothing here imports the program, and the same work is reckoned whatever
implements it.
"""

from __future__ import annotations

from .counts import HBM_BYTES_PER_S, ITEM_BYTES
from .counts_maxvit import EXPAND


def mbconv_shapes(cfg: dict) -> list[tuple[int, int, int]]:
    """(input side, mid channels, stride) of every MBConv, in forward order:
    the stem halves the image, each stage's first block is stride 2 and
    expands the previous stage's width."""
    side, c_prev = cfg["image_size"] // 2, cfg["stem_width"]
    shapes = []
    for c, depth in zip(cfg["dims"], cfg["depths"]):
        for b in range(depth):
            c_in, stride = (c_prev, 2) if b == 0 else (c, 1)
            shapes.append((side, EXPAND * c_in, stride))
            side = (side - 1) // stride + 1
        c_prev = c
    return shapes


def mbconv_bytes(rows: int, side: int, mid: int, stride: int, item: int) -> float:
    """Bytes one launch moves at least on ``rows`` alerts."""
    out = (side - 1) // stride + 1
    maps = rows * (side * side + out * out) * mid * item
    return float(maps + 9 * mid * item + 4 * mid * 4)


def mbconv_bound_s(cfg: dict, rows: int, dtype: str) -> float:
    """Σ bound of one forward's MBConv launches at ``rows`` alerts."""
    return sum(mbconv_bytes(rows, side, mid, stride, ITEM_BYTES[dtype])
               for side, mid, stride in mbconv_shapes(cfg)) / HBM_BYTES_PER_S
