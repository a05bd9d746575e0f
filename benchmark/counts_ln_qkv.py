"""The LN-qkv kernel's bound from shapes: each attention half of an
mm_MaxViT forward (a window and a grid half a block) launches
``csrc/ln_qkv.cu`` once on its (rows, side, side, C) map: qkv = LN1(x) ·
Wqkvᵀ + b.  A launch reads x once, writes the (rows, side, side, 3C) qkv
map once, and reads Wqkv (3C, C), its bias (3C) and the LayerNorm's γ and β
(C each) once, in the compute type, at the HBM rate; it computes 6 · C²
operations a token (the product, a multiply-add 2).  The LayerNorm's own
arithmetic is not counted.  A launch's bound is the larger of the two.

Nothing here imports the program, and the same work is reckoned whatever
implements it.
"""

from __future__ import annotations

from .counts import HBM_BYTES_PER_S, ITEM_BYTES, PEAK_FLOPS
from .counts_maxvit import stage_sides


def ln_qkv_shapes(cfg: dict) -> list[tuple[int, int]]:
    """(side, C) of every LN-qkv launch, in forward order: two a block."""
    return [(side, c) for side, c, depth in zip(stage_sides(cfg), cfg["dims"], cfg["depths"])
            for _ in range(2 * depth)]


def ln_qkv_work(rows: int, side: int, c: int, item: int) -> tuple[float, float]:
    """(bytes, operations) of one launch on ``rows`` alerts."""
    tokens = rows * side * side
    params = 3 * c * c + 3 * c + 2 * c
    return float((tokens * (c + 3 * c) + params) * item), 6.0 * c * c * tokens


def ln_qkv_bound_s(cfg: dict, rows: int, dtype: str) -> float:
    """Σ bound of one forward's LN-qkv launches at ``rows`` alerts."""
    total = 0.0
    for side, c in ln_qkv_shapes(cfg):
        b, o = ln_qkv_work(rows, side, c, ITEM_BYTES[dtype])
        total += max(b / HBM_BYTES_PER_S, o / PEAK_FLOPS[dtype])
    return total
