"""mm_MaxViT-over-MaxxViT's work arithmetic from shapes: the forward's
operations an alert, and the bounds of its stride-1 ConvNeXt-block launches
and of its strided depthwise convolutions.

Nothing here imports the program, and the same work is reckoned whatever
implements it.  Operations follow ``counts_maxvit``'s rule (a multiply-add
is 2; every convolution and product the algorithm needs: the stem's two
convs, each ConvNeXt half's depthwise 7×7 taps, its MLP and its shortcut's
1×1 conv, each attention half's qkv, two attention products and proj, each
MLP half's two products, the heads).  Normalisations, activations, γ,
residuals, softmax, pools and the resize are not counted; nor are the bias
tables' MLPs, which are made once a forward and not once an alert (22
tables of 225 × (2 + heads) × 512 multiply-adds, 68 MFLOP a forward).

The stage sides are ``counts_maxvit.stage_sides``'s: the stem halves the
input, each stage's first block halves again.  A stride-1 ConvNeXt half is
a ConvNeXt block (``counts.block_work``: its input read once, its output
written once, its parameters once; the 49 taps and both MLP products).  A
strided depthwise convolution reads its (rows, side, side, C_in) input
once, writes its (rows, side / 2, side / 2, C) output once and reads its
C · 49 taps and C biases once, at the HBM rate: its 49 multiply-adds an
output are far below what the card computes in that time.
"""

from __future__ import annotations

from . import counts
from .counts import HBM_BYTES_PER_S, ITEM_BYTES
from .counts_maxvit import HEAD_DIM, stage_sides

TAPS = 49


def stage_inputs(cfg: dict) -> list[int]:
    return [cfg["stem_width"][-1]] + list(cfg["dims"][:-1])


def block_shapes(cfg: dict) -> list[tuple[int, int]]:
    """(side, C) of every stride-1 ConvNeXt half, in forward order."""
    return [(side, c) for side, c, depth in zip(stage_sides(cfg), cfg["dims"], cfg["depths"])
            for _ in range(depth - 1)]


def blocks_bound_s(cfg: dict, rows: int, dtype: str) -> float:
    """Σ bound of one forward's stride-1 ConvNeXt-block launches at ``rows``
    alerts."""
    item = ITEM_BYTES[dtype]
    return sum(counts.bound_s(*counts.block_work(rows, side, c, cfg["mlp_ratio"] * c, item),
                              dtype) for side, c in block_shapes(cfg))


def strided_dw_shapes(cfg: dict) -> list[tuple[int, int, int]]:
    """(input side, C_in, C) of every strided depthwise convolution."""
    sides = [cfg["image_size"] // 2] + stage_sides(cfg)[:-1]
    return list(zip(sides, stage_inputs(cfg), cfg["dims"]))


def strided_dw_bytes(rows: int, side: int, c_in: int, c: int, item: int) -> float:
    """Bytes one strided depthwise convolution moves at least on ``rows``
    alerts."""
    out = side // 2
    return float(rows * (side * side * c_in + out * out * c) * item + (TAPS + 1) * c * item)


def strided_dw_bound_s(cfg: dict, rows: int, dtype: str) -> float:
    """Σ bound of one forward's strided depthwise convolutions at ``rows``
    alerts."""
    return sum(strided_dw_bytes(rows, side, c_in, c, ITEM_BYTES[dtype])
               for side, c_in, c in strided_dw_shapes(cfg)) / HBM_BYTES_PER_S


def forward_flops_per_alert(cfg: dict) -> float:
    """Operations of one alert's forward (module docstring)."""
    s0, (w0, w1), p, ratio = cfg["image_size"] // 2, cfg["stem_width"], cfg["window"], \
        cfg["mlp_ratio"]
    flops = 2.0 * s0 * s0 * w0 * 3 * 9 + 2.0 * s0 * s0 * w1 * w0 * 9
    side = s0
    for c_in0, c, depth in zip(stage_inputs(cfg), cfg["dims"], cfg["depths"]):
        for b in range(depth):
            c_in = c_in0 if b == 0 else c
            if b == 0:
                side //= 2
            tokens = side * side
            if c_in != c:
                flops += 2.0 * tokens * c_in * c                      # shortcut 1×1
            flops += 2.0 * tokens * c * TAPS                          # depthwise 7×7
            flops += 2 * 2.0 * tokens * c * ratio * c                 # the MLP's products
            per_half = (2.0 * tokens * c * 3 * c + 4.0 * tokens * p * p * c
                        + 2.0 * tokens * c * c + 2 * 2.0 * tokens * c * ratio * c)
            flops += 2 * per_half                                     # window and grid halves
    m = cfg["model"]
    n_meta, f1, f2 = len(m["metadata_cols"]), m["meta_fc1_neurons"], m["meta_fc2_neurons"]
    c1, c2 = m["comb_fc1_neurons"], m["comb_fc2_neurons"]
    flops += 2.0 * (n_meta * f1 + f1 * f2)
    flops += 2.0 * ((cfg["dims"][-1] + f2) * c1 + c1 * c2 + c2)
    return flops
