"""mm_MaxViT's work arithmetic from shapes: the forward's operations an
alert, and each partition-attention launch's bytes and operations.

Nothing here imports the program.  A multiply-add is 2 operations; the
operations are those the algorithm needs: every convolution (the stem's,
the MBConvs' 1×1, depthwise 3×3 and squeeze-excite, the shortcuts'),
every product (qkv, the attention's two, proj, the MLP's two, the heads).
Normalisations, activations, the bias adds, softmax, pools and the resize
are not counted.

A partition-attention launch (``csrc/partition_attention.cu``) on a
(rows, side, side, 3C) qkv map moves at least the map read once, its
(rows, side, side, C) output written once and the ((2P − 1)², C / 32)
bias table read once, and computes 4 · P² · C operations a token (its two
products, P² keys of 32 values for each of C / 32 heads).
"""

from __future__ import annotations

from .counts import HBM_BYTES_PER_S, ITEM_BYTES, PEAK_FLOPS

HEAD_DIM = 32
EXPAND = 4
SE_RATIO = 0.25


def stage_sides(cfg: dict) -> list[int]:
    """Map side of each stage: the stem halves the input, each stage's first
    MBConv halves again."""
    s = cfg["image_size"] // 2
    sides = []
    for _ in cfg["dims"]:
        s //= 2
        sides.append(s)
    return sides


def attention_work(rows: int, side: int, c: int, window: int, item: int) -> tuple[float, float]:
    """(bytes, operations) of one partition-attention launch."""
    tokens = rows * side * side
    table = (2 * window - 1) ** 2 * (c // HEAD_DIM)
    bytes_moved = (tokens * 3 * c + tokens * c + table) * item
    ops = 4.0 * window * window * c * tokens
    return float(bytes_moved), ops


def attention_bound_s(cfg: dict, rows: int, dtype: str) -> float:
    """Σ bound of one forward's partition-attention launches (a window and a
    grid launch a block) at ``rows`` alerts: bytes at HBM rate or operations
    at the type's peak, whichever is larger, a launch."""
    total = 0.0
    for side, c, depth in zip(stage_sides(cfg), cfg["dims"], cfg["depths"]):
        b, o = attention_work(rows, side, c, cfg["window"], ITEM_BYTES[dtype])
        total += 2 * depth * max(b / HBM_BYTES_PER_S, o / PEAK_FLOPS[dtype])
    return total


def forward_flops_per_alert(cfg: dict) -> float:
    """Operations of one alert's forward (module docstring)."""
    size, stem, p, ratio = cfg["image_size"], cfg["stem_width"], cfg["window"], cfg["mlp_ratio"]
    s0 = size // 2
    flops = 2.0 * s0 * s0 * stem * 3 * 9 + 2.0 * s0 * s0 * stem * stem * 9
    side, c_prev = s0, stem
    for c, depth in zip(cfg["dims"], cfg["depths"]):
        for b in range(depth):
            c_in, stride = (c_prev, 2) if b == 0 else (c, 1)
            out = side // stride
            mid, rd = EXPAND * c_in, max(1, int(c_in * SE_RATIO))
            flops += 2.0 * side * side * c_in * mid          # 1×1 expand, at the input side
            flops += 2.0 * out * out * mid * 9               # depthwise 3×3
            flops += 2.0 * (mid * rd + rd * mid)             # squeeze-excite
            flops += 2.0 * out * out * mid * c               # 1×1 project
            if stride == 2 or c_in != c:
                flops += 2.0 * out * out * c_in * c          # shortcut 1×1
            tokens = out * out
            per_half = (2.0 * tokens * c * 3 * c + 4.0 * tokens * p * p * c
                        + 2.0 * tokens * c * c + 2 * 2.0 * tokens * c * ratio * c)
            flops += 2 * per_half                            # window and grid halves
            side = out
        c_prev = c
    m = cfg["model"]
    n_meta, f1, f2 = len(m["metadata_cols"]), m["meta_fc1_neurons"], m["meta_fc2_neurons"]
    c1, c2 = m["comb_fc1_neurons"], m["comb_fc2_neurons"]
    flops += 2.0 * (n_meta * f1 + f1 * f2)
    flops += 2.0 * ((cfg["dims"][-1] + f2) * c1 + c1 * c2 + c2)
    return flops
