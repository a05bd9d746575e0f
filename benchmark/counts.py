"""The yardstick's work arithmetic: operations and bytes from shapes, and the
card's published peaks.

Frozen from ``chip_smoke.py`` at commit c3d034a (``HBM_BYTES_PER_S`` and
``PEAK_OPS`` at lines 247-253, ``_bound`` at 421-424, a block's work at
498-513).  Nothing here imports the program: a later change that replaces a
kernel cannot move the bound it is held to.

A block's work counts its input read once, its output written once and its
parameters read once (bytes), and its operations as the algorithm needs them
(a multiply-add is 2): the 49 depthwise taps of every output and both MLP
products.  LayerNorm, GELU, γ and the residual are not counted.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {
    "bfloat16": 989e12,            # dense bf16 tensor cores
    # float32 operands: the highest rate at which the card takes them (TF32
    # tensor cores); the CUDA cores' 67 would read over 100 % for a kernel
    # that computes its products as three TF32 products
    "float32": 495e12,
}
ITEM_BYTES = {"bfloat16": 2, "float32": 4}
TAPS = 49


def stage_sides(image_size: int, n_stages: int) -> list[int]:
    """Map side of each stage: a 4×4 / 4 stem, then a 2×2 / 2 downsample."""
    s = (image_size - 4) // 4 + 1
    sides = [s]
    for _ in range(n_stages - 1):
        s = (s - 2) // 2 + 1
        sides.append(s)
    return sides


def block_work(rows: int, side: int, c: int, hidden: int, item: int) -> tuple[float, float]:
    """(bytes, operations) of one ConvNeXt block on ``rows`` alerts."""
    m = rows * side * side
    params = TAPS * c + c + 2 * c + hidden * c + hidden + c * hidden + c + c
    bytes_moved = 2 * m * c * item + params * item
    ops = 2 * 2 * m * c * hidden + 2 * TAPS * m * c
    return float(bytes_moved), float(ops)


def bound_s(bytes_moved: float, ops: float, dtype: str) -> float:
    """The least time the card could take: bytes at HBM rate or operations
    at the type's peak, whichever is larger."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def blocks_bound_s(cfg: dict, rows: int, dtype: str) -> float:
    """Σ bound of one forward's block launches at ``rows`` alerts."""
    sides = stage_sides(cfg["image_size"], len(cfg["dims"]))
    total = 0.0
    for side, c, depth in zip(sides, cfg["dims"], cfg["depths"]):
        b, o = block_work(rows, side, c, cfg["mlp_ratio"] * c, ITEM_BYTES[dtype])
        total += depth * bound_s(b, o, dtype)
    return total


def forward_flops_per_alert(cfg: dict) -> float:
    """Operations of one alert's forward: the stem, the downsamples, every
    block's taps and products, the metadata branch and the fusion head."""
    dims, depths = cfg["dims"], cfg["depths"]
    sides = stage_sides(cfg["image_size"], len(dims))
    flops = 2.0 * sides[0] ** 2 * dims[0] * 4 * 4 * 3
    for s, (side, c, depth) in enumerate(zip(sides, dims, depths)):
        if s:
            flops += 2.0 * side ** 2 * c * 2 * 2 * dims[s - 1]
        _, ops = block_work(1, side, c, cfg["mlp_ratio"] * c, 1)
        flops += depth * ops
    m = cfg["model"]
    n_meta, f1, f2 = len(m["metadata_cols"]), m["meta_fc1_neurons"], m["meta_fc2_neurons"]
    head_norm = "LS" in m.get("train_data_version", "")
    n_img = dims[-1] * (1 if head_norm else sides[-1] ** 2)
    c1, c2 = m["comb_fc1_neurons"], m["comb_fc2_neurons"]
    flops += 2.0 * (n_meta * f1 + f1 * f2)
    flops += 2.0 * ((n_img + f2) * c1 + c1 * c2 + c2)
    return flops
