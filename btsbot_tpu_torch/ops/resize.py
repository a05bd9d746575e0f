"""Bilinear resize of NHWC images (port of btsbot_tpu.ops.resize).

The MaxViT models upsample 63×63 triplets to the backbone's native
resolution inside the forward.  ``jax.image.resize`` "linear" samples at
half-pixel positions, which is ``F.interpolate(mode="bilinear",
align_corners=False)`` without antialiasing; the interpolation runs on an
NCHW view of the NHWC batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, C) → (N, size, size, C); the identity at the target size."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    out = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)
