"""Batched training augmentation on NHWC triplets (port of
btsbot_tpu.ops.augment).

The reference augments per sample on the host (RandomHorizontalFlip,
RandomVerticalFlip, a uniform right-angle rotation; reference
train.py:179-191, utils.py:45-48).  Here, as in the JAX package, the batch is
transformed on the device in the JAX order: a flip of W (axis 2), a flip of
H (axis 1), then a counter-clockwise ``rot90`` by k ∈ {0, 1, 2, 3} per
sample.  Images are square, so a right-angle rotation is exact.

* ``apply_augmentation`` applies given flip masks and rotation counts (the
  part held to the JAX package exactly);
* ``draw_augmentation`` draws them from an explicit ``torch.Generator``.
  JAX's key stream cannot be reproduced in torch; the train step seeds the
  generator from (seed, step), so a run is reproducible per seed.
"""

from __future__ import annotations

import torch


def apply_augmentation(images: torch.Tensor, h_flip=None, v_flip=None,
                       rot_k=None) -> torch.Tensor:
    """images (N, H, W, C); h_flip / v_flip (N,) bool masks, rot_k (N,)
    integers in [0, 4); None skips that transform."""
    def select(mask, changed, x):
        return torch.where(mask.reshape(-1, 1, 1, 1), changed, x)

    if h_flip is not None:
        images = select(h_flip, images.flip(2), images)
    if v_flip is not None:
        images = select(v_flip, images.flip(1), images)
    if rot_k is not None:
        out = images
        for k in (1, 2, 3):
            out = select(rot_k == k, torch.rot90(images, k, dims=(1, 2)), out)
        images = out
    return images


def draw_augmentation(generator: torch.Generator, n: int, device,
                      h_flip: bool = True, v_flip: bool = True, rot: bool = True):
    """(h_flip, v_flip, rot_k) for ``apply_augmentation``: each flip with
    probability 0.5, k uniform; None where the flag is off."""
    def coin():
        return torch.rand(n, generator=generator, device=device) < 0.5

    return (coin() if h_flip else None, coin() if v_flip else None,
            torch.randint(0, 4, (n,), generator=generator, device=device) if rot
            else None)


def augment_triplets(generator: torch.Generator, images: torch.Tensor,
                     h_flip: bool = True, v_flip: bool = True,
                     rot: bool = True) -> torch.Tensor:
    """Flags mirror the config keys ``data_aug_{h_flip,v_flip,rot}``."""
    return apply_augmentation(images, *draw_augmentation(
        generator, images.shape[0], images.device, h_flip, v_flip, rot))
