"""Batched alert-triplet ingest on the device (port of btsbot_tpu.ops.preprocess).

Operates on (N, 63, 63, 3) NHWC stacks (science, template, difference on
the channel axis), with the JAX package's semantics:

* NaN/±inf cleanup as ``np.nan_to_num`` (nan → 0, ±inf → dtype max/min);
* per-cutout (per sample, per channel) L2 / Frobenius normalization;
* corruption: non-finite median of the raw cutout, an all-zero cutout after
  cleaning, or a float32 sum of squares that overflows (a few ±inf pixels
  survive the cleanup as ±3.4e38 and normalise to zeros in the reference);
* center crop + renormalise (``crop_triplets``) and the NaN-row filter of
  training (``nan_row_mask``).

``torch.nanmedian`` returns the lower of the two middle values for an even
count where ``jnp.nanmedian`` averages them; only the median's finiteness is
used, and a 63×63 cutout has an odd count.
"""

from __future__ import annotations

import torch


def clean_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """np.nan_to_num semantics: nan→0, +inf→dtype max, −inf→dtype min."""
    return torch.nan_to_num(x)


def l2_normalize_cutouts(triplets: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Divide each (sample, channel) cutout by its Frobenius norm where that
    norm exceeds ``eps``, else by 1 (a zero norm: an all-zero cutout,
    dropped by ``corrupt_mask``)."""
    norm = torch.sqrt(triplets.square().sum(dim=(1, 2), keepdim=True))
    return triplets / torch.where(norm > eps, norm, torch.ones_like(norm))


def corrupt_mask(raw_triplets: torch.Tensor) -> torch.Tensor:
    """(N,) bool: True where any cutout of the alert is corrupt.  The sums
    run in float32 whatever the input type, so the overflow test holds."""
    raw = raw_triplets.float()
    n, h, w, c = raw.shape
    med = torch.nanmedian(raw.reshape(n, h * w, c), dim=1).values  # (N, 3)
    bad_median = ~torch.isfinite(med)
    cleaned = clean_nonfinite(raw)
    all_zero = (cleaned == 0).all(dim=2).all(dim=1)
    bad_norm = ~torch.isfinite(cleaned.square().sum(dim=(1, 2)))
    return (bad_median | all_zero | bad_norm).any(dim=-1)


def preprocess_triplets(raw_triplets: torch.Tensor, normalize: bool = True):
    """Returns (processed triplets, drop mask) for raw (N, 63, 63, 3) cutouts,
    the batched equivalent of the reference's ``make_triplet``."""
    drop = corrupt_mask(raw_triplets)
    out = clean_nonfinite(raw_triplets)
    if normalize:
        out = l2_normalize_cutouts(out)
    return out, drop


def center_crop(triplets: torch.Tensor, crop_to_size: int) -> torch.Tensor:
    """Center crop on H/W with the reference's margin convention
    ``margin = (63 - size) // 2``."""
    margin = (triplets.shape[1] - crop_to_size) // 2
    return triplets[:, margin:margin + crop_to_size, margin:margin + crop_to_size, :]


def crop_triplets(triplets: torch.Tensor, crop_to_size: int) -> torch.Tensor:
    """Center crop each cutout, then renormalise it by its Frobenius norm."""
    return l2_normalize_cutouts(center_crop(triplets, crop_to_size))


def nan_row_mask(triplets: torch.Tensor) -> torch.Tensor:
    """(N,) bool: True where any pixel of the alert's triplet is NaN (the
    training-time row filter)."""
    return torch.isnan(triplets).flatten(1).any(dim=1)
