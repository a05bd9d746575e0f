"""MaxViT checkpoints at another resolution, and the shortcut alias (port of
the numpy parts of btsbot_tpu.interop.maxvit_convert).

Every MaxViT parameter but the relative-position bias tables is
independent of the input resolution; a table has (2·P − 1)² rows for a
partition size P = resolution / 32.  ``retarget_state_dict`` resamples
every ``relative_position_bias_table`` of a reference-named state dict to
the window of a target model kind (align-corners bilinear in float64, the
adaptation timm applies), so a checkpoint trained at 224 loads into a
``maxvit_tiny_rw_160`` model.  ``SHORTCUT_ALIASES`` renames the MBConv
shortcut's ``shortcut.expand`` (a timm naming) to the port's
``shortcut.conv``.  ``adapt_state_dict`` applies both for the config that
will load the dict (``engine.checkpoint.load_model_checkpoint``,
``interop.hf.load_model_dir``).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from ..models.maxvit import DEFAULT_KIND, maxvit_window

SHORTCUT_ALIASES = {".shortcut.expand.": ".shortcut.conv."}
TABLE = "relative_position_bias_table"


def resize_rel_pos_table(table: np.ndarray, target_window: int) -> np.ndarray:
    """Bilinear-resample a ((2w−1)², heads) relative-position bias table to
    ((2·target_window − 1)², heads), align-corners (the biases at the
    extreme offsets are kept), in float64, returned in the table's type."""
    n, heads = table.shape
    src = int(round(np.sqrt(n)))
    dst = 2 * target_window - 1
    if src == dst:
        return table
    grid = table.reshape(src, src, heads).astype(np.float64)
    pos = np.linspace(0.0, src - 1.0, dst) if dst > 1 else np.zeros(1)
    i0 = np.clip(np.floor(pos).astype(int), 0, src - 1)
    i1 = np.clip(i0 + 1, 0, src - 1)
    f_row = (pos - i0)[:, None, None]
    rows = grid[i0] * (1 - f_row) + grid[i1] * f_row
    f_col = (pos - i0)[None, :, None]
    cols = rows[:, i0] * (1 - f_col) + rows[:, i1] * f_col
    return cols.reshape(dst * dst, heads).astype(table.dtype)


def retarget_model_kind(model_kind: str, resolution: int) -> str:
    """``maxvit_tiny_rw_224.sw_in1k`` → ``maxvit_tiny_rw_160.sw_in1k``.
    Raises for non-MaxViT kinds and for kinds that encode no resolution."""
    if "maxvit" not in model_kind.lower():
        raise ValueError(
            f"--retarget-resolution only applies to MaxViT model kinds, "
            f"got {model_kind!r}")
    new, n = re.subn(r"_(\d+)(?=\.|$)", f"_{resolution}", model_kind, count=1)
    if n == 0:
        raise ValueError(
            f"model kind {model_kind!r} does not encode a native resolution "
            "(expected a timm-style '_<res>' segment)")
    return new


def apply_shortcut_aliases(sd: Mapping) -> dict:
    out = {}
    for key, value in sd.items():
        for old, new in SHORTCUT_ALIASES.items():
            key = key.replace(old, new)
        out[key] = value
    return out


def retarget_state_dict(sd: Mapping, target_model_kind: str) -> dict:
    """``sd`` with every relative-position bias table resampled to the
    window of ``target_model_kind`` (other entries as they are; tensors stay
    tensors, arrays arrays)."""
    window = maxvit_window(target_model_kind)
    out = dict(sd)
    for key, value in sd.items():
        if key.endswith(TABLE):
            if isinstance(value, torch.Tensor):
                out[key] = torch.from_numpy(
                    resize_rel_pos_table(value.detach().cpu().numpy(), window))
            else:
                out[key] = resize_rel_pos_table(np.asarray(value), window)
    return out


def adapt_state_dict(config, sd: Mapping) -> dict:
    """A state dict made loadable by ``config``'s MaxViT / mm_MaxViT model:
    shortcut aliases applied and bias tables resampled to its window; other
    configs' dicts (or config None) pass through unchanged.  A fusion's
    MaxViT branch is adapted when it is loaded from its own run directory."""
    if config is None or config.get("model_name") not in ("MaxViT", "mm_MaxViT"):
        return dict(sd)
    return retarget_state_dict(apply_shortcut_aliases(sd),
                               config.get("model_kind", DEFAULT_KIND))
