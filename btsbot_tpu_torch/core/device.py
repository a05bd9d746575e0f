"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU by
name.  There is no silent fallback: with no card and no explicit request,
``resolve_device`` raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA card; anything else is taken as given.

    Raises RuntimeError when CUDA is requested (explicitly or by default) and
    no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return dev
