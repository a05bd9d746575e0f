"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU by
name.  There is no silent fallback: with no card and no explicit request,
``resolve_device`` raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, mesh=None) -> torch.device:
    """``None`` means the current CUDA card (under a mesh this rank's,
    ``cuda:{LOCAL_RANK}``); anything else is taken as given.  Under a mesh a
    card becomes the process's current device (NCCL needs it).

    Raises RuntimeError when CUDA is requested (explicitly or by default) and
    no card is visible."""
    if device is None:
        device = mesh.device if mesh is not None else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    if mesh is not None and dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev
