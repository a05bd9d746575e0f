"""Checkpoints with full resume (port of btsbot_tpu.engine.checkpoint).

The JAX package writes orbax directories, which the port cannot read or
write without JAX.  The port writes the reference's convention instead:

    <model_dir>/report.json       — training report (metrics.report)
    <model_dir>/best_model.pth    — best-model state dict, reference names
                                    (reference train.py:337-340)
    <model_dir>/latest.pt         — resume state: model state dict,
                                    optimizer state, update count, seed,
                                    generator state and the loop's extras

The JAX package's ``load_model_checkpoint`` reads ``best_model.pth``, so a
run directory of the port loads there too.  A MaxViT checkpoint is adapted
to the config that loads it (``interop.maxvit_convert.adapt_state_dict``:
the bias tables resampled to its resolution), as the JAX package converts
it.  Files are written to a temporary name and renamed, so an interrupted
save leaves the last one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..interop.maxvit_convert import adapt_state_dict

BEST_MODEL = "best_model.pth"
LATEST = "latest.pt"


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state_dict(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def save_model_state_dict(path: str, model) -> None:
    _save(_cpu_state_dict(model), path)


def save_train_state(path: str, state, extra: dict) -> None:
    _save({
        "model": _cpu_state_dict(state.model),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "seed": state.seed,
        "generator": state.generator.get_state(),
        "extra": {k: np.asarray(v).tolist() for k, v in extra.items()},
    }, path)


def restore_train_state(path: str, state):
    """Load ``path`` into ``state`` in place; returns (state, extra)."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ck["model"])
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    state.seed = int(ck["seed"])
    state.generator.set_state(ck["generator"])
    return state, ck["extra"]


def load_model_checkpoint(config, model_dir: str) -> dict:
    """The best model's reference-named state dict (CPU tensors) from a run
    directory of the port or of the reference trainer (a ``module.``
    prefix from DataParallel is dropped), adapted to ``config``'s model
    (a MaxViT's bias tables resampled to its resolution; None: as saved)."""
    path = os.path.join(model_dir, BEST_MODEL)
    if not os.path.isfile(path):
        hint = (" (its best/ directory is an orbax checkpoint of the JAX "
                "package, which the port cannot read)"
                if os.path.isdir(os.path.join(model_dir, "best")) else "")
        raise FileNotFoundError(f"No {BEST_MODEL} in {model_dir}{hint}")
    return adapt_state_dict(config, load_torch_checkpoint(path))


def load_torch_checkpoint(path: str) -> dict:
    """A ``.pth`` / ``.bin`` state dict as CPU tensors (a ``module.``
    prefix from DataParallel dropped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd
