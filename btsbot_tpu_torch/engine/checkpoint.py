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

Under a mesh (``mesh=`` / the train state's) both files still hold whole
tensors under the reference names: every rank gathers its model group's
shards (parallel.sharding), rank 0 alone writes, and the ranks meet at a
barrier after the write.  So ``best_model.pth`` loads ``strict=True``
without a mesh (and in the JAX package), and ``restore_train_state``
re-shards what it reads for the mesh it restores into, whatever mesh
wrote it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..interop.maxvit_convert import adapt_state_dict
from ..parallel.sharding import (
    full_optimizer_state,
    full_state_dict,
    load_full_optimizer_state,
    load_full_state_dict,
)

BEST_MODEL = "best_model.pth"
LATEST = "latest.pt"


def _save(obj, path: str, mesh=None) -> None:
    """Write ``obj`` (rank 0 alone under a mesh, then a barrier)."""
    if mesh is None or mesh.rank == 0:
        tmp = path + ".tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        mesh.barrier()


def _cpu_state_dict(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in full_state_dict(model).items()}


def save_model_state_dict(path: str, model, mesh=None) -> None:
    _save(_cpu_state_dict(model), path, mesh)


def save_train_state(path: str, state, extra: dict) -> None:
    _save({
        "model": _cpu_state_dict(state.model),
        "optimizer": full_optimizer_state(state.optimizer, state.model),
        "step": state.step,
        "seed": state.seed,
        "generator": state.generator.get_state(),
        "extra": {k: np.asarray(v).tolist() for k, v in extra.items()},
    }, path, state.mesh)


def restore_train_state(path: str, state):
    """Load ``path`` into ``state`` in place, re-sharded for the state's
    mesh; returns (state, extra)."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    load_full_state_dict(state.model, ck["model"])
    load_full_optimizer_state(state.optimizer, state.model, ck["optimizer"])
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


def load_run_dir(model_dir: str) -> tuple:
    """(config, state dict) of a model directory, in the forms the JAX
    package's ``load_teacher`` accepts that the port can read: an HF-style
    snapshot (train_config.json + pytorch_model.bin), or a run directory of
    the port or of the reference trainer (train_config.json or report.json
    + best_model.pth).  The state dict is adapted to the config
    (``load_model_checkpoint``)."""
    import json

    from ..core.config import normalize_config

    cfg_path = os.path.join(model_dir, "train_config.json")
    report_path = os.path.join(model_dir, "report.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            config = normalize_config(json.load(f))
    elif os.path.isfile(report_path):
        from ..metrics.report import load_report_config
        config = normalize_config(load_report_config(model_dir))
    else:
        raise FileNotFoundError(
            f"{model_dir}: need train_config.json or report.json plus either "
            f"pytorch_model.bin (HF snapshot) or {BEST_MODEL} (a run of the "
            "port or of the reference trainer)")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.isfile(bin_path):
        return config, adapt_state_dict(config, load_torch_checkpoint(bin_path))
    return config, load_model_checkpoint(config, model_dir)
