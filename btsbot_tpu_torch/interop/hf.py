"""HuggingFace Hub snapshots with the reference's API (port of
btsbot_tpu.interop.hf).

The published BTSbot models are ``nabeelr/BTSbot-{arch}-{pretrain}[-metadata]``
repositories holding ``train_config.json`` + ``pytorch_model.bin`` (a
reference-named state dict).  The port's modules carry those names, so a
snapshot loads with ``strict=True`` and no converter:

    model, config = load_model_dir("models/BTSbot-convnext-pico-in1k-metadata")
    model, config = load_HF_model("convnext", True, "imagenet")  # models/<name>

``load_HF_model`` downloads only when the local snapshot is missing
(``download_HF_model``: ``huggingface_hub`` imported there, network needed);
offline, put the two files under ``models/<repo name>`` or call
``load_model_dir`` on any directory holding them.  MaxViT and the
``inceptionnext`` serving variant are not ported yet (ROADMAP Queue A item 7
and "What waits" item 1) and raise ``NotImplementedError`` before any
download.
"""

from __future__ import annotations

import json
import os

import torch

from ..core.config import normalize_config
from ..engine.checkpoint import load_torch_checkpoint
from ..models.factory import build_model

CONFIG_FILE = "train_config.json"
WEIGHTS_FILE = "pytorch_model.bin"
_NOT_PORTED = {
    "maxvit": "ROADMAP Queue A item 7 (MaxViT, the next slice)",
    "inceptionnext": "ROADMAP \"What waits\" item 1 (InceptionMixer)",
}


def validate_model_params(architecture: str, multi_modal: bool, pretrain: str):
    if architecture == "convnext":
        architecture = "convnext-pico"
    elif architecture == "maxvit":
        architecture = "maxvit-tiny"
    elif architecture == "inceptionnext":
        # the JAX package's own serving variant (no such repo upstream)
        architecture = "inceptionnext-pico"
    else:
        raise ValueError(f"Invalid architecture: {architecture}")
    if pretrain == "imagenet":
        pretrain = "in1k"
    elif pretrain not in ("galaxyzoo", "randinit"):
        raise ValueError(f"Invalid pre-training regimen: {pretrain}")
    return architecture, multi_modal, pretrain


def get_HF_model_link(architecture: str, multi_modal: bool, pretrain: str) -> str:
    architecture, multi_modal, pretrain = validate_model_params(
        architecture, multi_modal, pretrain)
    return ("nabeelr/BTSbot-" + architecture + "-" + pretrain
            + ("-metadata" if multi_modal else ""))


def get_local_model_dir(architecture: str, multi_modal: bool, pretrain: str,
                        models_root: str = "models") -> str:
    link = get_HF_model_link(architecture, multi_modal, pretrain)
    return os.path.join(models_root, link.split("/")[-1])


def download_HF_model(architecture: str, multi_modal: bool, pretrain: str,
                      models_root: str = "models") -> str:
    """Snapshot-download the model repo (needs network and huggingface_hub)."""
    from huggingface_hub import snapshot_download

    link = get_HF_model_link(architecture, multi_modal, pretrain)
    model_dir = get_local_model_dir(architecture, multi_modal, pretrain, models_root)
    os.makedirs(model_dir, exist_ok=True)
    snapshot_download(repo_id=link, local_dir=model_dir)
    return model_dir


def load_model_dir(model_dir: str, dtype=torch.float32, device=None):
    """(model, config) from a directory holding train_config.json +
    pytorch_model.bin: the config's model in eval mode in ``dtype`` on
    ``device`` (default the card), its weights loaded ``strict=True``."""
    with open(os.path.join(model_dir, CONFIG_FILE)) as f:
        config = normalize_config(json.load(f))
    model = build_model(config, dtype=dtype, device=device)
    model.load_state_dict(load_torch_checkpoint(os.path.join(model_dir, WEIGHTS_FILE)),
                          strict=True)
    return model, config


def load_HF_model(architecture: str, multi_modal: bool, pretrain: str,
                  models_root: str = "models", dtype=torch.float32, device=None):
    """The reference's entry point (from_HF.py): the local snapshot under
    ``models_root``, downloaded first if it is missing; returns (model,
    config)."""
    if architecture in _NOT_PORTED:
        raise NotImplementedError(
            f"{architecture} is not ported yet: {_NOT_PORTED[architecture]}")
    model_dir = get_local_model_dir(architecture, multi_modal, pretrain, models_root)
    if not all(os.path.isfile(os.path.join(model_dir, f))
               for f in (WEIGHTS_FILE, CONFIG_FILE)):
        download_HF_model(architecture, multi_modal, pretrain, models_root)
    return load_model_dir(model_dir, dtype=dtype, device=device)
