"""HuggingFace Hub model publishing (port of btsbot_tpu.interop.publish).

From a run directory of the port (or of the reference trainer): prepare
``train_config.json`` from its report.json, write the best checkpoint as
the reference-named ``pytorch_model.bin`` (the port's ``best_model.pth``
already carries those names, so no converter runs), write the model card,
infer (architecture, multi_modal, pretrain) from the config, map it to the
timm / zoobot base-model hub ids, and upload (``huggingface_hub`` imported
only there; ``api`` injectable).
"""

from __future__ import annotations

import json
import os

import torch

from ..core.config import normalize_config
from ..engine.checkpoint import load_model_checkpoint
from .hf import CONFIG_FILE, WEIGHTS_FILE, get_HF_model_link


def prep_config(model_dir: str) -> dict:
    """report.json → train_config.json."""
    report_path = os.path.join(model_dir, "report.json")
    if not os.path.exists(report_path):
        raise FileNotFoundError(f"Report file not found: {report_path}")
    with open(report_path) as f:
        config = json.load(f)["train_config"]
    with open(os.path.join(model_dir, CONFIG_FILE), "w") as f:
        json.dump(config, f, indent=2)
    return config


def prep_model(model_dir: str, config: dict) -> None:
    """best_model.pth → pytorch_model.bin (reference names, CPU tensors)."""
    sd = load_model_checkpoint(normalize_config(config), model_dir)
    torch.save({k: v.contiguous() for k, v in sd.items()},
               os.path.join(model_dir, WEIGHTS_FILE))


def config_to_params(config: dict):
    """(architecture, multi_modal, pretrain) from a train config."""
    multi_modal = config["model_name"] == "frozen_fusion"
    image_config = config["image_model_config"] if multi_modal else config
    kind = image_config["model_kind"]
    if "maxvit" in kind:
        architecture = "maxvit"
    elif "inceptionnext" in kind:
        # trained from scratch or distilled; no timm base checkpoint exists
        architecture = "inceptionnext"
    elif "convnext" in kind:
        architecture = "convnext"
    else:
        raise ValueError("Couldn't understand architecture")
    if architecture == "inceptionnext":
        pretrain = "randinit"
    elif "mwalmsley" in kind:
        pretrain = "galaxyzoo"
    elif not image_config.get("pretrained", True):
        pretrain = "randinit"
    elif "in1k" in kind:
        pretrain = "imagenet"
    else:
        raise ValueError("Couldn't understand pre-training regimen")
    return architecture, multi_modal, pretrain


def get_HF_basemodel(arch: str, pretrain: str) -> str | None:
    """Base-model hub ids (None: no upstream base checkpoint)."""
    table = {
        ("maxvit", "galaxyzoo"): "mwalmsley/baseline-encoder-regression-maxvit_tiny",
        ("maxvit", "imagenet"): "timm/maxvit_tiny_rw_224.sw_in1k",
        ("maxvit", "randinit"): "timm/maxvit_tiny_rw_224.sw_in1k",
        ("convnext", "galaxyzoo"): "mwalmsley/zoobot-encoder-convnext_pico",
        ("convnext", "imagenet"): "timm/convnext_pico.d1_in1k",
        ("convnext", "randinit"): "timm/convnext_pico.d1_in1k",
        ("inceptionnext", "randinit"): None,
    }
    try:
        return table[(arch, pretrain)]
    except KeyError:
        raise ValueError(f"Invalid architecture: {arch} or pre-training regimen: "
                         f"{pretrain}") from None


def create_model_card(model_dir: str, arch: str, multi_modal: bool, pretrain: str) -> str:
    """README.md model card."""
    base = get_HF_basemodel(arch, pretrain)
    # base_model is structured Hub metadata (a real model id); kinds trained
    # from scratch omit the line
    base_line = f"\nbase_model: {base}" if base else ""
    base_text = (f"**Base Model**: [{base}](https://huggingface.co/{base})" if base
                 else "**Base Model**: none (trained from scratch or distilled from a "
                      "trained mm_ConvNeXt)")
    card = f"""---
library_name: pytorch
tags:
- vision
- image-classification
- pytorch
license: mit{base_line}
---

# BTSbot

This is a {arch} fine-tuned for classifying alert images from the Zwicky
Transient Facility (ZTF) Bright Transient Survey, trained with the PyTorch /
CUDA port of btsbot-tpu (btsbot_tpu_torch) and saved as a PyTorch checkpoint.
[Rehemtulla et al. 2024](https://arxiv.org/abs/2401.15167) introduced
BTSbot and its classification task;
[Rehemtulla et al. 2025](https://arxiv.org/abs/2512.11957) benchmarked
architectures and pre-training for it.

{base_text}

## Usage

```python
from btsbot_tpu_torch import load_HF_model
model, config = load_HF_model(
    architecture="{arch}", multi_modal={multi_modal}, pretrain="{pretrain}"
)
```

The checkpoint is also loadable by the original PyTorch BTSbot package.

## License

MIT.
"""
    with open(os.path.join(model_dir, "README.md"), "w") as f:
        f.write(card)
    return card


def upload_model_to_hf(model_dir: str, api=None) -> str:
    """Create / refresh the HF repo and upload the three artifacts."""
    with open(os.path.join(model_dir, CONFIG_FILE)) as f:
        config = json.load(f)
    link = get_HF_model_link(*config_to_params(config))
    if api is None:
        from huggingface_hub import HfApi
        api = HfApi()
    api.create_repo(repo_id=link, repo_type="model", exist_ok=True)
    for filename in (WEIGHTS_FILE, CONFIG_FILE, "README.md"):
        path = os.path.join(model_dir, filename)
        if not os.path.exists(path):
            raise FileNotFoundError(f"Required file not found: {path}")
        api.upload_file(path_or_fileobj=path, path_in_repo=filename, repo_id=link,
                        repo_type="model")
    return link


def publish(model_dir: str, api=None) -> str:
    """Full publish pipeline: config, weights, card, upload."""
    config = prep_config(model_dir)
    arch, multi_modal, pretrain = config_to_params(config)
    prep_model(model_dir, config)
    create_model_card(model_dir, arch, multi_modal, pretrain)
    return upload_model_to_hf(model_dir, api=api)
