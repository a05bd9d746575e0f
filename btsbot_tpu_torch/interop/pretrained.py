"""Pretrained-backbone initialisation for training (port of
btsbot_tpu.interop.pretrained).

The reference starts its ConvNeXt / MaxViT models from pretrained timm or
zoobot backbones (``timm.create_model(config['model_kind'],
pretrained=config['pretrained'])``, reference architectures.py:31,62,108,132).
Here a *backbone-only* timm or zoobot state dict (keys ``stem.*`` /
``stages.*``, no ``convnext.`` / ``convnext_backbone.`` wrapper; the
classifier is discarded) seeds the backbone of a freshly built model.  The
port's modules carry the reference's names, which wrap timm's, so the
backbone's entries are the checkpoint's keys under the model's backbone
prefix (``convnext_backbone.``, ``convnext.``, ``maxvit_backbone.``,
``maxvit.``); timm's ``head.norm`` becomes the backbone head's LayerNorm
(``head.1``) where the model keeps one (``_uses_head_norm``), and a MaxViT
checkpoint's ``shortcut.expand`` is read as ``shortcut.conv``
(``interop.maxvit_convert``).  Trigger points (``engine.train``):

* ``backbone_checkpoint: <path>`` — that local checkpoint (torch
  ``.pth`` / ``.bin`` / ``.pt`` or numpy ``.npz``), fully offline;
* ``pretrained: true`` without ``backbone_checkpoint`` — timm's weights
  when timm can be imported (it is imported only then), else the fresh
  init with a logged notice.

A checkpoint is validated against the manifests (``interop.manifests``)
before it is mapped, and every key must be used and every backbone entry
of the model filled, so a drifted checkpoint raises with a report instead
of half-loading.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from ..core.config import Config, normalize_config
from .manifests import expected_checkpoint_manifest, validate_state_dict
from .maxvit_convert import apply_shortcut_aliases

#: wrapper prefixes seen on published backbone checkpoints: DataParallel,
#: zoobot lightning encoders, generic trainer wrappers.
KNOWN_WRAPPER_PREFIXES = ("module.", "encoder.", "model.", "timm_model.")

#: the families with a pretrained-capable backbone, and its prefix in the
#: model's state dict (the reference builds only ConvNeXt / MaxViT from timm)
BACKBONE_PREFIXES = {"ConvNeXt": "convnext.", "mm_ConvNeXt": "convnext_backbone.",
                     "MaxViT": "maxvit.", "mm_MaxViT": "maxvit_backbone."}
BACKBONE_MODELS = set(BACKBONE_PREFIXES)
IGNORED_KEY_SUFFIXES = (".num_batches_tracked",)


class UnconsumedKeysError(KeyError):
    """A checkpoint carried keys that seed nothing: the unexpected-key half
    of ``load_state_dict(strict=True)``, so a checkpoint with extra or
    renamed submodules never half-loads."""

    def __init__(self, unconsumed: list[str], total: int):
        self.unconsumed = unconsumed
        self.total = total
        shown = ", ".join(unconsumed[:12])
        more = f" (+{len(unconsumed) - 12} more)" if len(unconsumed) > 12 else ""
        super().__init__(f"{len(unconsumed)} of {total} checkpoint keys were not "
                         f"consumed by the conversion: {shown}{more}")


def _is_bookkeeping(key: str) -> bool:
    return key.endswith(IGNORED_KEY_SUFFIXES) or key.startswith("_")


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def load_backbone_state_dict(path: str) -> dict[str, np.ndarray]:
    """A backbone checkpoint from disk as numpy arrays: torch ``.pth`` /
    ``.bin`` / ``.pt`` (a lightning ``state_dict`` entry unwrapped) or a
    numpy ``.npz`` archive."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:  # lightning-style
        obj = obj["state_dict"]
    return {k: _numpy(v) for k, v in obj.items()}


def normalize_backbone_keys(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Strip known wrapper prefixes until the keys start at timm's
    ``stem.``; repeats, so nested wrappers strip in any order."""
    sd = dict(sd)
    if sd and next(iter(sd)).startswith("module."):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    stripped = True
    while stripped and sd:
        stripped = False
        for prefix in KNOWN_WRAPPER_PREFIXES:
            if any(k.startswith(prefix) for k in sd) and all(
                    k.startswith(prefix) or _is_bookkeeping(k) for k in sd):
                sd = {k[len(prefix):] if k.startswith(prefix) else k: v
                      for k, v in sd.items()}
                stripped = True
    return sd


def _uses_head_norm(config: Config) -> bool:
    """Whether the model keeps the backbone's head norm (the reference
    keeps pool + norm + flatten for image-only ConvNeXt always, and for
    mm_ConvNeXt only on LS data — architectures.py:109-119,137-143)."""
    if config["model_name"] == "ConvNeXt":
        return True
    return (config["model_name"] == "mm_ConvNeXt"
            and "LS" in config.get("train_data_version", ""))


def _validate(sd: Mapping, model_kind: str) -> None:
    # backbone-only manifest: the classifier's layout varies by pretraining
    # corpus, so head.* keys are exempt and handled by the discard rules
    report = validate_state_dict(sd, model_kind, num_classes=None)
    report["unexpected"] = [k for k in report["unexpected"] if not k.startswith("head.")]
    if report["missing"] or report["unexpected"] or report["mismatched"]:
        parts = []
        if report["missing"]:
            parts.append(f"missing: {', '.join(report['missing'][:8])}")
        if report["unexpected"]:
            parts.append(f"unexpected: {', '.join(report['unexpected'][:8])}")
        if report["mismatched"]:
            parts.append("shape mismatches: " + ", ".join(
                f"{k} {got}!={want}" for k, got, want in report["mismatched"][:8]))
        raise ValueError(
            f"Backbone checkpoint does not match the {model_kind} manifest — "
            f"{'; '.join(parts)}. Correct the checkpoint / model_kind, or pass "
            f"validate=False to attempt the raw conversion (which still refuses "
            f"to half-load).")


def backbone_state_dict(config, state_dict: Mapping[str, Any],
                        validate: bool = True) -> dict[str, np.ndarray]:
    """A backbone-only timm / zoobot state dict as a fragment of the
    config's model state dict (reference names, numpy arrays): the
    backbone's entries, and its head norm where the model keeps one.
    Classifier keys (``head.fc``, ``head.pre_logits``, an unused
    ``head.norm``) are discarded; any other key that seeds nothing raises
    ``UnconsumedKeysError``."""
    config = config if isinstance(config, Config) else normalize_config(config)
    name = config["model_name"]
    if name not in BACKBONE_MODELS:
        raise ValueError(
            f"Model {name} has no pretrained-capable backbone (only "
            f"{sorted(BACKBONE_MODELS)} wrap timm backbones in the reference recipe)")
    sd = normalize_backbone_keys(state_dict)
    if validate:
        _validate(sd, config.model_kind)
    prefix = BACKBONE_PREFIXES[name]
    if "MaxViT" in name:
        sd = apply_shortcut_aliases(sd)
    # the keys the backbone reads: the generated layout without its head
    wanted = {k for k in expected_checkpoint_manifest(config.model_kind, num_classes=None)
              if not k.startswith("head.")}
    missing = sorted(k for k in wanted if k not in sd and not _is_bookkeeping(k))
    if missing:
        raise KeyError(f"backbone checkpoint lacks {len(missing)} keys: "
                       f"{', '.join(missing[:8])}")
    fragment = {prefix + k: _numpy(sd[k]) for k in wanted if not _is_bookkeeping(k)}
    if "ConvNeXt" in name and "head.norm.weight" in sd and _uses_head_norm(config):
        for leaf in ("weight", "bias"):
            fragment[f"{prefix}head.1.{leaf}"] = _numpy(sd[f"head.norm.{leaf}"])
    discardable = tuple(f"head.{k}" for k in ("fc.", "pre_logits.", "norm."))
    unconsumed = sorted(k for k in sd if k not in wanted and not _is_bookkeeping(k)
                        and not k.startswith(discardable))
    if unconsumed:
        raise UnconsumedKeysError(unconsumed, len(sd))
    return fragment


def apply_backbone(config, model_state: Mapping[str, Any], fragment: Mapping) -> dict:
    """``model_state`` with ``fragment`` grafted in.  The fragment must fill
    every backbone entry of the model (``stem.`` / ``stages.`` under the
    backbone prefix, BatchNorm's ``num_batches_tracked`` aside) at its
    shape and hold nothing else: no partial grafts."""
    config = config if isinstance(config, Config) else normalize_config(config)
    prefix = BACKBONE_PREFIXES[config["model_name"]]
    body = tuple(prefix + p for p in ("stem.", "stages."))
    want = {k for k in model_state if k.startswith(body) and not _is_bookkeeping(k)}
    missing = sorted(want - set(fragment))
    unexpected = sorted(k for k in fragment if k not in model_state)
    mismatched = [(k, tuple(np.shape(v)), tuple(model_state[k].shape))
                  for k, v in fragment.items()
                  if k in model_state and tuple(np.shape(v)) != tuple(model_state[k].shape)]
    if missing or unexpected or mismatched:
        raise ValueError(
            f"Backbone fragment does not match the model (check model_kind): "
            f"missing {missing[:6]}, unexpected {unexpected[:6]}, "
            f"shape mismatches {mismatched[:6]}")
    out = dict(model_state)
    for k, v in fragment.items():
        out[k] = torch.as_tensor(np.asarray(v)).to(dtype=model_state[k].dtype)
    return out


def fetch_timm_backbone(config) -> dict[str, np.ndarray] | None:
    """The reference recipe: the pretrained backbone through timm when it
    can be imported (architectures.py:31,62,108,132); None otherwise."""
    try:
        import timm
    except ImportError:
        return None
    model = timm.create_model(config.model_kind, pretrained=True)
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def init_from_backbone_checkpoint(config, model, checkpoint: str | Mapping[str, Any],
                                  validate: bool = True):
    """Seed ``model``'s backbone in place from a backbone checkpoint (a path
    or a state dict); returns the model."""
    config = config if isinstance(config, Config) else normalize_config(config)
    if isinstance(checkpoint, (str, os.PathLike)):
        checkpoint = load_backbone_state_dict(os.fspath(checkpoint))
    fragment = backbone_state_dict(config, checkpoint, validate=validate)
    model.load_state_dict(apply_backbone(config, model.state_dict(), fragment), strict=True)
    return model


def maybe_init_pretrained(config, model, log=print):
    """The trainer's hook: the configured pretrained-backbone init, if any.
    Precedence: an explicit ``backbone_checkpoint`` path, then
    ``pretrained: true`` through timm, else the fresh init.  Returns the
    model."""
    config = config if isinstance(config, Config) else normalize_config(config)
    path = config.get("backbone_checkpoint")
    if path:
        init_from_backbone_checkpoint(config, model, path)
        log(f"Initialized {config['model_name']} backbone from {path}")
        return model
    if config.get("pretrained", False) and config["model_name"] in BACKBONE_MODELS:
        if "inceptionnext" in str(config.get("model_kind", "")):
            log("model_kind is an inceptionnext variant; pretrained has no source "
                "checkpoint (train from scratch or distill from a trained mm_ConvNeXt)")
            return model
        sd = fetch_timm_backbone(config)
        if sd is not None:
            init_from_backbone_checkpoint(config, model, sd)
            log(f"Initialized backbone from timm {config.model_kind} (pretrained=true)")
        else:
            log("pretrained=true but timm is unavailable and no backbone_checkpoint "
                "was given; starting from random init (provide backbone_checkpoint "
                "for the reference recipe)")
    return model
