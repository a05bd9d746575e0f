"""Config handling for the PyTorch port (a copy of btsbot_tpu.core.config).

The port keeps its own copy because importing anything of ``btsbot_tpu``
runs that package's ``__init__``, which loads flax.

The reference framework (nabeelre/BTSbot) drives everything off flat JSON
configs (e.g. the reference's train_configs/prod_config.json) accessed
as raw dicts with scattered ``.get()`` defaults.  We keep the same flat-JSON
surface so reference configs load unchanged, but normalize them once up front:

* legacy-schema repair: ``comb_fc_neurons`` (prod_config.json:53) is mapped to
  ``comb_fc1_neurons``/``comb_fc2_neurons`` which the models actually read
  (reference architectures.py:215-218 would KeyError on its own prod config);
* ``learning_rate`` may arrive as a string from sweep tooling
  (reference train.py:84) — coerced to float;
* defaults are centralized here instead of being sprinkled through the code.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Mapping


# Model-category routing tables (reference train.py:41-43).
IMAGE_ONLY_MODELS = ("MaxViT", "ConvNeXt", "um_cnn")
METADATA_ONLY_MODELS = ("um_nn",)
MULTIMODAL_MODELS = ("mm_MaxViT", "mm_ConvNeXt", "mm_cnn", "frozen_fusion")

_DEFAULTS: dict[str, Any] = {
    "pretrained": True,
    # stamped explicitly so every run's report.json records which
    # initialization trained it (the default changed flax->torch in r5;
    # models/init.py) — a config replayed later is self-describing
    "init_scheme": "torch",
    "image_size": 63,
    "N_max": 100,
    "warmup_epochs": 0,
    "use_test_split": False,
    "data_aug_h_flip": True,
    "data_aug_v_flip": True,
    "data_aug_rot": True,
    "metadata_cols": [],
}


class Config(dict):
    """A dict with attribute access and normalized legacy keys."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @property
    def model_category(self) -> str:
        name = self["model_name"]
        if name in IMAGE_ONLY_MODELS:
            return "image"
        if name in METADATA_ONLY_MODELS:
            return "metadata"
        if name in MULTIMODAL_MODELS:
            return "multimodal"
        raise ValueError(
            f"{name} not categorized as image-only/metadata-only/multimodal"
        )

    @property
    def need_triplets(self) -> bool:
        return self.model_category in ("image", "multimodal")

    @property
    def need_metadata(self) -> bool:
        return self.model_category in ("metadata", "multimodal")

    @property
    def model_kind(self) -> str:
        """Backbone model string, with the same per-family defaults the
        model builders use (models/convnext.py, models/maxvit.py) so every
        config consumer (export, pretrained init, converters) resolves the
        identical backbone for a config that omits the key."""
        kind = self.get("model_kind")
        if kind:
            return kind
        name = self.get("model_name", "")
        if "ConvNeXt" in name:
            return "convnext_nano.d1h_in1k"
        if "MaxViT" in name:
            return "maxvit_tiny_rw_224.sw_in1k"
        raise KeyError(
            f"model_kind is not set and model {name!r} has no backbone "
            f"default")


def normalize_config(raw: Mapping[str, Any]) -> Config:
    # deep-copy the defaults: Config(_DEFAULTS) would alias the mutable
    # list values (metadata_cols), so an in-place mutation on one returned
    # config would corrupt every later config process-wide
    cfg = Config(copy.deepcopy(_DEFAULTS))
    cfg.update(raw)

    # Legacy schema repair (reference prod_config.json:53 vs architectures.py:215-218)
    if "comb_fc1_neurons" not in cfg and "comb_fc_neurons" in cfg:
        cfg["comb_fc1_neurons"] = cfg["comb_fc_neurons"]
    if "comb_fc2_neurons" not in cfg and "comb_fc_neurons" in cfg:
        cfg["comb_fc2_neurons"] = cfg["comb_fc_neurons"]

    # Sweep tooling sometimes stringifies numbers (reference train.py:84)
    for key in ("learning_rate", "beta_1", "beta_2"):
        if key in cfg:
            cfg[key] = float(cfg[key])
    for key in ("epochs", "batch_size", "patience", "warmup_epochs", "random_seed"):
        if key in cfg:
            cfg[key] = int(cfg[key])

    return cfg


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        return normalize_config(json.load(f))
