"""Flax variables → reference-named state dict for the port's modules.

The bridge that lets the JAX package and the port compute on the same
weights: ``state_dict_from_jax(config, variables)`` takes flax variables as
nested dicts of arrays (anything ``np.asarray`` reads) and returns numpy
arrays under the reference's names, which the port's modules load with
``strict=True``.  The layout transforms are those of the JAX package's
exporter (btsbot_tpu/interop/export.py:112-166): Linear kernels transposed
to (out, in), conv kernels HWIO → (O, I, kh, kw), BatchNorm statistics as
running_mean / running_var plus a zero num_batches_tracked.  mm_ConvNeXt
needs no flatten permutation (its final map is 1×1 at 63×63 input and the
port flattens in the JAX model's NHWC order).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..core.config import Config, normalize_config
from ..models.convnext import convnext_spec


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _linear(sd: dict, prefix: str, leaf: Mapping) -> None:
    sd[f"{prefix}.weight"] = _np(leaf["kernel"]).T.copy()
    sd[f"{prefix}.bias"] = _np(leaf["bias"]).copy()


def _conv(sd: dict, prefix: str, leaf: Mapping) -> None:
    sd[f"{prefix}.weight"] = np.transpose(_np(leaf["kernel"]), (3, 2, 0, 1)).copy()
    sd[f"{prefix}.bias"] = _np(leaf["bias"]).copy()


def _norm(sd: dict, prefix: str, leaf: Mapping) -> None:
    sd[f"{prefix}.weight"] = _np(leaf["scale"]).copy()
    sd[f"{prefix}.bias"] = _np(leaf["bias"]).copy()


def _batch_norm(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    _norm(sd, prefix, params)
    sd[f"{prefix}.running_mean"] = _np(stats["mean"]).copy()
    sd[f"{prefix}.running_var"] = _np(stats["var"]).copy()
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _convnext_backbone(sd: dict, prefix: str, params: Mapping, model_kind: str) -> None:
    spec = convnext_spec(model_kind)
    if spec.get("token_mixer", "dwconv7") != "dwconv7":
        raise NotImplementedError(
            "inceptionnext_* weights are not ported yet (ROADMAP Queue A: "
            "InceptionMixer)")
    _conv(sd, f"{prefix}.stem.0", params["stem_conv"])
    _norm(sd, f"{prefix}.stem.1", params["stem_norm"])
    for si, depth in enumerate(spec["depths"]):
        stage = params[f"stage{si}"]
        if si > 0:
            _norm(sd, f"{prefix}.stages.{si}.downsample.0", stage["downsample_norm"])
            _conv(sd, f"{prefix}.stages.{si}.downsample.1", stage["downsample_conv"])
        for b in range(depth):
            block = stage[f"block{b}"]
            bp = f"{prefix}.stages.{si}.blocks.{b}"
            _conv(sd, f"{bp}.conv_dw", block["conv_dw"])
            _norm(sd, f"{bp}.norm", block["norm"])
            _linear(sd, f"{bp}.mlp.fc1", block["mlp_fc1"])
            _linear(sd, f"{bp}.mlp.fc2", block["mlp_fc2"])
            sd[f"{bp}.gamma"] = _np(block["gamma"]).copy()


def _mm_convnext(config: Config, variables: Mapping) -> dict:
    p = variables["params"]
    s = variables.get("batch_stats", {})
    sd: dict[str, Any] = {}
    _convnext_backbone(sd, "convnext_backbone", p["backbone"],
                       config.get("model_kind", "convnext_nano.d1h_in1k"))
    if "head_norm" in p:
        _norm(sd, "convnext_backbone.head.1", p["head_norm"])
    mb, ms = p["metadata_branch"], s["metadata_branch"]
    _batch_norm(sd, "metadata_branch.0", mb["bn"], ms["bn"])
    _linear(sd, "metadata_branch.1", mb["fc1"])
    _linear(sd, "metadata_branch.4", mb["fc2"])
    _linear(sd, "combined_head.0", p["combined_head"]["fc1"])
    _linear(sd, "combined_head.2", p["combined_head"]["fc2"])
    _linear(sd, "combined_head.5", p["combined_head"]["out"])
    return sd


_CONVERTERS = {"mm_ConvNeXt": _mm_convnext}


def state_dict_from_jax(config, variables: Mapping) -> dict:
    """Flax variables → reference-named numpy state dict."""
    if not isinstance(config, Config):
        config = normalize_config(config)
    name = config["model_name"]
    if name not in _CONVERTERS:
        raise NotImplementedError(
            f"no weight bridge for {name} yet (ROADMAP Queue A item 7)")
    return _CONVERTERS[name](config, variables)
