"""Flax variables → reference-named state dict for the port's modules.

The bridge that lets the JAX package and the port compute on the same
weights: ``state_dict_from_jax(config, variables)`` takes flax variables as
nested dicts of arrays (anything ``np.asarray`` reads) and returns numpy
arrays under the reference's names, which the port's modules load with
``strict=True``.  The layout transforms are those of the JAX package's
exporter (btsbot_tpu/interop/export.py:112-166): Linear kernels transposed
to (out, in), conv kernels HWIO → (O, I, kh, kw), BatchNorm statistics as
running_mean / running_var plus a zero num_batches_tracked.

The flatten: the JAX CNNs flatten their final map in NHWC order and the
port's (as the reference's) in NCHW order, so the first dense layer after a
CNN flatten (``combined_head.0`` of mm_cnn and of a fusion over um_cnn,
``head.0`` of um_cnn) has its input axis permuted back to NCHW order
(``nchw_flatten_perm``, a copy of the JAX package's).  mm_ConvNeXt needs no
permutation (its final map is 1×1 at 63×63 input, and the port flattens it
in the JAX model's NHWC order).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..core.config import Config, normalize_config
from ..models.convnext import convnext_spec
from ..models.fusion import resolve_fusion_config


def _np(x) -> np.ndarray:
    return np.asarray(x)


def nchw_flatten_perm(c: int, h: int, w: int) -> np.ndarray:
    """Permutation p with p[nhwc_index] = nchw_index, for re-indexing the
    input axis of a Linear that consumed a flattened NCHW map."""
    idx = np.arange(c * h * w).reshape(c, h, w)  # value = NCHW flat index
    return np.transpose(idx, (1, 2, 0)).reshape(-1)  # ordered by (h, w, c)


def _head_perm(config, total_in: int) -> np.ndarray:
    """Input-axis permutation for the first dense layer after the CNN
    flatten (identity on concatenated metadata features)."""
    s = int(config.get("image_size", 63)) // 8
    perm = nchw_flatten_perm(int(config["conv2_channels"]), s, s)
    if total_in > perm.size:
        perm = np.concatenate([perm, np.arange(perm.size, total_in)])
    return perm


def _linear(sd: dict, prefix: str, leaf: Mapping,
            in_perm: np.ndarray | None = None) -> None:
    """``in_perm``: the JAX input order (NHWC flatten) of the kernel's rows,
    as NCHW indices; the torch weight gets its columns in NCHW order."""
    w = _np(leaf["kernel"]).T
    if in_perm is not None:
        inv = np.empty_like(in_perm)
        inv[in_perm] = np.arange(in_perm.size)
        w = w[:, inv]
    sd[f"{prefix}.weight"] = w.copy()
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


def _cnn_backbone(sd: dict, prefix: str, params: Mapping) -> None:
    for i, name in zip((0, 2, 6, 8), ("conv1a", "conv1b", "conv2a", "conv2b")):
        _conv(sd, f"{prefix}.{i}", params[name])


def _metadata_branch(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    _batch_norm(sd, f"{prefix}.0", params["bn"], stats["bn"])
    _linear(sd, f"{prefix}.1", params["fc1"])
    _linear(sd, f"{prefix}.4", params["fc2"])


def _head(sd: dict, prefix: str, params: Mapping, indices=(0, 2, 5),
          in_perm: np.ndarray | None = None) -> None:
    for i, name in zip(indices, ("fc1", "fc2", "out")):
        _linear(sd, f"{prefix}.{i}", params[name], in_perm if name == "fc1" else None)


def _fc1_perm(config, params: Mapping) -> np.ndarray:
    return _head_perm(config, _np(params["fc1"]["kernel"]).shape[0])


def _mm_cnn(config: Config, variables: Mapping) -> dict:
    p, s = variables["params"], variables["batch_stats"]
    sd: dict[str, Any] = {}
    _cnn_backbone(sd, "conv_layers", p["backbone"])
    _metadata_branch(sd, "metadata_branch", p["metadata_branch"], s["metadata_branch"])
    _head(sd, "combined_head", p["combined_head"],
          in_perm=_fc1_perm(config, p["combined_head"]))
    return sd


def _um_cnn(config: Config, variables: Mapping) -> dict:
    p = variables["params"]
    sd: dict[str, Any] = {}
    _cnn_backbone(sd, "conv_layers", p["backbone"])
    _head(sd, "head", p["head"], in_perm=_fc1_perm(config, p["head"]))
    return sd


def _um_nn(config: Config, variables: Mapping) -> dict:
    p, s = variables["params"], variables["batch_stats"]
    sd: dict[str, Any] = {}
    _metadata_branch(sd, "network", p["branch"], s["branch"])
    _linear(sd, "network.6", p["out"])
    return sd


def _convnext(config: Config, variables: Mapping) -> dict:
    p = variables["params"]
    sd: dict[str, Any] = {}
    _convnext_backbone(sd, "convnext", p["backbone"],
                       config.get("model_kind", "convnext_nano.d1h_in1k"))
    _norm(sd, "convnext.head.1", p["head_norm"])
    _head(sd, "convnext.head", p["head"], indices=(3, 5, 8))
    return sd


def _frozen_fusion(config: Config, variables: Mapping) -> dict:
    img_cfg = normalize_config(resolve_fusion_config(config)["image_model_config"])
    p, s = variables["params"], variables["batch_stats"]
    sd: dict[str, Any] = {}
    img, name = p["image_branch"], img_cfg["model_name"]
    if name == "um_cnn":
        _cnn_backbone(sd, "image_branch.conv_layers", img["backbone"])
    elif name == "ConvNeXt":
        _convnext_backbone(sd, "image_branch.convnext", img["backbone"],
                           img_cfg.get("model_kind", "convnext_nano.d1h_in1k"))
        _norm(sd, "image_branch.convnext.head.1", img["head_norm"])
    else:
        raise NotImplementedError(
            f"no weight bridge for a {name} fusion branch yet (ROADMAP Queue A "
            f"item 7: MaxViT)")
    _metadata_branch(sd, "meta_branch.network", p["meta_branch"], s["meta_branch"])
    _head(sd, "combined_head", p["combined_head"],
          in_perm=_fc1_perm(img_cfg, p["combined_head"]) if name == "um_cnn" else None)
    return sd


def _mm_convnext(config: Config, variables: Mapping) -> dict:
    p = variables["params"]
    s = variables.get("batch_stats", {})
    sd: dict[str, Any] = {}
    _convnext_backbone(sd, "convnext_backbone", p["backbone"],
                       config.get("model_kind", "convnext_nano.d1h_in1k"))
    if "head_norm" in p:
        _norm(sd, "convnext_backbone.head.1", p["head_norm"])
    _metadata_branch(sd, "metadata_branch", p["metadata_branch"], s["metadata_branch"])
    _head(sd, "combined_head", p["combined_head"])
    return sd


_CONVERTERS = {"mm_cnn": _mm_cnn, "um_cnn": _um_cnn, "um_nn": _um_nn,
               "ConvNeXt": _convnext, "mm_ConvNeXt": _mm_convnext,
               "frozen_fusion": _frozen_fusion}


def state_dict_from_jax(config, variables: Mapping) -> dict:
    """Flax variables → reference-named numpy state dict."""
    if not isinstance(config, Config):
        config = normalize_config(config)
    name = config["model_name"]
    if name not in _CONVERTERS:
        raise NotImplementedError(
            f"no weight bridge for {name} yet (ROADMAP Queue A item 7: MaxViT)")
    return _CONVERTERS[name](config, variables)
