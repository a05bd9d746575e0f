"""Expected key / shape manifests of upstream timm checkpoints (port of
btsbot_tpu.interop.manifests).

The reference's training recipe starts from timm backbones (reference
architectures.py:31,62,108,132) and its HF distribution names them
(to_HF.py:165-177: ``timm/convnext_pico.d1_in1k``,
``timm/maxvit_tiny_rw_224.sw_in1k``,
``mwalmsley/zoobot-encoder-convnext_pico``).  This module records, as data,
which keys and shapes a backbone checkpoint must hold, so that a real
checkpoint is validated before it seeds a model
(:func:`validate_state_dict`): drift between the published timm naming and
the port's module names surfaces as a missing / unexpected / shape report
instead of a half-load.  The JSON manifests in ``interop/manifests/`` are
copies of the JAX package's files (the port reads no file of that
package); a test pins them to :func:`expected_checkpoint_manifest`.

The generators follow the published timm module structure (ConvNeXt:
``stem.{0,1}``, ``stages.{s}.downsample.{0,1}``,
``stages.{s}.blocks.{b}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``, head
``head.{norm,fc}``; MaxViT / maxxvit: ``stem.{conv1,norm1,conv2}``,
``stages.{s}.blocks.{b}.{conv.*,attn_block.*,attn_grid.*}``, head
``head.{norm,pre_logits.fc,fc}``), on the port's own ``convnext_spec`` /
``maxvit_spec``.  timm is not installed here, so the "rw" MaxViT details
are unverified against a real checkpoint; run :func:`validate_state_dict`
on one when it is available.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

from ..models.convnext import convnext_spec
from ..models.maxvit import get_model_image_size, maxvit_spec

MANIFEST_DIR = os.path.join(os.path.dirname(__file__), "manifests")

#: timm ImageNet-1k classifier width, used by the vendored .sw_in1k/.d1_in1k
#: manifests.  Backbone-only distributions (zoobot encoders) omit the head.
IMAGENET_CLASSES = 1000

Shape = tuple[int, ...]


def _bn(man: dict, prefix: str, c: int) -> None:
    man[f"{prefix}.weight"] = (c,)
    man[f"{prefix}.bias"] = (c,)
    man[f"{prefix}.running_mean"] = (c,)
    man[f"{prefix}.running_var"] = (c,)
    man[f"{prefix}.num_batches_tracked"] = ()


def _affine(man: dict, prefix: str, c: int) -> None:
    man[f"{prefix}.weight"] = (c,)
    man[f"{prefix}.bias"] = (c,)


def _linear(man: dict, prefix: str, cin: int, cout: int) -> None:
    man[f"{prefix}.weight"] = (cout, cin)
    man[f"{prefix}.bias"] = (cout,)


def _convnext_manifest(model_kind: str, num_classes: int | None) -> dict:
    spec = convnext_spec(model_kind)
    depths, dims = spec["depths"], spec["dims"]
    man: dict[str, Shape] = {}
    man["stem.0.weight"] = (dims[0], 3, 4, 4)
    man["stem.0.bias"] = (dims[0],)
    _affine(man, "stem.1", dims[0])
    for s, (depth, dim) in enumerate(zip(depths, dims)):
        if s > 0:
            _affine(man, f"stages.{s}.downsample.0", dims[s - 1])
            man[f"stages.{s}.downsample.1.weight"] = (dim, dims[s - 1], 2, 2)
            man[f"stages.{s}.downsample.1.bias"] = (dim,)
        for b in range(depth):
            bp = f"stages.{s}.blocks.{b}"
            man[f"{bp}.gamma"] = (dim,)
            man[f"{bp}.conv_dw.weight"] = (dim, 1, 7, 7)
            man[f"{bp}.conv_dw.bias"] = (dim,)
            _affine(man, f"{bp}.norm", dim)
            _linear(man, f"{bp}.mlp.fc1", dim, 4 * dim)
            _linear(man, f"{bp}.mlp.fc2", 4 * dim, dim)
    _affine(man, "head.norm", dims[-1])
    if num_classes:
        _linear(man, "head.fc", dims[-1], num_classes)
    return man


def _maxvit_manifest(model_kind: str, num_classes: int | None) -> dict:
    spec = maxvit_spec(model_kind)
    depths, dims = spec["depths"], spec["dims"]
    stem_w = spec["stem_width"]
    man: dict[str, Shape] = {}
    man["stem.conv1.weight"] = (stem_w, 3, 3, 3)
    _bn(man, "stem.norm1", stem_w)
    man["stem.conv2.weight"] = (stem_w, stem_w, 3, 3)
    man["stem.conv2.bias"] = (stem_w,)
    in_chs = stem_w
    for s, (depth, dim) in enumerate(zip(depths, dims)):
        for b in range(depth):
            stride = 2 if b == 0 else 1
            bp = f"stages.{s}.blocks.{b}"
            # MBConv (expand ×4 on input channels, SE 0.25 on input channels
            # — matching models/maxvit.py; see module docstring provenance)
            mid = 4 * in_chs
            rd = max(1, int(in_chs * 0.25))
            cp = f"{bp}.conv"
            _bn(man, f"{cp}.pre_norm", in_chs)
            man[f"{cp}.conv1_1x1.weight"] = (mid, in_chs, 1, 1)
            _bn(man, f"{cp}.norm1", mid)
            man[f"{cp}.conv2_kxk.weight"] = (mid, 1, 3, 3)
            _bn(man, f"{cp}.norm2", mid)
            man[f"{cp}.se.fc1.weight"] = (rd, mid, 1, 1)
            man[f"{cp}.se.fc1.bias"] = (rd,)
            man[f"{cp}.se.fc2.weight"] = (mid, rd, 1, 1)
            man[f"{cp}.se.fc2.bias"] = (mid,)
            man[f"{cp}.conv3_1x1.weight"] = (dim, mid, 1, 1)
            man[f"{cp}.conv3_1x1.bias"] = (dim,)
            if stride == 2 or in_chs != dim:
                man[f"{cp}.shortcut.conv.weight"] = (dim, in_chs, 1, 1)
                man[f"{cp}.shortcut.conv.bias"] = (dim,)
            # window + grid attention sublayers (partition size = native
            # resolution / 32, e.g. 7 for 224-native, 5 for 160-native —
            # models/maxvit.py::maxvit_window)
            win = max(1, get_model_image_size(model_kind) // 32)
            heads = dim // 32
            for axis in ("attn_block", "attn_grid"):
                ap = f"{bp}.{axis}"
                _affine(man, f"{ap}.norm1", dim)
                _linear(man, f"{ap}.attn.qkv", dim, 3 * dim)
                man[f"{ap}.attn.rel_pos.relative_position_bias_table"] = (
                    (2 * win - 1) ** 2, heads)
                _linear(man, f"{ap}.attn.proj", dim, dim)
                _affine(man, f"{ap}.norm2", dim)
                _linear(man, f"{ap}.mlp.fc1", dim, 4 * dim)
                _linear(man, f"{ap}.mlp.fc2", 4 * dim, dim)
            in_chs = dim
    _affine(man, "head.norm", dims[-1])
    if num_classes:
        _linear(man, "head.pre_logits.fc", dims[-1], dims[-1])
        _linear(man, "head.fc", dims[-1], num_classes)
    return man


def expected_checkpoint_manifest(model_kind: str,
                                 num_classes: int | None = IMAGENET_CLASSES,
                                 ) -> dict[str, Shape]:
    """Expected ``key → shape`` layout of an upstream timm checkpoint.

    ``num_classes=None`` yields the backbone-only layout (classifier
    stripped), matching zoobot encoder distributions.
    """
    if "convnext" in model_kind:
        return _convnext_manifest(model_kind, num_classes)
    if "maxvit" in model_kind:
        return _maxvit_manifest(model_kind, num_classes)
    raise ValueError(f"No manifest generator for model_kind {model_kind!r}")


def _manifest_path(model_kind: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", model_kind)
    return os.path.join(MANIFEST_DIR, f"{safe}.json")


def load_manifest(model_kind: str) -> dict[str, Shape]:
    """Load a vendored manifest; falls back to the generator for model kinds
    without a vendored file."""
    path = _manifest_path(model_kind)
    if os.path.exists(path):
        with open(path) as f:
            return {k: tuple(v) for k, v in json.load(f).items()}
    return expected_checkpoint_manifest(model_kind)


def write_manifest(model_kind: str,
                   manifest: Mapping[str, Shape] | None = None) -> str:
    os.makedirs(MANIFEST_DIR, exist_ok=True)
    manifest = manifest or expected_checkpoint_manifest(model_kind)
    path = _manifest_path(model_kind)
    with open(path, "w") as f:
        json.dump({k: list(v) for k, v in manifest.items()}, f, indent=1)
        f.write("\n")
    return path


def _shape(x) -> Shape:
    if hasattr(x, "shape"):
        return tuple(int(d) for d in x.shape)
    return ()


def validate_state_dict(state_dict: Mapping[str, Any], model_kind: str,
                        num_classes: int | None = IMAGENET_CLASSES,
                        ) -> dict[str, list]:
    """Compare a (backbone) state dict against the vendored manifest.

    Returns ``{"missing": [...], "unexpected": [...], "mismatched":
    [(key, got, want), ...], "ok": bool}``.  Run this on any real upstream
    checkpoint before conversion; an empty report means the converter will
    consume every key at the expected shape.
    """
    manifest = load_manifest(model_kind)
    if num_classes is None:
        manifest = {k: v for k, v in manifest.items()
                    if not k.startswith("head.")}
    missing = sorted(k for k in manifest if k not in state_dict)
    unexpected = sorted(k for k in state_dict if k not in manifest)
    mismatched = sorted(
        (k, _shape(state_dict[k]), manifest[k])
        for k in manifest
        if k in state_dict and not k.endswith(".num_batches_tracked")
        and _shape(state_dict[k]) != manifest[k])
    return {"missing": missing, "unexpected": unexpected,
            "mismatched": mismatched,
            "ok": not (missing or unexpected or mismatched)}


def check_state_dict(state_dict: Mapping[str, Any], model_kind: str,
                     num_classes: int | None = IMAGENET_CLASSES) -> None:
    """:func:`validate_state_dict`, raising ValueError on any discrepancy."""
    report = validate_state_dict(state_dict, model_kind, num_classes)
    if not report["ok"]:
        parts = []
        for kind in ("missing", "unexpected", "mismatched"):
            if report[kind]:
                head = ", ".join(str(k) for k in report[kind][:8])
                more = len(report[kind]) - 8
                parts.append(f"{kind}: {head}" + (f" (+{more})" if more > 0
                                                  else ""))
        raise ValueError(
            f"Checkpoint does not match the {model_kind} manifest — "
            + "; ".join(parts))
