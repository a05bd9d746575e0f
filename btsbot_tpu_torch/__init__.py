"""btsbot-tpu-torch: the PyTorch / CUDA port of btsbot_tpu for NVIDIA Hopper.

The JAX package ``btsbot_tpu`` beside it is the reference; this package
imports nothing of it (nor jax or flax) and holds its own copies of what it
needs.  The serving path runs here end to end: packet decode (``native``),
ingest (``ops.preprocess``), the model forward with every ConvNeXt block in
a hand-written CUDA kernel (``ops.convnext_block``, ``ops.ln_mlp``), the
scorers and the broker daemon (``engine.serve``, ``cli.serve``).  So does
training: ``engine.train.run_training`` and ``python -m
btsbot_tpu_torch.cli.train``, with the block kernel in
every training and evaluation forward.  Every family is ported
(mm_ConvNeXt and ConvNeXt with ``convnext_*`` or ``inceptionnext_*`` kinds,
MaxViT, mm_MaxViT, mm_cnn, um_cnn, um_nn, frozen_fusion), and HF
snapshots load through ``interop.hf`` (``load_HF_model``,
``load_model_dir``).  Models deploy as ONNX graphs and TF SavedModels
written with neither package installed (``interop.onnx_export``,
``interop.savedmodel``).  The facade resolves the JAX package's public
names lazily, the reference's model class names included.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""

import importlib

from .version import __version__

from .core.config import (
    Config,
    IMAGE_ONLY_MODELS,
    METADATA_ONLY_MODELS,
    MULTIMODAL_MODELS,
    load_config,
    normalize_config,
)


# Heavier surfaces load lazily so `import btsbot_tpu_torch` stays light:
# public name → (submodule, attribute).  The names of the JAX package's
# facade that return or take flax variables (``init_model``,
# ``torch_state_dict_to_variables``) have no counterpart here.
_LAZY = {
    "AlertScorer": ("engine.serve", "AlertScorer"),
    "AlertStreamScorer": ("engine.serve", "AlertStreamScorer"),
    "AlertStreamConsumer": ("engine.serve", "AlertStreamConsumer"),
    "verify_serving_parity": ("engine.serve", "verify_serving_parity"),
    "MODEL_REGISTRY": ("models.factory", "MODEL_REGISTRY"),
    "build_model": ("models.factory", "build_model"),
    "state_dict_from_jax": ("interop.weights", "state_dict_from_jax"),
    "run_training": ("engine.train", "run_training"),
    "load_HF_model": ("interop.hf", "load_HF_model"),
    "load_model_dir": ("interop.hf", "load_model_dir"),
    "download_HF_model": ("interop.hf", "download_HF_model"),
    "AlertDataset": ("data.dataset", "AlertDataset"),
    # the reference's name for the in-memory runtime dataset
    "FlexibleDataset": ("data.dataset", "AlertDataset"),
    "export_onnx": ("interop.onnx_export", "export_onnx"),
    "verify_onnx": ("interop.onnx_export", "verify_onnx"),
    "export_and_verify_onnx": ("interop.onnx_export", "export_and_verify_onnx"),
    "export_saved_model": ("interop.savedmodel", "export_saved_model"),
    "verify_saved_model": ("interop.savedmodel", "verify_saved_model"),
    "init_from_backbone_checkpoint": ("interop.pretrained", "init_from_backbone_checkpoint"),
    "distill_to_student": ("engine.distill", "distill_to_student"),
    "make_report": ("metrics.report", "make_report"),
    # the reference helper: a model directory → (model, config)
    "load_BTSbot_model": ("engine.distill", "load_teacher"),
}
# the reference facade's model class names, through the registry
_REFERENCE_MODEL_NAMES = (
    "MaxViT", "ConvNeXt", "mm_MaxViT", "mm_ConvNeXt",
    "mm_cnn", "um_cnn", "um_nn", "frozen_fusion",
)


def __getattr__(name):
    if name in _REFERENCE_MODEL_NAMES:
        from .models.factory import MODEL_REGISTRY
        return MODEL_REGISTRY[name]
    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    raise AttributeError(name)


__all__ = [
    "__version__",
    "Config",
    "load_config",
    "normalize_config",
    "IMAGE_ONLY_MODELS",
    "METADATA_ONLY_MODELS",
    "MULTIMODAL_MODELS",
    *_LAZY,
    *_REFERENCE_MODEL_NAMES,
]
