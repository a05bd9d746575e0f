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
``load_model_dir``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""

from .version import __version__

from .core.config import (
    Config,
    IMAGE_ONLY_MODELS,
    METADATA_ONLY_MODELS,
    MULTIMODAL_MODELS,
    load_config,
    normalize_config,
)


def __getattr__(name):
    # Heavier surfaces load lazily so `import btsbot_tpu_torch` stays light.
    if name in ("AlertScorer", "AlertStreamScorer", "AlertStreamConsumer",
                "verify_serving_parity"):
        from .engine import serve
        return getattr(serve, name)
    if name == "build_model":
        from .models.factory import build_model
        return build_model
    if name == "state_dict_from_jax":
        from .interop.weights import state_dict_from_jax
        return state_dict_from_jax
    if name == "run_training":
        from .engine.train import run_training
        return run_training
    if name in ("load_HF_model", "load_model_dir"):
        from .interop import hf
        return getattr(hf, name)
    raise AttributeError(name)


__all__ = [
    "__version__",
    "Config",
    "load_config",
    "normalize_config",
    "IMAGE_ONLY_MODELS",
    "METADATA_ONLY_MODELS",
    "MULTIMODAL_MODELS",
    "AlertScorer",
    "AlertStreamScorer",
    "AlertStreamConsumer",
    "verify_serving_parity",
    "build_model",
    "state_dict_from_jax",
    "run_training",
    "load_HF_model",
    "load_model_dir",
]
