"""Train / eval steps (port of btsbot_tpu.engine.steps).

One training step is: augmentation on the device → train-mode forward in
the config's ``compute_dtype`` (every ConvNeXt block through the block
kernel on the card, every InceptionNeXt block's LN → MLP half through
``fused_ln_mlp``; their backward recomputes the plain version) → weighted
BCE in float32 → backward → AdamW update at the LR of this update.  The
step returns device tensors (loss, logits, scores and the in-step
``correct`` count) and reads nothing back, so the host never waits on the
card inside an epoch.

Randomness: the JAX step folds the step count into its key
(steps.py:75-76).  Here the train state's generator is reseeded from
(seed, step) at the start of every step, and augmentation and dropout draw
from it in that order, so a run (and a resumed run) is reproducible per
seed, though not bit for bit the JAX package's.

The images' type is the compute type of the models that take images; a
metadata-only model (um_nn) gets its metadata cast to the compute type
instead.  A model without images skips augmentation.

``make_device_train_step`` + ``put_dataset_on_device`` are the
``device_data`` path: the training set lives on the card and each step
gathers its batch by index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.augment import augment_triplets
from .loss import weighted_bce_with_logits

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(config) -> torch.dtype:
    name = str(config.get("compute_dtype", "float32"))
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r} is not one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def step_seed(seed: int, step: int) -> int:
    """The generator seed of update ``step`` of a run seeded ``seed``."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def to_device(x: np.ndarray | None, device: torch.device):
    """A numpy batch on ``device``; to a card through pinned memory, so the
    copy is queued without waiting for the card."""
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def model_inputs(config, images, metadata, dtype):
    """(image_input, metadata_input) for the config's modality, the
    images (or, without images, the metadata) in the compute type."""
    if not config.need_triplets:
        return None, metadata.to(dtype)
    return images.to(dtype), (metadata if config.need_metadata else None)


def make_train_step(config, plain: bool = False):
    """``train_step(state, images, metadata, labels, pos_weight)`` → metrics;
    the state (model, optimizer, step) is updated in place.  ``plain=True``
    runs every block in its plain version (for holding the kernel against
    it)."""
    need_triplets = config.need_triplets
    dtype = compute_dtype(config)
    aug_flags = dict(h_flip=bool(config.get("data_aug_h_flip", True)),
                     v_flip=bool(config.get("data_aug_v_flip", True)),
                     rot=bool(config.get("data_aug_rot", True)))
    do_augment = need_triplets and any(aug_flags.values())

    def train_step(state, images, metadata, labels, pos_weight):
        model, opt = state.model, state.optimizer
        model.train()
        state.generator.manual_seed(step_seed(state.seed, state.step))
        if do_augment:
            images = augment_triplets(state.generator, images, **aug_flags)
        image_input, metadata_input = model_inputs(config, images, metadata, dtype)
        logits = model(image_input=image_input, metadata_input=metadata_input,
                       plain=plain)
        loss = weighted_bce_with_logits(logits, labels, pos_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        logits = logits.detach().reshape(-1)
        scores = torch.sigmoid(logits.float())
        correct = ((scores > 0.5) == (labels.reshape(-1) > 0.5)).sum()
        return {"loss": loss.detach(), "logits": logits, "scores": scores,
                "correct": correct}

    return train_step


def put_dataset_on_device(dataset, device, image_dtype=None):
    """(images, metadata, labels) tensors resident on ``device``;
    ``image_dtype`` (config ``device_data_dtype``) narrows the stored
    pixels, not the compute type."""
    def put(x, dtype=None):
        if x is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)
    return put(dataset.images, image_dtype), put(dataset.metadata), put(dataset.labels)


def make_device_train_step(config, images, metadata, labels):
    """``step(state, idx, pos_weight)`` over a device-resident set: the batch
    is gathered on the device from the (B,) index tensor ``idx``."""
    base = make_train_step(config)

    def device_train_step(state, idx, pos_weight):
        def take(x):
            return None if x is None else x.index_select(0, idx)
        return base(state, take(images), take(metadata), take(labels), pos_weight)

    return device_train_step


def make_eval_step(config):
    """``eval_step(model, images, metadata)`` → (logits, float32 scores), in
    eval mode, without gradients."""
    dtype = compute_dtype(config)

    def eval_step(model, images, metadata):
        model.eval()
        with torch.no_grad():
            image_input, metadata_input = model_inputs(config, images, metadata, dtype)
            logits = model(image_input=image_input, metadata_input=metadata_input)
        logits = logits.reshape(-1)
        return logits, torch.sigmoid(logits.float())

    return eval_step
