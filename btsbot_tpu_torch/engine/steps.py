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

Distillation (``teacher=``, JAX steps.py:29-61): the teacher scores the
same augmented batch, images and metadata in its own parameters' type
(float32 unless it was loaded otherwise, even when the student computes in
bfloat16), in eval mode and without gradients, and the loss becomes
α·BCE + (1 − α)·KD (``engine.loss.binary_kd_loss``) with ``distill_alpha``
(0.5) and ``distill_temperature`` (2.0) from the config.  The teacher's parameters
ask for no gradient and are not in the student's optimizer; on the card
every teacher ConvNeXt block is the block kernel (forward only).  The eval
step ignores the teacher: the val loss is plain BCE.

Under a mesh (``mesh=``, parallel.mesh) a step takes this rank's rows of
the global batch (``batch_sharding(mesh)``) and equals the one-process
step on the global batch: augmentation and dropout draw for the global
batch and keep this rank's rows, train-mode BatchNorm takes the global
batch's statistics, the weights sharded on the model axis are gathered
where they are used, and after the backward one flat ``all_reduce``
averages the gradients over the data group (the loss is a mean over equal
shards, so that is the global batch's gradient).  The explicit
``all_reduce`` rather than DDP: the step already owns the backward and the
update, every rank builds the same weights from the seed (DDP's broadcast
adds nothing), the model keeps its names and its ``plain=`` argument, and
one collective a step is simple to time.  The returned loss and ``correct``
are the global batch's (one more ``all_reduce``) and the logits and scores
are gathered, so every rank returns the same metrics.  The teacher is
sharded by the student's rules.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.augment import augment_triplets
from ..parallel.mesh import all_gather_rows
from ..parallel.sharding import shard_module
from .loss import binary_kd_loss, weighted_bce_with_logits

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


def _typed_inputs(config, images, metadata, dtype):
    """(image_input, metadata_input) of the config's modality, both in
    ``dtype``: the inputs of a model whose parameters are in ``dtype``, as
    the scorers feed one (engine.serve)."""
    return (images.to(dtype) if config.need_triplets else None,
            metadata.to(dtype) if config.need_metadata else None)


def prepare_teacher(teacher):
    """The teacher frozen for distillation: eval mode, no gradients."""
    teacher.eval()
    teacher.requires_grad_(False)
    return teacher


def average_gradients(params, mesh) -> None:
    """Replace each parameter's gradient by its mean over the mesh's data
    group: one ``all_reduce`` of every gradient packed flat."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.shape["data"])
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _global_metrics(mesh, loss, logits, scores, correct) -> dict:
    """The global batch's metrics from this rank's: the mean loss and the
    summed ``correct`` over the data group, the logits and scores gathered."""
    d = mesh.shape["data"]
    both = torch.stack([loss.float(), correct.float()])
    dist.all_reduce(both, group=mesh.data_group)
    return {"loss": both[0] / d, "logits": all_gather_rows(logits, mesh.data_group, d),
            "scores": all_gather_rows(scores, mesh.data_group, d),
            "correct": both[1].round().long()}


def make_train_step(config, plain: bool = False, teacher=None, mesh=None):
    """``train_step(state, images, metadata, labels, pos_weight)`` → metrics;
    the state (model, optimizer, step) is updated in place.  ``plain=True``
    runs every block (the teacher's too) in its plain version, for holding
    the kernels against it.  ``teacher``: a model to distill from (see the
    module doc).  ``mesh``: the state's mesh; the step then takes this
    rank's rows of the global batch (see the module doc)."""
    need_triplets = config.need_triplets
    dtype = compute_dtype(config)
    aug_flags = dict(h_flip=bool(config.get("data_aug_h_flip", True)),
                     v_flip=bool(config.get("data_aug_v_flip", True)),
                     rot=bool(config.get("data_aug_rot", True)))
    do_augment = need_triplets and any(aug_flags.values())
    rows = None if mesh is None or mesh.shape["data"] == 1 else \
        (mesh.data_index, mesh.shape["data"])
    if teacher is not None:
        prepare_teacher(shard_module(teacher, mesh))
        teacher_dtype = next(teacher.parameters()).dtype
        alpha = float(config.get("distill_alpha", 0.5))
        temperature = float(config.get("distill_temperature", 2.0))

    def train_step(state, images, metadata, labels, pos_weight):
        model, opt = state.model, state.optimizer
        if state.mesh is not mesh:
            raise ValueError("the train state's mesh is not the step's: build the "
                             "state and the step with the same mesh")
        model.train()
        state.generator.manual_seed(step_seed(state.seed, state.step))
        if do_augment:
            images = augment_triplets(state.generator, images, **aug_flags, rows=rows)
        if teacher is not None:
            with torch.no_grad():
                t_logits = teacher(*_typed_inputs(config, images, metadata, teacher_dtype),
                                   plain=plain)
        image_input, metadata_input = model_inputs(config, images, metadata, dtype)
        logits = model(image_input=image_input, metadata_input=metadata_input,
                       plain=plain)
        loss = weighted_bce_with_logits(logits, labels, pos_weight)
        if teacher is not None:
            loss = alpha * loss + (1.0 - alpha) * binary_kd_loss(logits, t_logits,
                                                                 temperature)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            average_gradients([p for g in opt.param_groups for p in g["params"]], mesh)
        lr = state.lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        logits = logits.detach().reshape(-1)
        scores = torch.sigmoid(logits.float())
        correct = ((scores > 0.5) == (labels.reshape(-1) > 0.5)).sum()
        if mesh is not None:
            return _global_metrics(mesh, loss.detach(), logits, scores, correct)
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


def make_device_train_step(config, images, metadata, labels, teacher=None):
    """``step(state, idx, pos_weight)`` over a device-resident set: the batch
    is gathered on the device from the (B,) index tensor ``idx``."""
    base = make_train_step(config, teacher=teacher)

    def device_train_step(state, idx, pos_weight):
        def take(x):
            return None if x is None else x.index_select(0, idx)
        return base(state, take(images), take(metadata), take(labels), pos_weight)

    return device_train_step


def make_eval_step(config, mesh=None):
    """``eval_step(model, images, metadata)`` → (logits, float32 scores), in
    eval mode, without gradients.  ``mesh``: the step takes this rank's rows
    of the batch and returns the whole batch's, gathered over the data
    group."""
    dtype = compute_dtype(config)

    def eval_step(model, images, metadata):
        model.eval()
        with torch.no_grad():
            image_input, metadata_input = model_inputs(config, images, metadata, dtype)
            logits = model(image_input=image_input, metadata_input=metadata_input)
        logits = logits.reshape(-1)
        if mesh is not None:
            logits = all_gather_rows(logits, mesh.data_group, mesh.shape["data"])
        return logits, torch.sigmoid(logits.float())

    return eval_step
