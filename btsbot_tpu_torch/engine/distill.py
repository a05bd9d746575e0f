"""Knowledge distillation: a trained teacher → a student of another kind
(port of btsbot_tpu.engine.distill).

The reference has one way to a production model: train from labels.  The
JAX package adds distillation: a trained (or converted) mm_ConvNeXt scores
every training batch inside the student's train step, and the student
learns α·BCE(labels) + (1 − α)·KD(teacher) (``engine.loss.binary_kd_loss``,
``engine.steps``).  Its student, ``inceptionnext_*``, has the same topology
with the InceptionNeXt token mixer.  On an NVIDIA H100 80GB HBM3 at 700 W
the student is not faster: mm_ConvNeXt with ``inceptionnext_pico.r2``
serves 415k alerts/s against the ``convnext_pico`` flagship's 505k (bf16,
batch 3072, device-resident inputs; PERF.md §5), so distillation is here
for the capability; the speed of the student is measured, not assumed.

On the card the teacher's ConvNeXt blocks run the block kernel forward
only (no autograd) and the student's InceptionNeXt blocks run
``fused_ln_mlp`` under autograd.

Typical use::

    from btsbot_tpu_torch.engine.distill import distill_to_student

    result = distill_to_student(
        teacher_dir="models/BTSbot-convnext-imagenet-metadata",  # HF snapshot
        student_kind="inceptionnext_pico.r2",
        train_ds=train_ds, val_ds=val_ds)
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.config import normalize_config
from ..models.factory import build_model
from .checkpoint import load_run_dir
from .steps import prepare_teacher


def load_teacher(teacher_dir: str, dtype=None, device=None):
    """(model, config) of a local model directory: an HF-style snapshot
    (train_config.json + pytorch_model.bin), or a run directory of the port
    or of the reference trainer (train_config.json or report.json +
    best_model.pth).  The model holds its weights in ``dtype`` (default
    float32, the JAX package's teacher type) on ``device`` (default: the
    CUDA card), in eval mode with no gradients."""
    config, weights = load_run_dir(teacher_dir)
    model = build_model(config, dtype=dtype or torch.float32, device=device)
    model.load_state_dict(weights, strict=True)
    return prepare_teacher(model), config


def student_config_from_teacher(teacher_config, student_kind: str, **overrides) -> dict:
    """The student's train config: the teacher's head / metadata /
    augmentation / optimizer settings with the backbone kind swapped.
    Keyword overrides win (e.g. epochs, learning_rate, distill_alpha,
    distill_temperature)."""
    cfg = dict(teacher_config)
    cfg["model_kind"] = student_kind
    cfg.pop("pretrained", None)          # no timm weights for the student kinds
    cfg.pop("backbone_checkpoint", None)
    cfg.update(overrides)
    return normalize_config(cfg)


def distill_to_student(
    teacher_dir: str | None = None,
    teacher=None,
    teacher_config=None,
    student_kind: str = "inceptionnext_pico",
    student_config=None,
    device=None,
    **train_kwargs: Any,
):
    """Distill a trained teacher into a student; returns ``run_training``'s
    result dict (history, model_dir, summaries, ...).

    Give ``teacher_dir`` (loaded by :func:`load_teacher` on ``device``) or a
    loaded ``teacher`` model with ``teacher_config``.  ``student_config``
    replaces the derived config entirely; otherwise it is the teacher's with
    ``model_kind=student_kind``.  ``train_kwargs`` pass through to
    :func:`engine.train.run_training` (datasets, run_name, mesh, logger,
    ...); under a ``mesh`` the teacher is sharded by the student's rules
    (engine.steps)."""
    from .train import run_training

    if teacher is None:
        if teacher_dir is None:
            raise ValueError("need teacher_dir or a loaded teacher model")
        teacher, teacher_config = load_teacher(teacher_dir, device=device)
    elif teacher_config is None and student_config is None:
        raise ValueError("a loaded teacher needs teacher_config "
                         "(to derive the student) or student_config")
    if student_config is None:
        student_config = student_config_from_teacher(teacher_config, student_kind)
    return run_training(student_config, teacher=teacher, device=device, **train_kwargs)
