"""Loss functions (port of btsbot_tpu.engine.loss).

The reference trains every model with class-weighted binary cross-entropy on
logits, ``BCEWithLogitsLoss(pos_weight=num_notbts/num_bts)`` (reference
train.py:211-212), here in float32 in the log-sigmoid form, as the JAX
package computes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             pos_weight=1.0) -> torch.Tensor:
    """Mean of −[w·y·log σ(x) + (1−y)·log(1−σ(x))]."""
    logits = logits.reshape(-1).float()
    labels = labels.reshape(-1).float()
    per_example = -(pos_weight * labels * F.logsigmoid(logits)
                    + (1.0 - labels) * F.logsigmoid(-logits))
    return per_example.mean()


def binary_kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                   temperature: float = 2.0) -> torch.Tensor:
    """Binary knowledge distillation: the temperature-softened student logit
    against the teacher's softened probability (no gradient to the teacher),
    scaled by T²."""
    z = student_logits.reshape(-1).float() / temperature
    soft = torch.sigmoid(teacher_logits.reshape(-1).float() / temperature).detach()
    return temperature * temperature * weighted_bce_with_logits(z, soft, 1.0)


def binary_accuracy(scores: torch.Tensor, labels: torch.Tensor,
                    threshold: float = 0.5) -> torch.Tensor:
    """Fraction of (score > threshold) == label."""
    preds = (scores.reshape(-1) > threshold).float()
    return (preds == labels.reshape(-1).float()).float().mean()
