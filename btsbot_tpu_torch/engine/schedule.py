"""Learning-rate schedule: linear warmup → cosine annealing, per epoch
(port of btsbot_tpu.engine.schedule).

The reference's ``SequentialLR([LinearLR(start_factor=0.01),
CosineAnnealingLR(T_max=epochs−warmup, eta_min=lr·0.01)])`` stepped once per
epoch (reference train.py:249-260,332): the LR is constant within an epoch.
The arithmetic is float32, in the JAX package's order; the cosine is
computed in float64 and rounded once, which keeps every LR within 1e-7 of
XLA's float32 one (numpy's float32 cosine is an ulp off near eta_min).
"""

from __future__ import annotations

import math

import numpy as np


def lr_at_epoch(epoch: int, base_lr: float, total_epochs: int,
                warmup_epochs: int = 0, start_factor: float = 0.01,
                eta_min_factor: float = 0.01) -> float:
    f32 = np.float32  # every constant explicit: no promotion to float64
    epoch = f32(epoch)
    warmup = f32(max(warmup_epochs, 0))
    # torch LinearLR factor after `epoch` steps (clamped at total_iters)
    t = min(epoch, max(warmup, f32(1)))
    warm_lr = f32(base_lr) * (f32(start_factor)
                              + f32(1 - start_factor) * t / max(warmup, f32(1)))
    t_max = f32(max(1, total_epochs - warmup_epochs))
    eta_min = base_lr * eta_min_factor
    cos_t = max(epoch - warmup, f32(0))
    cos_lr = f32(eta_min) + f32(base_lr - eta_min) * f32(0.5) * (
        f32(1) + f32(math.cos(f32(math.pi) * cos_t / t_max)))
    return float(warm_lr if epoch < warmup else cos_lr)


def make_lr_schedule(config, steps_per_epoch: int):
    """The LR of optimizer update ``step`` (0-based): the epoch's LR, as
    optax evaluates a schedule at the update count before the update."""
    base_lr = float(config["learning_rate"])
    total_epochs = int(config["epochs"])
    warmup_epochs = int(config.get("warmup_epochs", 0))

    def schedule(step: int) -> float:
        return lr_at_epoch(step // max(1, steps_per_epoch), base_lr,
                           total_epochs, warmup_epochs)

    return schedule
