"""Train state + optimizer (port of btsbot_tpu.engine.state).

The optimizer is the reference's: AdamW with the config's betas, eps 1e-8
and decoupled weight decay 0.01 on every parameter, biases, norms and γ
included (reference train.py:242-246).  ``torch.optim.AdamW`` has the
semantics of the JAX package's ``optax.adamw``; the LR of each update is
set by the train step from ``lr_schedule`` (engine.schedule).

``TrainState`` holds what a step changes: the model (float32 parameters and
the BatchNorm statistics), the optimizer, the update count and the
generator that augmentation and dropout draw from.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from ..models.common import set_dropout_generator
from .schedule import make_lr_schedule


def make_optimizer(config, params) -> torch.optim.AdamW:
    if config["model_name"] == "frozen_fusion":
        raise NotImplementedError(
            "frozen_fusion's frozen-branch mask is not ported yet (ROADMAP "
            "Queue A item 7)")
    return torch.optim.AdamW(
        params, lr=float(config["learning_rate"]),
        betas=(float(config["beta_1"]), float(config["beta_2"])),
        eps=1e-8, weight_decay=0.01)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    generator: torch.Generator   # reseeded from (seed, step) every step
    seed: int
    step: int = 0                # optimizer updates taken


def create_train_state(config, model: nn.Module, steps_per_epoch: int,
                       seed: int | None = None) -> TrainState:
    """A train state over ``model`` (its parameters float32, on their
    device); its dropout layers draw from the state's generator."""
    seed = int(config.get("random_seed", 0)) if seed is None else seed
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    set_dropout_generator(model, generator)
    return TrainState(model=model,
                      optimizer=make_optimizer(config, model.parameters()),
                      lr_schedule=make_lr_schedule(config, steps_per_epoch),
                      generator=generator, seed=seed)
