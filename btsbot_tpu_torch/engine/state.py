"""Train state + optimizer (port of btsbot_tpu.engine.state).

The optimizer is the reference's: AdamW with the config's betas, eps 1e-8
and decoupled weight decay 0.01 on every parameter, biases, norms and γ
included (reference train.py:242-246).  ``torch.optim.AdamW`` has the
semantics of the JAX package's ``optax.adamw``; the LR of each update is
set by the train step from ``lr_schedule`` (engine.schedule).

``frozen_fusion`` freezes its two branches (the JAX package's
``optax.set_to_zero`` on ``image_branch`` / ``meta_branch``): AdamW takes
only the combined head's parameters, since a parameter in torch's AdamW is
decayed even where its gradient is zero, and the branches' parameters stop
asking for gradients.  The whole model still runs in train mode, so the
branches' BatchNorm statistics move and their dropout is live, as in JAX.

``TrainState`` holds what a step changes: the model (float32 parameters and
the BatchNorm statistics), the optimizer, the update count and the
generator that augmentation and dropout draw from, and the mesh it trains
under (None: this process alone).  Under a mesh ``create_train_state``
shards the model's big weights on the model axis (parallel.sharding)
before AdamW is built, so AdamW keeps state for this rank's shards only,
and sets its BatchNorms and Dropouts to the global batch
(``models.common.set_data_parallel``).  The optimizer's parameters are in
the unsharded model's order under any mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from ..models.common import set_data_parallel, set_dropout_generator
from ..models.fusion import FROZEN_PREFIXES
from ..parallel.sharding import full_named_parameters, shard_module
from .schedule import make_lr_schedule


def trainable_parameters(config, model: nn.Module) -> list[nn.Parameter]:
    """The parameters the optimizer updates; for frozen_fusion the
    branches' are set to need no gradient and left out."""
    named = full_named_parameters(model)
    if config["model_name"] != "frozen_fusion":
        return [p for _, p in named]
    params = []
    for name, p in named:
        if name.startswith(FROZEN_PREFIXES):
            p.requires_grad_(False)
        else:
            params.append(p)
    return params


def make_optimizer(config, params) -> torch.optim.AdamW:
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
    mesh: Any = None             # parallel.mesh.Mesh, or None


def create_train_state(config, model: nn.Module, steps_per_epoch: int,
                       seed: int | None = None, mesh=None) -> TrainState:
    """A train state over ``model`` (its parameters float32, on their
    device); its dropout layers draw from the state's generator.  Under
    ``mesh`` the model is sharded in place first (its weights must be the
    same on every rank)."""
    seed = int(config.get("random_seed", 0)) if seed is None else seed
    shard_module(model, mesh)
    set_data_parallel(model, mesh)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    set_dropout_generator(model, generator)
    return TrainState(model=model,
                      optimizer=make_optimizer(config, trainable_parameters(config, model)),
                      lr_schedule=make_lr_schedule(config, steps_per_epoch),
                      generator=generator, seed=seed, mesh=mesh)
