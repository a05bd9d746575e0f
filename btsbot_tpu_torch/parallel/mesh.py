"""The (data, model) process mesh (port of btsbot_tpu.parallel.mesh).

The JAX mesh is single-controller: one process sees every device and XLA
inserts the collectives.  PyTorch runs SPMD instead, one process (a rank)
per device, so the port's mesh is a layout of ranks with the two process
groups the collectives run over:

* rank ``r`` sits at ``(data_index, model_index) = divmod(r, model)``, the
  order of the JAX package's ``devices.reshape(data, model)``;
* ``data_group``: the ranks of one model index (one per data shard).  The
  batch is split over it, and the gradient mean, the BatchNorm statistics
  and the gathered scores run over it;
* ``model_group``: the ranks of one data index.  They see the same rows; a
  big weight is stored in shards over it and gathered where it is used
  (parallel.sharding).

``initialize_distributed`` starts the process group (the JAX package's
``jax.distributed.initialize``); ``make_mesh`` raises until it has run.
Each rank's device is ``cuda:{LOCAL_RANK}`` unless the caller names one
(ranks that share a card name it).  The backend is the caller's choice:
``nccl`` on the card, ``gloo`` on the host and for ranks that share a card
(gloo takes CUDA tensors and copies them through the host).
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A (data, model) layout of the process group's ranks."""

    def __init__(self, data: int, model: int, ranks: Sequence[int]):
        self.shape = {"data": data, "model": model}
        self.ranks = list(ranks)
        self.rank = dist.get_rank()
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not on the mesh {self.ranks}")
        self.data_index, self.model_index = divmod(self.ranks.index(self.rank), model)
        # every rank creates every group, in one order (torch's rule for new_group)
        grid = np.asarray(self.ranks).reshape(data, model)
        self.data_group = self.model_group = None
        for j in range(model):
            group = _group(grid[:, j].tolist())
            if j == self.model_index:
                self.data_group = group
        for i in range(data):
            group = _group(grid[i].tolist())
            if i == self.data_index:
                self.model_group = group
        self.local_rank = int(os.environ.get("LOCAL_RANK", self.rank))

    @property
    def device(self) -> torch.device:
        """This rank's default device: ``cuda:{LOCAL_RANK}``."""
        return torch.device("cuda", self.local_rank)

    def barrier(self) -> None:
        dist.barrier()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at data {self.data_index}, "
                f"model {self.model_index})")


def _group(ranks: list[int]):
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (the ranks, in mesh
    order; default every rank).  Defaults to all of them on the data axis.
    Every rank calls it with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "btsbot_tpu_torch.parallel.initialize_distributed(...) first (or run "
            "under torchrun, which sets the environment it reads)")
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if ranks != sorted(set(ranks)):
        # a group's ranks are in ascending order, and so must the mesh's be
        raise ValueError(f"mesh devices {ranks} are not ascending ranks")
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(data, model, ranks)


class BatchSharding:
    """This rank's rows of a global batch: ``sharding(x)`` slices the
    leading axis (numpy or torch); the batch must split evenly over the data
    axis."""

    def __init__(self, mesh: Mesh):
        self.index, self.size = mesh.data_index, mesh.shape["data"]

    def rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over the mesh data "
                             f"axis ({self.size})")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def __call__(self, x):
        return None if x is None else x[self.rows(len(x))]


class Replicated:
    """The inverse of ``BatchSharding``: ``replicated(local)`` all-gathers
    every rank's rows over the data group, in data order."""

    def __init__(self, mesh: Mesh):
        self.group, self.size = mesh.data_group, mesh.shape["data"]

    def __call__(self, local: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(local, self.group, self.size)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard the leading batch axis across the data axis."""
    return BatchSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


# torch 2.13 renames the tensor collectives (*_single); older releases
# have only the *_tensor names
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; its gradient is the sum of the ranks'
    gradients (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(local: torch.Tensor, group, size: int) -> torch.Tensor:
    """Concatenate every rank's ``local`` (equal shapes) on dim 0, in rank
    order within ``group``."""
    local = local.contiguous()
    out = local.new_empty((size * local.shape[0],) + tuple(local.shape[1:]))
    _all_gather_single(out, local, group=group)
    return out


def reduce_scatter_rows(full: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum over ``group`` of ``full``, each rank keeping its 1/size of
    dim 0."""
    full = full.contiguous()
    out = full.new_empty((full.shape[0] // size,) + tuple(full.shape[1:]))
    _reduce_scatter_single(out, full, group=group)
    return out


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           heartbeat_timeout_seconds: int | None = None,
                           backend: str = "nccl") -> None:
    """Start this process's rank of the process group; one call per
    process before ``make_mesh``.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` set the rendezvous by hand: process 0 listens on the
    port.  Without them the rank, the world size and the address come from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), and
    without that environment this process is a group of one.
    ``heartbeat_timeout_seconds`` becomes the group's ``timeout``: how long
    a collective waits on a peer before it fails (a dead rank makes the
    others raise, not hang).  ``backend``: ``nccl`` on the card (the
    default), ``gloo`` on the host or for ranks that share one card."""
    kwargs = {}
    if heartbeat_timeout_seconds is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=heartbeat_timeout_seconds)
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                **kwargs)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        store = dist.TCPStore("localhost", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, world_size=1, rank=0, **kwargs)
