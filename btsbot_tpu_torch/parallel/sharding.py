"""Parameter sharding over the mesh's model axis (port of
btsbot_tpu.parallel.sharding).

The JAX package's rule (sharding.py:22-35 there): a flax leaf with ndim ≥
2, at least 2^16 elements and a last (output-feature) axis divisible by
the model size is sharded on that axis; everything else is replicated.
The port shards the torch tensor on the dimension the weight bridge
(``interop.weights``) maps that axis to: dim 0 of a ``Linear`` weight
(out, in) and of a conv weight (O, I, kh, kw); the last dim of a MaxViT
relative-position bias table, which the bridge copies as it is.

``shard_module`` keeps only this rank's shard of each such weight (so
AdamW keeps state for the shard alone) and registers a parametrization in
its place: reading ``module.weight`` all-gathers the shards over the model
group, and the gradient of that read is reduce-scattered back, averaged
over the group (its ranks compute on the same rows, so each holds the
same whole gradient).  A kernel wrapper such as ``convnext_block_fused``
therefore sees the whole weight, as a Pallas call does under a JAX mesh.

Checkpoints hold whole tensors under the reference names:
``full_state_dict`` gathers, ``load_full_state_dict`` slices back, and
the optimizer's state is converted the same way.  ``full_named_parameters``
keeps the unsharded module's parameter order, so an optimizer's state
lines up with and without a mesh.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

from .mesh import all_gather_rows, reduce_scatter_rows

# Don't bother sharding tiny leaves — replication is cheaper than the
# collectives it would induce.
_MIN_SHARDED_SIZE = 1 << 16


def _flax_last_axis(name: str, ndim: int) -> int:
    """The torch dim the weight bridge fills from the flax leaf's last axis."""
    return ndim - 1 if name.endswith("relative_position_bias_table") else 0


def param_spec(name: str, param, model_size: int) -> int | None:
    """The dim ``param`` is sharded on over the model axis, or None
    (replicated)."""
    if model_size > 1 and param.ndim >= 2 and param.numel() >= _MIN_SHARDED_SIZE:
        dim = _flax_last_axis(name, param.ndim)
        if param.shape[dim] % model_size == 0:
            return dim
    return None


class _AllGather(torch.autograd.Function):
    """Whole tensor from the model group's shards; the gradient is
    reduce-scattered back and divided by the group's size."""

    @staticmethod
    def forward(ctx, shard, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return all_gather_rows(shard.movedim(dim, 0), group, size).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        g = reduce_scatter_rows(grad.movedim(ctx.dim, 0), ctx.group, ctx.size)
        return g.div_(ctx.size).movedim(0, ctx.dim), None, None, None


class GatherShard(nn.Module):
    """The parametrization of a sharded weight: ``original`` is this rank's
    shard along ``dim``."""

    def __init__(self, dim: int, group, size: int, index: int):
        super().__init__()
        self.dim, self.group, self.size, self.index = dim, group, size, index

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _AllGather.apply(shard, self.dim, self.group, self.size)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor."""
        k = full.shape[self.dim] // self.size
        return full.narrow(self.dim, self.index * k, k).clone()

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """A whole tensor of the weight's layout (optimizer state), no autograd."""
        return all_gather_rows(shard.movedim(self.dim, 0), self.group,
                               self.size).movedim(0, self.dim).contiguous()


def _sharded(module: nn.Module) -> dict[str, tuple[nn.Module, str, GatherShard]]:
    """full name → (owning module, parameter name, its GatherShard)."""
    out = {}
    for prefix, m in module.named_modules():
        if parametrize.is_parametrized(m):
            for pname, plist in m.parametrizations.items():
                if isinstance(plist[0], GatherShard):
                    out[f"{prefix}.{pname}" if prefix else pname] = (m, pname, plist[0])
    return out


def _full_name(name: str) -> str:
    """``a.parametrizations.weight.original`` → ``a.weight``."""
    head, sep, tail = name.partition("parametrizations.")
    return head + tail[:-len(".original")] if sep else name


def full_named_parameters(module: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """(reference name, parameter) in the unsharded module's order; a
    sharded weight's parameter is its shard."""
    params = {_full_name(n): p for n, p in module.named_parameters()}
    order = getattr(module, "unsharded_parameter_order", None) or list(params)
    return [(n, params[n]) for n in order]


def module_shardings(module: nn.Module, mesh) -> dict[str, int]:
    """The parameters sharded on the mesh's model axis: reference name →
    the dim they are split on."""
    done = _sharded(module)
    if done:
        return {name: g.dim for name, (_, _, g) in done.items()}
    m = mesh.shape["model"]
    specs = {name: param_spec(name, p, m) for name, p in module.named_parameters()}
    return {name: dim for name, dim in specs.items() if dim is not None}


def shard_module(module: nn.Module, mesh) -> nn.Module:
    """Keep this rank's shard of each weight ``module_shardings`` names
    (in place; the module's weights must be the same on every rank).
    A no-op at model size 1 and on a module already sharded."""
    if mesh is None or mesh.shape["model"] == 1 or _sharded(module):
        return module
    specs = module_shardings(module, mesh)
    if specs:
        module.unsharded_parameter_order = [n for n, _ in module.named_parameters()]
    for name, dim in specs.items():
        owner_name, _, pname = name.rpartition(".")
        parametrize.register_parametrization(
            module.get_submodule(owner_name), pname,
            GatherShard(dim, mesh.model_group, mesh.shape["model"], mesh.model_index),
            unsafe=True)
    return module


def full_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """The state dict under the reference names with whole tensors (every
    rank of each model group must call it: the shards are gathered)."""
    sharded = _sharded(module)
    out = {}
    with torch.no_grad():
        for name, value in module.state_dict().items():
            full = _full_name(name)
            if full in sharded:
                owner, pname, _ = sharded[full]
                value = getattr(owner, pname)
            out[full] = value
    return out


def load_full_state_dict(module: nn.Module, state_dict, strict: bool = True):
    """Load a whole-tensor, reference-named state dict, keeping this rank's
    shard of each sharded weight."""
    sharded = _sharded(module)
    local = {}
    for name, value in state_dict.items():
        if name in sharded:
            owner_prefix = name.rpartition(".")[0]
            pname = sharded[name][1]
            key = (f"{owner_prefix}." if owner_prefix else "") + \
                f"parametrizations.{pname}.original"
            local[key] = sharded[name][2].right_inverse(torch.as_tensor(value))
        else:
            local[name] = value
    return module.load_state_dict(local, strict=strict)


def _optimizer_shards(optimizer, module) -> dict[int, GatherShard]:
    """optimizer state index → the GatherShard of a sharded parameter."""
    by_param = {id(owner.parametrizations[pname].original): g
                for owner, pname, g in _sharded(module).values()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: by_param[id(p)] for i, p in enumerate(params) if id(p) in by_param}


def full_optimizer_state(optimizer, module) -> dict:
    """``optimizer.state_dict()`` with each sharded parameter's state
    (AdamW's moments) gathered into whole tensors."""
    sd = optimizer.state_dict()
    for i, g in _optimizer_shards(optimizer, module).items():
        if i in sd["state"]:  # a new dict: the packed one is the live state's
            sd["state"][i] = {k: g.gather(v) if torch.is_tensor(v) and v.ndim > 0 else v
                              for k, v in sd["state"][i].items()}
    return sd


def load_full_optimizer_state(optimizer, module, state_dict) -> None:
    """Load a whole-tensor optimizer state (``full_optimizer_state``'s
    layout), keeping this rank's shard of each sharded parameter's state."""
    shards = _optimizer_shards(optimizer, module)
    state = {}
    for i, st in state_dict["state"].items():
        g = shards.get(int(i))
        state[i] = {k: g.right_inverse(v) if g is not None and torch.is_tensor(v)
                    and v.ndim > 0 else v for k, v in st.items()}
    optimizer.load_state_dict({**state_dict, "state": state})
