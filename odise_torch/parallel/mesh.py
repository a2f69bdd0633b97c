"""The (data, model) mesh on ``torch.distributed`` (counterpart of
``odise_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh: the batch
is sharded over ``data``, and the large frozen towers' weights may be
sharded over ``model``, which XLA all-gathers where they are used. The port
lays its ranks out the same way, rank ``d * model + m`` at ``(d, m)``:

* ``create_mesh(data, model)`` makes this rank's data group (the ranks of
  its column, which share the batch out) and model group (the ranks of its
  row, which see the same batch and hold the towers between them), and
  makes the data group the axis every collective of ``parallel/multihost.py``
  reduces over. At ``model=1`` the data group is the default group, and
  nothing changes.
* ``batch_sharding(mesh)`` is the data axis's (rank, size): the slice of
  the batch, the loader's shard and the evaluation's records this rank
  takes. ``replicated(mesh)`` is the whole world's group.
* ``param_sharding_rule`` chooses JAX's leaves: a frozen tower's parameter
  of two or more dimensions whose flax last dimension divides by the model
  size and is at least twice it. That dimension is torch's dimension 0
  for a Dense or Conv kernel (``model_zoo/from_jax.py`` transposes them)
  and the last one for everything else.
* ``shard_params(model, mesh)`` keeps this rank's contiguous slice of each
  chosen parameter, so that the whole tensor is freed, and gathers the
  slices over the model group into the whole weight just before the
  owning module's forward, dropping it just after. The gather passes no
  gradient to the frozen slice; the activations' gradients flow through
  the gathered weight as through the whole one (autograd keeps it for the
  backward where an op saves it), and a forward that
  ``torch.utils.checkpoint`` recomputes in the backward gathers again.
  Every parameter the towers hold is read inside its owning module's
  forward, which is what lets the gather sit in its hooks.

Checkpoints are unaffected: ``engine/checkpoint.py`` saves only the
trainable parameters, which are never sharded, and the frozen towers are
loaded (``model_zoo``) before they are sharded.

The ranks of one model group must run the same forwards in the same order,
as they gather together: they take the same batch, and evaluate the same
records. Every caller in the JAX package passes ``model=1``; so does
``train_net``. The model axis exists for a card that cannot hold the
towers whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .multihost import get_rank, get_world_size, set_data_axis

__all__ = ["DATA_AXIS", "FROZEN_TOWER_KEYWORDS", "MODEL_AXIS", "Mesh", "batch_sharding",
           "create_mesh", "flax_last_dim", "is_frozen_path", "param_sharding_rule",
           "replicated", "shard_params", "sharding_plan"]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# parameter-path keywords of the frozen towers, whose weights may be sharded
# over the model axis (the JAX package's list), matched against every part
# of a parameter's name
FROZEN_TOWER_KEYWORDS = ("vae", "unet", "sd_text", "clip_visual", "_text_enc",
                         "text_encoder", "clip_head")


def is_frozen_path(path: Tuple[str, ...]) -> bool:
    return any(any(k in comp for k in FROZEN_TOWER_KEYWORDS) for comp in path)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` x ``model`` layout of the ranks; ``rank`` sits at
    ``(rank // model, rank % model)``. The groups are None where their axis
    is the default group (``data_group`` at ``model=1``) or a single rank."""

    data: int
    model: int
    rank: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh over every rank of the process group (one rank
    before ``initialize_multihost``); ``data=-1`` takes the ranks that
    ``model`` leaves. Every rank calls it, with the same sizes: it makes
    the groups collectively. Makes the mesh's data axis the one the
    collectives of ``parallel/multihost.py`` reduce over."""
    n, rank = get_world_size(), get_rank()
    if data == -1:
        if model < 1 or n % model:
            raise ValueError(f"{n} ranks do not split into model groups of {model}")
        data = n // model
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    data_group = model_group = None
    if model > 1:
        # every rank makes every group, in one order (new_group is collective)
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            group = dist.new_group(ranks) if data > 1 else None
            if rank in ranks:
                data_group = group
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            group = dist.new_group(ranks)
            if rank in ranks:
                model_group = group
    mesh = Mesh(data, model, rank, data_group, model_group)
    set_data_axis(None if model == 1 else (data_group, mesh.data_rank, data))
    return mesh


def batch_sharding(mesh: Mesh) -> Tuple[int, int]:
    """(this rank's place on the data axis, the axis's size): the slice of
    the batch it takes, as JAX shards the batch's leading dimension."""
    return mesh.data_rank, mesh.data


def replicated(mesh: Mesh) -> Optional[dist.ProcessGroup]:
    """The group every rank belongs to (the default group, None)."""
    return None


def flax_last_dim(owner: nn.Module, name: str, leaf: torch.Tensor) -> int:
    """The torch dimension of ``owner``'s parameter ``name`` that holds the
    flax leaf's last dimension: 0 for a Dense or Conv ``kernel``, which
    the port transposes (``model_zoo/from_jax.py``); the last otherwise
    (an ``embedding``, a ``scale``, a raw parameter)."""
    if name == "weight" and isinstance(owner, (nn.Linear, nn.Conv2d)):
        return 0
    return leaf.ndim - 1


def param_sharding_rule(path: Tuple[str, ...], leaf: torch.Tensor, mesh: Mesh,
                        dim: int = -1) -> Optional[int]:
    """The dimension of ``leaf`` to shard over ``model``, or None to keep it
    whole on every rank: JAX's rule, frozen leaves of two or more
    dimensions whose flax last dimension (torch's ``dim``, from
    ``flax_last_dim``) divides by the model size and is at least twice it."""
    model_size = mesh.shape[MODEL_AXIS]
    if model_size > 1 and is_frozen_path(path) and leaf.ndim >= 2:
        dim = dim % leaf.ndim
        if leaf.shape[dim] % model_size == 0 and leaf.shape[dim] >= 2 * model_size:
            return dim
    return None


def sharding_plan(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Parameter name -> the dimension ``shard_params`` shards, for every
    parameter ``param_sharding_rule`` chooses (any device, ``meta``
    too)."""
    plan = {}
    for mod_name, owner in model.named_modules():
        for name, p in owner.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            dim = param_sharding_rule(tuple(full.split(".")), p, mesh,
                                      flax_last_dim(owner, name, p))
            if dim is not None:
                plan[full] = dim
    return plan


class _GatherShards(torch.autograd.Function):
    """The whole weight from every model rank's slice along ``dim``; the
    frozen slice gets no gradient."""

    @staticmethod
    def forward(ctx, shard, dim, size, group):
        # as bytes: gloo, which the ranks sharing one card use, has no
        # collective for every dtype
        raw = shard.contiguous().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(size)]
        dist.all_gather(parts, raw, group=group)
        return torch.cat(parts, dim).view(shard.dtype)

    @staticmethod
    def backward(ctx, grad):
        return None, None, None, None


class _GatherOnUse:
    """Forward hooks of one module: its sharded parameters gathered whole
    just before its forward and the slices put back just after (on an
    error too)."""

    def __init__(self, dims: Dict[str, int], mesh: Mesh):
        self.dims, self.mesh = dims, mesh
        self.slices: Dict[str, nn.Parameter] = {}

    def before(self, module, args):
        for name, dim in self.dims.items():
            shard = module._parameters[name]
            self.slices[name] = shard
            # a plain tensor where the parameter was, for this forward only
            module._parameters[name] = _GatherShards.apply(
                shard, dim, self.mesh.model, self.mesh.model_group)

    def after(self, module, args, output):
        module._parameters.update(self.slices)
        self.slices.clear()


def shard_params(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Shard ``model``'s frozen towers over ``mesh``'s model axis in place
    (see the module's docstring): each chosen parameter becomes this rank's
    contiguous slice along its dimension, frozen, and its owning module
    gathers it on use. Load the weights first. Returns the plan (name ->
    dimension); at ``model=1`` it is empty and nothing changes."""
    plan = sharding_plan(model, mesh)
    if not plan:
        return plan
    owners: Dict[str, Dict[str, int]] = {}
    for full, dim in plan.items():
        mod_name, _, name = full.rpartition(".")
        owners.setdefault(mod_name, {})[name] = dim
    for mod_name, dims in owners.items():
        owner = model.get_submodule(mod_name)
        for name, dim in dims.items():
            whole = owner._parameters[name]
            part = whole.shape[dim] // mesh.model
            shard = whole.detach().narrow(dim, mesh.model_rank * part, part)
            owner._parameters[name] = nn.Parameter(
                shard.clone(memory_format=torch.contiguous_format), requires_grad=False)
        hooks = _GatherOnUse(dims, mesh)
        owner.register_forward_pre_hook(hooks.before)
        owner.register_forward_hook(hooks.after, always_call=True)
    return plan
