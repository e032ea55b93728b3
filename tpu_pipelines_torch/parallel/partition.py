"""Parameter partitions, the port of ``tpu_pipelines/parallel/partition.py``.

A partition maps each parameter name (``model.named_parameters()``'s, as
``models/convert.py`` maps the reference's paths onto) to a spec: a tuple
with one entry per dim, each None or a mesh axis name (or a tuple of
names), as the reference's ``PartitionSpec``; ``()`` is replicated.  Rule
lists are ``(regex, spec)`` pairs, matched with ``re.search`` against the
name, first match wins.

The port shards over ``data`` only, for ``dp_collective="fsdp"``:
:func:`gather_leaf` all-gathers a shard back to full size along its spec's
dim inside the forward, and its backward is the reduce-scatter of the
gradient (the transpose the reference gets from autodiff).  A spec naming
another axis (the tensor-parallel rules :func:`bert_partition_rules` and
:func:`t5_partition_rules`, over ``model``) waits for ``ROADMAP.md`` A6:
the train loop refuses it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

Spec = Tuple[Any, ...]
Rules = Sequence[Tuple[str, Spec]]


def path_str(path) -> str:
    """'encoder.layers.0.attn.query.weight' style name for a sequence of
    keys (a name passes through)."""
    if isinstance(path, str):
        return path
    return ".".join(str(p) for p in path)


def _named_shapes(params: Any) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of a module's parameters or of a name -> tensor (or
    shape) mapping."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    out = {}
    for name, leaf in params.items():
        shape = getattr(leaf, "shape", leaf)
        out[path_str(name)] = tuple(int(d) for d in shape)
    return out


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_dim(spec: Spec, axis: str = "data") -> Optional[int]:
    """The dim ``spec`` shards over ``axis``, or None."""
    for dim, entry in enumerate(spec):
        if axis in _axes(entry):
            return dim
    return None


def make_param_partition(params: Any, rules: Rules) -> Dict[str, Spec]:
    """name -> spec for ``params`` (a module or a name -> tensor mapping);
    unmatched names replicate."""
    compiled = [(re.compile(rx), tuple(spec)) for rx, spec in rules]

    def spec_for(name: str) -> Spec:
        for rx, spec in compiled:
            if rx.search(name):
                return spec
        return ()

    return {name: spec_for(name) for name in _named_shapes(params)}


def fsdp_param_partition(params: Any, mesh, *, axis: str = "data") -> Dict[str, Spec]:
    """The default ZeRO-3 partition for ``dp_collective="fsdp"``: each
    parameter sharded over ``axis`` along its first dim that is >= the
    axis size and divisible by it; others replicate (all of them on an
    axis of 1).  An explicit ``param_partition`` overrides it."""
    n = int(mesh.shape[axis])

    def spec_for(shape) -> Spec:
        if n > 1:
            for dim, d in enumerate(shape):
                if d >= n and d % n == 0:
                    return (None,) * dim + (axis,)
        return ()

    return {name: spec_for(shape) for name, shape in _named_shapes(params).items()}


def foreign_axis_paths(params: Any, partition: Mapping[str, Spec], *,
                       axis: str = "data") -> List[str]:
    """Parameter names whose spec names a mesh axis other than ``axis``:
    fsdp shards over ``data`` only, and the train loop turns these into an
    error."""
    out: List[str] = []
    for name in _named_shapes(params):
        spec = tuple(partition.get(name, ()))
        if any(a != axis for entry in spec for a in _axes(entry)):
            out.append(f"{name}: {spec}")
    return out


def validate_partition(params: Any, partition: Mapping[str, Spec], mesh) -> List[str]:
    """Human-readable problems: a spec's axis sizes not dividing its dim."""
    problems = []
    for name, shape in _named_shapes(params).items():
        for dim, entry in enumerate(tuple(partition.get(name, ()))):
            axes = _axes(entry)
            if not axes:
                continue
            size = 1
            for a in axes:
                size *= int(mesh.shape[a])
            if dim >= len(shape) or shape[dim] % size:
                problems.append(
                    f"{name}: dim {dim} of {shape} not divisible by mesh "
                    f"axes {axes} (size {size})"
                )
    return problems


# ---- the fsdp collectives

def all_gather_dim(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shards of every rank concatenated along ``dim``, in rank order
    (a tiled all-gather).  ``all_gather_into_tensor`` stacks on dim 0, so
    a shard of dim > 0 is gathered into ``[W, ...]`` and moved."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    shard = shard.contiguous()
    out = shard.new_empty((world * shard.shape[0], *shard.shape[1:]))
    dist.all_gather_into_tensor(out, shard, group=group)
    if dim == 0:
        return out
    stacked = out.reshape(world, *shard.shape).movedim(0, dim)
    shape = list(shard.shape)
    shape[dim] *= world
    return stacked.reshape(shape)


def reduce_scatter_dim(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ranks of ``full``, of which this rank keeps its shard
    along ``dim`` (the transpose of :func:`all_gather_dim`)."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    shape = list(full.shape)
    shape[dim] //= world
    if dim:
        split = full.reshape(*shape[:dim], world, *shape[dim:])
        full = split.movedim(dim, 0)
    out = full.new_empty(shape)
    dist.reduce_scatter_tensor(out, full.contiguous(), group=group)
    return out


class GatherLeaf(torch.autograd.Function):
    """A parameter shard gathered to full size (forward) and the gradient
    reduce-scattered back to the shard (backward): the sum over ranks of
    each rank's local gradient slice, which the train loop scales to the
    mean.  The node keeps the shard, dim and group (``shard``, ``dim``,
    ``group``) so a saved-tensor hook can gather again in the backward
    instead of holding the full weight."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.shard, ctx.dim, ctx.group = shard, dim, group
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


def gather_leaf(x: torch.Tensor, spec: Spec, mesh, *, axis: str = "data"
                ) -> torch.Tensor:
    """``x`` gathered to full size along the dim ``spec`` shards over
    ``axis``; identity for a replicated leaf or a mesh with no group."""
    dim = spec_dim(spec, axis)
    if dim is None or mesh.group is None:
        return x
    return GatherLeaf.apply(x, dim, mesh.group)


def shard_of(full: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """This rank's contiguous shard of ``full`` along ``dim`` (all of it
    for None)."""
    if dim is None:
        return full
    k = full.shape[dim] // mesh.size
    return full.narrow(dim, mesh.rank * k, k)


# ---- rule tables over the port's names (the reference's
# TRANSFORMER_PARTITION_RULES carried through models/convert.py's layouts:
# a Linear weight is the flax kernel transposed, [out, in]).  Its MoE rules
# have no port: the port has no MoE layer.

TRANSFORMER_PARTITION_RULES: List[Tuple[str, Spec]] = [
    (r"\.(query|key|value)\.weight$", ("model", None)),
    (r"\.attn\.out\.weight$", (None, "model")),
    (r"\.cross\.out\.weight$", (None, "model")),
    (r"\.mlp\.wi\.weight$", ("model", None)),
    (r"\.mlp\.wo\.weight$", (None, "model")),
    # token embeddings only (vocab dim); positional/type tables replicate.
    (r"(^|\.)(embed|shared)\.weight$", ("model", None)),
]


def bert_partition_rules() -> List[Tuple[str, Spec]]:
    """Tensor-parallel rules of ``tpu_pipelines/models/bert.py`` over the
    port's names (first match wins).  They name ``model``: the train loop
    refuses them until ROADMAP.md A6."""
    return list(TRANSFORMER_PARTITION_RULES) + [
        (r"(^|\.)mlm_head\.weight$", ("model", None)),
    ]


def t5_partition_rules() -> List[Tuple[str, Spec]]:
    """Tensor-parallel rules of ``tpu_pipelines/models/t5.py`` over the
    port's names; refused like :func:`bert_partition_rules`."""
    return list(TRANSFORMER_PARTITION_RULES) + [
        (r"\.rel_pos\.rel_embedding$", (None, "model")),
    ]
