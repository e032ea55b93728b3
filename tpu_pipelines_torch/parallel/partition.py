"""Parameter partitions, the port of ``tpu_pipelines/parallel/partition.py``.

A partition maps each parameter name (``model.named_parameters()``'s, as
``models/convert.py`` maps the reference's paths onto) to a spec: a tuple
with one entry per dim, each None or a mesh axis name (or a tuple of
names), as the reference's ``PartitionSpec``; ``()`` is replicated.  Rule
lists are ``(regex, spec)`` pairs, matched with ``re.search`` against the
name, first match wins.

Parameters are sharded over ``data`` for ``dp_collective="fsdp"``:
:func:`gather_leaf` all-gathers a shard back to full size along its spec's
dim inside the forward, and its backward is the reduce-scatter of the
gradient (the transpose the reference gets from autodiff).  Over the other
axes a module built on the mesh holds its rank's slice already: an MoE
layer its experts over ``expert``, attention its heads and the MLP its
columns over ``model`` (``models/transformer.py``), BERT's token
embedding and MLM head and T5's shared embedding their vocabulary rows
and T5's relative-position tables their heads over ``model``
(``models/bert.py``, ``models/t5.py``), the staged classifier its stage over ``pipe``
(``models/staged.py``).  Such a module marks its slices
(:func:`hold_slices`): a state dict of the whole parameter loads into the
slice, :func:`draw_whole` initialises the whole and keeps the slice, and
:func:`gather_slices` makes the module whole again.  The train loop keeps
their gradients on their rank and gathers them for checkpoints.  A spec
entry naming an axis of size 1 is replicated (:func:`effective_spec`), so
:func:`bert_partition_rules` and :func:`t5_partition_rules` serve every
mesh.  A parameter may be held in slices over two axes at once: an MoE
expert weight holds its experts over ``expert`` and its ff columns over
``model``.
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
    """name -> shape of a module's parameters (the whole parameter's where
    the module holds a slice, :func:`hold_slices`) or of a name -> tensor
    (or shape) mapping."""
    if isinstance(params, nn.Module):
        return whole_shapes(params)
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


def effective_spec(spec: Spec, mesh) -> Spec:
    """``spec`` with every axis of size 1 on ``mesh`` dropped (replicated);
    ``()`` when nothing is left."""
    out = []
    for entry in tuple(spec):
        kept = tuple(a for a in _axes(entry) if int(mesh.shape.get(a, 1)) > 1)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out) if any(e is not None for e in out) else ()


def effective_partition(partition: Mapping[str, Spec], mesh) -> Dict[str, Spec]:
    return {name: effective_spec(spec, mesh) for name, spec in partition.items()}


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
        # [.., W, L/W, ..] -> [W * d0, ...]: rank blocks along dim 0, the
        # layout gloo checks (NCCL reads only the element count).
        split = full.reshape(*shape[:dim], world, *shape[dim:])
        full = split.movedim(dim, 0).reshape(world * shape[0], *shape[1:])
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


def shard_of(full: torch.Tensor, dim: Optional[int], mesh, axis: str = "data"
             ) -> torch.Tensor:
    """This rank's contiguous shard of ``full`` along ``dim`` over mesh
    axis ``axis`` (all of it for None)."""
    if dim is None:
        return full
    k = full.shape[dim] // mesh.axis_size(axis)
    return full.narrow(dim, mesh.axis_rank(axis) * k, k)


# ---- slices held by a module built on a mesh
#
# ``module._slices`` maps a leaf name to {axis: (dim, group)}: the leaf is
# this rank's contiguous block along ``dim`` over each axis it is split
# over (an MoE expert weight: its experts over ``expert`` and its ff
# columns over ``model``).

def _group_rank(group) -> Tuple[int, int]:
    if group is None:
        return 1, 0
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


def hold_slices(module: nn.Module, slices: Mapping[str, Tuple[int, Any]],
                axis: str = "model") -> None:
    """Mark ``module``'s parameters ``slices`` (leaf name -> (dim, group))
    as this rank's contiguous block along ``dim`` of a parameter split
    over mesh axis ``axis`` (``group``, its process group; None: whole).
    A leaf may be marked over several axes, each along its own dim.  A
    state dict holding the whole parameter then loads into the block."""
    held = {leaf: (int(dim), group) for leaf, (dim, group) in slices.items()
            if group is not None}
    if not held:
        return
    if not hasattr(module, "_slices"):
        module._slices = {}
        module._register_load_state_dict_pre_hook(_take_slices, with_module=True)
    for leaf, entry in held.items():
        module._slices.setdefault(leaf, {})[axis] = entry


def _take_slices(module, state_dict, prefix, *args):
    for leaf, axes in getattr(module, "_slices", {}).items():
        key = prefix + leaf
        t = state_dict.get(key)
        local = getattr(module, leaf)
        if t is None or t.dim() != local.dim():
            continue
        for dim, group in axes.values():
            n, rank = _group_rank(group)
            k = local.shape[dim]
            if t.shape[dim] == k * n:
                t = t.narrow(dim, rank * k, k)
        state_dict[key] = t


def whole_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """name -> the whole parameter's shape, for every parameter of
    ``model`` (a held slice's dims times their axes' sizes)."""
    out, seen = {}, set()
    for prefix, module in model.named_modules():
        held = getattr(module, "_slices", {})
        for leaf, p in module.named_parameters(recurse=False):
            if id(p) in seen:
                continue
            seen.add(id(p))
            shape = [int(d) for d in p.shape]
            for dim, group in held.get(leaf, {}).values():
                shape[dim] *= _group_rank(group)[0]
            out[f"{prefix}.{leaf}" if prefix else leaf] = tuple(shape)
    return out


def slice_group(module: nn.Module, leaf: str, axis: str = "model") -> Any:
    """The group of ``axis`` where ``module.<leaf>`` is split over it, else
    None."""
    held = getattr(module, "_slices", {}).get(leaf, {}).get(axis)
    return held[1] if held is not None else None


def held_slices(model: nn.Module, name: str) -> Dict[str, Tuple[int, Any]]:
    """{axis: (dim, group)} of parameter ``name`` for every axis its
    module holds a slice of it over ({} for a whole parameter)."""
    owner, _, leaf = name.rpartition(".")
    module = model.get_submodule(owner) if owner else model
    return dict(getattr(module, "_slices", {}).get(leaf, {}))


def gather_whole(t: torch.Tensor, held: Mapping[str, Tuple[int, Any]]
                 ) -> torch.Tensor:
    """``t`` (a slice as :func:`held_slices` describes it) gathered whole
    over each of its axes: a collective on every rank of them."""
    for dim, group in held.values():
        t = all_gather_dim(t, dim, group)
    return t


@torch.no_grad()
def draw_whole(module: nn.Module, leaf: str, draw) -> None:
    """``draw`` (an in-place initialiser) applied to the whole parameter
    ``leaf`` and this rank's block kept, so every rank draws what one
    process draws; a whole parameter is drawn in place."""
    p = getattr(module, leaf)
    held = getattr(module, "_slices", {}).get(leaf)
    if not held:
        draw(p)
        return
    shape = list(p.shape)
    for dim, group in held.values():
        shape[dim] *= _group_rank(group)[0]
    whole = p.new_empty(shape)
    draw(whole)
    for dim, group in held.values():
        k = p.shape[dim]
        whole = whole.narrow(dim, _group_rank(group)[1] * k, k)
    p.copy_(whole)


@torch.no_grad()
def gather_slices(module: nn.Module) -> None:
    """Make ``module``'s held slices whole: each gathered over its axes (a
    collective on every rank of them), so the module computes alone."""
    for leaf, axes in getattr(module, "_slices", {}).items():
        p = getattr(module, leaf)
        p.data = gather_whole(p.data, axes)
    module._slices = {}


# ---- rule tables over the port's names (the reference's
# TRANSFORMER_PARTITION_RULES carried through models/convert.py's layouts:
# a Linear weight is the flax kernel transposed, [out, in]; the MoE
# experts keep the flax layout, [E, d, ff] and [E, ff, d]).

EXPERT_PARTITION_RULES: List[Tuple[str, Spec]] = [
    # MoE experts over `expert` (EP), their ff dim over `model` (TP); the
    # router replicates (tiny).
    (r"\.moe\.wi$", ("expert", None, "model")),
    (r"\.moe\.wo$", ("expert", "model", None)),
]

TRANSFORMER_PARTITION_RULES: List[Tuple[str, Spec]] = [
    (r"\.(query|key|value)\.weight$", ("model", None)),
    (r"\.attn\.out\.weight$", (None, "model")),
    (r"\.cross\.out\.weight$", (None, "model")),
    (r"\.mlp\.wi\.weight$", ("model", None)),
    (r"\.mlp\.wo\.weight$", (None, "model")),
    *EXPERT_PARTITION_RULES,
    # token embeddings only (vocab dim); positional/type tables replicate.
    (r"(^|\.)(embed|shared)\.weight$", ("model", None)),
]


def bert_partition_rules() -> List[Tuple[str, Spec]]:
    """The rules of ``tpu_pipelines/models/bert.py`` over the port's names
    (first match wins), on a ``model`` axis above 1 (Megatron's split:
    q/k/v, MLP ``wi``, the token embedding and the MLM head
    column-parallel, attention ``out`` and MLP ``wo`` row-parallel) and on
    an ``expert`` axis; replicated on axes of 1."""
    return list(TRANSFORMER_PARTITION_RULES) + [
        (r"(^|\.)mlm_head\.weight$", ("model", None)),
    ]


def t5_partition_rules() -> List[Tuple[str, Spec]]:
    """The rules of ``tpu_pipelines/models/t5.py`` over the port's names:
    the transformer blocks' Megatron split, the shared embedding (with the
    tied logits) over its vocabulary rows and each stack's
    relative-position table over its heads, on a ``model`` axis above 1;
    replicated on axes of 1."""
    return list(TRANSFORMER_PARTITION_RULES) + [
        (r"\.rel_pos\.rel_embedding$", (None, "model")),
    ]
