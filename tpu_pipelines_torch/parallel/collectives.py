"""Differentiable exchanges over one mesh axis (the port's counterparts of
the ``lax`` collectives the reference emits inside ``shard_map``).

Each is a ``torch.autograd.Function`` over the process group of one axis
(``DeviceMesh.axis_group``), whose backward is the forward's transpose,
so gradients follow the reference's autodiff:

  - :func:`ppermute` sends this rank's tensor along ``perm`` (``(src,
    dst)`` pairs of axis ranks); a rank no pair sends to receives zeros,
    as ``lax.ppermute`` gives.  Backward: the inverse permutation.
  - :func:`all_to_all` splits a dim into one chunk per rank, sends chunk
    j to rank j and concatenates what arrives along another dim, in rank
    order (``lax.all_to_all(..., tiled=True)``).  Backward: the same
    exchange with the two dims swapped.
  - :func:`all_gather` concatenates every rank's tensor along a dim.
    Backward: the reduce-scatter (each rank keeps the sum of its block).
  - :func:`broadcast` gives every rank the source rank's tensor.
    Backward: the sum of the gradients, on the source (zero elsewhere).
  - :func:`enter_partial` / :func:`leave_partial` bracket a region whose
    ranks each compute a part of a replicated result (expert parallelism:
    a rank's experts; tensor parallelism: Megatron's *f* and *g* around a
    rank's heads or MLP columns; a pipeline's stages): identity forward
    with the all-reduce backward, and the all-reduce forward with the
    identity backward.  A replicated loss then gives every rank the whole
    gradient of the shared parameters, and each part's own parameters
    their whole gradient on their rank.
  - :func:`leave_split` is :func:`leave_partial` for a result split
    along a dim rather than summed (vocabulary-parallel logits): the
    all-gather forward, and this rank's block of the gradient backward.

The point-to-point exchanges are built on ``dist.all_to_all_single``
with per-rank split sizes (zero for ranks a tensor does not go to): gloo
carries it on CPU and CUDA tensors, and NCCL runs it as grouped sends and
receives.  With no group (an axis of 1) each is the identity and
launches nothing.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from tpu_pipelines_torch.parallel.partition import all_gather_dim, reduce_scatter_dim


def axis_world(group: Any) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def axis_rank(group: Any) -> int:
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def _send_recv(x: torch.Tensor, dst: Any, src: Any, group: Any) -> torch.Tensor:
    """``x`` to axis rank ``dst`` (None: nowhere) and, back, the tensor of
    ``x``'s shape that axis rank ``src`` sent (None: zeros)."""
    import torch.distributed as dist

    n = axis_world(group)
    numel = x.numel()
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty(numel if src is not None else 0)
    dist.all_to_all_single(
        out, flat if dst is not None else flat[:0],
        output_split_sizes=[numel if j == src else 0 for j in range(n)],
        input_split_sizes=[numel if j == dst else 0 for j in range(n)],
        group=group)
    if src is None:   # nothing arrives (the first rank of a shift)
        return torch.zeros_like(x)
    return out.view(x.shape)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, grad):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permute(grad, inverse, ctx.group), None, None


def _permute(x, perm, group):
    me = axis_rank(group)
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    return _send_recv(x, dst, src, group)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group: Any) -> torch.Tensor:
    """``lax.ppermute`` over ``group``: see the module docstring."""
    if group is None:
        return x
    return _Permute.apply(x, tuple((int(s), int(d)) for s, d in perm), group)


def _exchange(x: torch.Tensor, split_dim: int, concat_dim: int,
              group: Any) -> torch.Tensor:
    import torch.distributed as dist

    n = axis_world(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} not divisible "
                         f"by the axis size {n}")
    inp = torch.stack(x.chunk(n, split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(list(out.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _exchange(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _exchange(grad, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group: Any) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over
    ``group``."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim % x.dim(), concat_dim % x.dim(), group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """``lax.all_gather(x, axis=dim, tiled=True)`` over ``group``."""
    if group is None:
        return x
    return _AllGather.apply(x, dim % x.dim(), group)


def _all_reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        import torch.distributed as dist

        ctx.src, ctx.group = src, group
        out = x.contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce(grad, ctx.group)
        if axis_rank(ctx.group) != ctx.src:
            total = torch.zeros_like(total)
        return total, None, None


def broadcast(x: torch.Tensor, src: int, group: Any) -> torch.Tensor:
    """Axis rank ``src``'s ``x`` on every rank of ``group`` (every rank
    passes a tensor of the same shape)."""
    if group is None:
        return x
    return _Broadcast.apply(x, int(src), group)


class _EnterPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _LeavePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter_partial(x: torch.Tensor, group: Any) -> torch.Tensor:
    """A replicated value entering a region of partial results: identity
    forward, all-reduce of the gradient backward."""
    if group is None:
        return x
    return _EnterPartial.apply(x, group)


def leave_partial(x: torch.Tensor, group: Any) -> torch.Tensor:
    """A rank's partial result summed over ``group`` into the replicated
    value: all-reduce forward, identity backward."""
    if group is None:
        return x
    return _LeavePartial.apply(x, group)


class _LeaveSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        k = ctx.size
        return grad.narrow(ctx.dim, axis_rank(ctx.group) * k, k), None, None


def leave_split(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """A rank's block of a replicated value, split along ``dim``, gathered
    whole: all-gather forward, this rank's block of the gradient backward
    (every rank holds the whole gradient of a replicated value)."""
    if group is None:
        return x
    return _LeaveSplit.apply(x, dim % x.dim(), group)


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """``[(i, (i + 1) % n)]``: each rank to the next."""
    return [(i, (i + 1) % n) for i in range(n)]
