"""Pipeline parallelism, the port of
``tpu_pipelines/parallel/pipeline_parallel.py``: GPipe's microbatched
schedule over the mesh ``pipe`` axis.

A network of S stages with one code and S parameter sets (a stage is a
group of transformer blocks, ``models/staged.py``) runs with stage s's
parameters on pipe rank s alone.  The batch splits into M microbatches;
at tick t (M + S - 1 ticks) rank s runs microbatch t - s, the fill, steady
and drain diagonal of the reference's scan, and hands its output to rank
s + 1 with one non-cyclic ``collectives.ppermute``.  The bubble is the
usual (S - 1) / (M + S - 1) of a rank's ticks.

As in the reference, every rank runs its stage at every tick: stage 0
ingests microbatch min(t, M - 1) (the drain ticks' clamped re-ingest),
the later stages what the previous rank handed them, and outputs outside
the diagonal are computed and dropped.  So every rank issues the same
exchanges in the same order, and every hand-off's output feeds the graph
on every rank: stage 0 selects its input with ``torch.where``, which
gives the received tensor a zero gradient, and the ranks but the last
pass their outputs through ``torch.where`` into zeros.  Autograd then
runs every exchange's backward, the inverse permutation, on every rank,
in the reverse order of the ticks.  A hand-off whose output no rank
reads (the last tick's) is not issued.

The input is replicated over ``pipe`` and enters through
``collectives.enter_partial``: its gradient, which arises on stage 0
alone, is all-reduced, so every rank holds it whole (the embedding before
the pipeline then takes one process's gradient on every rank).  The last
stage's outputs leave through ``collectives.leave_partial`` (the other
ranks add zeros, so the sum is the last stage's outputs bit for bit):
every rank holds them and computes the same head and loss, and the
identity backward hands the last stage the one gradient of that
replicated loss.  (``collectives.broadcast``'s backward sums the ranks'
gradients: with a loss every rank computes alike, that is S times the
gradient.)
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from tpu_pipelines_torch.parallel import collectives

# stage_fn(stage_params, activation [mb, ...]) -> activation [mb, ...]
StageFn = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def gpipe(
    stage_fn: StageFn,
    stage_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    mesh: Any,
    num_microbatches: int,
    axis: str = "pipe",
    batch_axis: str = "data",
) -> torch.Tensor:
    """Apply S pipelined stages to ``x`` as if run in order.

    ``stage_params``: name -> tensor with a leading stage dim, this rank's
    stage (``[1, ...]``) on a ``pipe`` axis of S > 1, the one stage
    (``[1, ...]``) on an axis of 1.  ``x``: this rank's rows of the batch
    (``[b, ...]``, the same on every pipe rank), split into
    ``num_microbatches`` equal microbatches along dim 0.  Returns
    ``stage_S-1(... stage_0(x))`` on every pipe rank.  Raises the
    reference's ``ValueError`` when the global batch does not divide into
    the microbatches, or a microbatch over the mesh's ``batch_axis``."""
    s = mesh.axis_size(axis) if mesh is not None else 1
    m = int(num_microbatches)
    b = x.shape[0]
    dp = mesh.axis_size(batch_axis) if mesh is not None else 1
    if (b * dp) % m:
        raise ValueError(f"batch {b * dp} not divisible by microbatches {m}")
    mb = b * dp // m
    if mb % dp:
        raise ValueError(
            f"microbatch size {mb} not divisible by mesh axis {batch_axis}={dp}")
    micro = x.reshape(m, b // m, *x.shape[1:])
    params = {k: v[0] for k, v in stage_params.items()}

    if s == 1:
        return torch.cat([stage_fn(params, micro[i]) for i in range(m)])

    group = mesh.axis_group(axis)
    idx = mesh.axis_rank(axis)
    perm = [(i, i + 1) for i in range(s - 1)]   # non-cyclic shift forward
    first = torch.tensor(idx == 0, device=x.device)
    micro = collectives.enter_partial(micro, group)
    act = torch.zeros_like(micro[0])
    outs = []
    ticks = m + s - 1
    for t in range(ticks):
        y = stage_fn(params, torch.where(first, micro[min(t, m - 1)], act))
        if t >= s - 1:   # the last stage finishes microbatch t - (s - 1)
            outs.append(y)
        if t < ticks - 1:
            act = collectives.ppermute(y, perm, group)
    out = torch.stack(outs)
    # The other ranks add zeros, and keep their outputs in the graph (with
    # a zero gradient) so that their hand-offs' backwards run.
    last = torch.tensor(idx == s - 1, device=x.device)
    out = collectives.leave_partial(torch.where(last, out, torch.zeros_like(out)),
                                    group)
    return out.reshape(b, *x.shape[1:])
