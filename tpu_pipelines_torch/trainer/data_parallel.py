"""The data-parallel step of ``train_loop``: the port of the reference's
``_make_dp_forward_backward`` (``tpu_pipelines/trainer/train_loop.py``).

One process per device; the ``data`` axis of the mesh is the process group
(``parallel/mesh.py``).  Every process keeps its contiguous rows of the
global batch, runs forward and backward on them, and the gradient exchange
is one of the reference's modes (``TrainLoopConfig.dp_collective``):

  * ``""`` (None or "auto", the reference's implicit GSPMD): after the
    backward, one all-reduce of every gradient, flattened, then the mean;
  * ``psum_bucketed``: gradient leaves, in the order JAX flattens a dict
    of them (names sorted part by part), are dealt round-robin into
    ``collective_buckets`` buckets (``leaves[i::k]``); a post-accumulate-
    grad hook starts one all-reduce of a bucket's flat buffer as soon as
    the bucket's last gradient is accumulated, so bucket k's exchange
    overlaps the rest of the backward;
  * ``ordered``: the global micro-batch is split into G = ``dp_grad_blocks``
    contiguous blocks and rank r owns blocks [r G/W, (r+1) G/W); each
    owned block's gradient, loss and metrics come from a forward and a
    backward of their own, the [G/W, ...] stacks are all-gathered into
    [G, ...] and summed over dim 0 in block order (one ``torch.sum``), then
    scaled by 1/G.  Every world size computes the same blocks and reduces
    them with the same op on the same [G, ...] tensor, so the result is
    bitwise invariant to W (the backward kernels add without atomics);
  * ``fsdp`` (ZeRO-3): each parameter is held as this rank's shard
    (``parallel/partition.py``'s ``fsdp_param_partition``, or an explicit
    ``param_partition`` over ``data``), through a parametrization that
    gathers it just in time in the forward (``gather_leaf``, one
    collective per leaf); a ``saved_tensors_hooks`` pair keeps a gathered
    weight (or its cast, or a view of either) out of the saved tensors and
    gathers it again in the backward, the counterpart of the reference's
    ``jax.checkpoint`` policy; gradients leave the gather's backward as
    reduce-scattered shards, so AdamW steps on shards and its moments are
    shards too.  Replicated leaves (no dim divisible by W) are all-reduced.

``grad_accum_steps`` composes with every mode: micro-batch i is every
a-th row of the local batch.  psum and the implicit mode exchange once
per outer step (gradients accumulate in ``.grad``); ordered exchanges per
micro-batch and adds the micro results in a fixed order; fsdp
reduce-scatters inside each micro backward into shard-sized gradients.
Loss and metrics follow each mode's reduction.

Models with state (``has_model_state``): floating buffers are averaged
over ``data`` after the step (sync-BN) in ``""``, psum and fsdp; ordered
runs each block from the micro-batch's starting state and averages the
blocks' states in block order.  Integer buffers pass through.

Sequence, expert, tensor and pipeline parallelism ride the implicit mode
(``""``), as in the reference.  A ``batch_partition`` splitting token
features over ``seq`` cuts each rank's rows to its block of the sequence
(``parallel.mesh.sequence_block``) and sets ``seq_split`` on the loop's
mesh and on every mesh the model holds, for the run; on a mesh whose
``seq`` axis is above 1 every gradient is averaged over ``seq`` after
``data`` (each rank's loss is one term of the objective, see
``models/bert.py``), and so are the loss and metrics.  The implicit mode
also sets ``whole_batch`` on those meshes: a rank's loss is then its share
of the whole batch's, as the reference's GSPMD loss is one over the global
batch (a masked mean's count and the MoE aux loss's token means are summed
over ``data``, ``models.transformer.batch_groups``).  A
``param_partition`` spec over ``expert``, ``model`` or ``pipe`` marks a
parameter whose module holds this rank's slice (built on the mesh: an MoE
layer its experts over ``expert`` and their ff columns over ``model``;
attention its heads, the MLP its columns, BERT's and T5's embeddings
their vocabulary rows and T5's relative-position tables their heads over
``model``; the staged classifier its stage over ``pipe``); ``held`` maps
each parameter a
module holds a slice of (``parallel.partition.hold_slices``, with a spec
or without one) to the axes it is split over.  Over
``expert``, ``model`` and ``pipe`` the model's exchanges
(``parallel/collectives.py``) leave every replicated parameter's gradient
whole on every rank and each slice's own gradient whole on its rank, so
a slice is averaged over every axis above 1 but its own, and a replicated
parameter over all of them: over ``model`` and ``pipe`` (and ``expert``)
its copies' gradients are equal up to the order each rank summed them in
(an embedding's backward adds without a fixed order on the card), and the
mean keeps the copies equal bit for bit, so every rank computes one
model.  The loss and metrics are averaged the same way.  A checkpoint
gathers the slices (and their optimizer moments) over their axes, so it
does not depend on the mesh, and the returned model is whole.  The
explicit modes exchange over ``data`` alone and refuse a mesh with
another axis above 1.

A mesh with no process group (one process, nothing initialised) runs every
mode with the identity for each collective.
"""

from __future__ import annotations

import contextlib
import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_pipelines_torch.parallel.mesh import (
    DeviceMesh,
    local_rows,
    sequence_block,
)
from tpu_pipelines_torch.parallel.partition import (
    GatherLeaf,
    all_gather_dim,
    effective_partition,
    foreign_axis_paths,
    fsdp_param_partition,
    gather_slices,
    held_slices,
    shard_of,
    spec_dim,
    validate_partition,
)

# The axes a parameter may be held in slices over by its module (data:
# fsdp's shards, kept apart), in the order the loop averages and gathers.
SLICE_AXES = ("expert", "model", "pipe")

ENV_DP_COLLECTIVE = "TPP_DP_COLLECTIVE"
DP_MODES = ("auto", "psum_bucketed", "ordered", "fsdp")


def effective_dp_collective(config) -> str:
    """Resolve the exchange mode: config > TPP_DP_COLLECTIVE env > ''
    (the implicit mode).  'auto' normalizes to ''."""
    mode = config.dp_collective
    if mode is None:
        mode = os.environ.get(ENV_DP_COLLECTIVE, "").strip() or None
    if mode in (None, "", "auto"):
        return ""
    if mode not in DP_MODES:
        raise ValueError(f"dp_collective {mode!r}: expected one of {DP_MODES}")
    return mode


def _holds(model: nn.Module, name: str, axis: str, dim: int, group: Any) -> bool:
    """Whether ``name``'s module holds its slice along ``dim`` over
    ``axis`` (``group``'s ranks)."""
    held = held_slices(model, name).get(axis)
    if held is None or held[0] != dim or group is None:
        return False
    if held[1] is group:
        return True
    import torch.distributed as dist

    return dist.get_process_group_ranks(held[1]) == dist.get_process_group_ranks(group)


def jax_leaf_order(names: List[str]) -> List[str]:
    """``names`` in the order ``jax.tree_util`` flattens a nested dict of
    them: sorted part by part."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def _canonical(name: str) -> str:
    """A parametrized parameter's name as the plain module names it:
    'a.parametrizations.weight.original' -> 'a.weight'."""
    parts = name.split(".")
    if "parametrizations" in parts:
        i = parts.index("parametrizations")
        parts = parts[:i] + parts[i + 1:i + 2]
    return ".".join(parts)


_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a splitmix64 mix of
    ``(seed, step)``, so neighbouring steps and seeds draw unrelated
    streams.  Micro-batch i of a step draws from ``step_seed(s, i)``
    where ``s`` is the step's seed."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


class _Sharded(nn.Module):
    """The fsdp parametrization: the stored tensor is this rank's shard
    along ``dim``; reading the parameter gathers it (``GatherLeaf``)."""

    def __init__(self, dim: int, mesh: DeviceMesh):
        super().__init__()
        self.dim, self.mesh = dim, mesh

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return GatherLeaf.apply(shard, self.dim, self.mesh.group)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return shard_of(full, self.dim, self.mesh).clone()


class DataParallel:
    """The exchange of one mode on one mesh for one model (see the module
    docstring).  ``build`` validates the configuration with the
    reference's messages and, for fsdp, shards the model in place."""

    def __init__(self, mesh: DeviceMesh, mode: str, *, accum: int,
                 buckets: int, grad_blocks: int, has_model_state: bool,
                 batch_size: int):
        self.mesh = mesh
        self.mode = mode
        self.accum = accum
        self.buckets = max(1, int(buckets))
        self.grad_blocks = grad_blocks
        self.has_model_state = has_model_state
        self.batch_size = batch_size
        self.specs: Dict[str, Optional[int]] = {}   # fsdp: name -> dim
        self.held: Dict[str, Dict[str, int]] = {}   # name -> {axis: dim}
        self.batch_partition: Dict[str, Any] = {}
        self.splits_sequence = False
        self.canon_params: List[str] = []
        self.canon_keys: List[str] = []
        self._hooks: list = []
        self._armed = False
        self._pending: List[int] = []
        self._bucket_params: List[List[nn.Parameter]] = []
        self._bucket_of: Dict[int, int] = {}
        self._reduced: List[bool] = []

    # ---- construction

    @classmethod
    def build(cls, config, mesh: DeviceMesh, model: nn.Module, mode: str,
              has_model_state: bool) -> "DataParallel":
        accum = max(1, int(config.grad_accum_steps))
        n = mesh.size
        if config.batch_size % accum:
            raise ValueError(
                f"batch_size {config.batch_size} not divisible by "
                f"grad_accum_steps {accum}")
        if mode or n > 1:
            if config.batch_size % n:
                raise ValueError(
                    f"dp_collective={mode!r}: batch_size {config.batch_size} "
                    f"must be divisible by the mesh data axis ({n})")
            if accum > 1 and (config.batch_size // n) % accum:
                raise ValueError(
                    f"grad_accum_steps {accum} must divide the per-device "
                    f"batch ({config.batch_size} over data axis {n} = "
                    f"{config.batch_size // n} rows)")
        bp = dict(config.batch_partition or {})
        if mode and bp:
            raise ValueError(
                f"dp_collective={mode!r}: batch_partition (sequence-"
                "sharded inputs for ring attention) rides the implicit-"
                "GSPMD window — use dp_collective=None/'auto' for "
                "long-context configs; explicit collective modes shard "
                "the batch over 'data' only")
        others = {a: n for a, n in mesh.shape.items() if a != "data" and n > 1}
        if mode and others:
            raise ValueError(
                f"dp_collective={mode!r} exchanges over the mesh 'data' axis "
                f"only; a mesh with {others} rides the implicit mode "
                "(dp_collective=None/'auto')")
        if mode in ("psum_bucketed", "ordered") and config.param_partition is not None:
            raise ValueError(
                f"dp_collective={mode!r} keeps params replicated (pure data "
                "parallelism); param_partition requires dp_collective='fsdp' "
                "(params sharded over 'data') or the implicit mode "
                "(None/'auto') for expert-, tensor- and pipeline-parallel "
                "specs")
        grad_blocks = int(config.dp_grad_blocks or n)
        if mode == "ordered" and (
                grad_blocks % n or (config.batch_size // accum) % grad_blocks):
            raise ValueError(
                f"dp_grad_blocks {grad_blocks} must be a multiple of the mesh "
                f"data axis ({n}) and divide the per-microbatch global batch "
                f"({config.batch_size} / grad_accum_steps {accum} = "
                f"{config.batch_size // accum})")
        dp = cls(mesh, mode, accum=accum, buckets=config.collective_buckets,
                 grad_blocks=grad_blocks, has_model_state=has_model_state,
                 batch_size=config.batch_size)
        dp.canon_params = [name for name, _ in model.named_parameters()]
        dp.canon_keys = list(model.state_dict().keys())
        dp.batch_partition = bp
        dp.splits_sequence = mesh.axis_size("seq") > 1 and any(
            spec_dim(tuple(spec or ()), "seq") is not None for spec in bp.values())
        dp._set_layout(model, dp.splits_sequence, whole_batch=not mode)
        if not mode:
            dp._implicit_partition(config.param_partition, model)
        if mode == "fsdp":
            partition = (dict(config.param_partition)
                         if config.param_partition is not None
                         else fsdp_param_partition(model, mesh))
            foreign = foreign_axis_paths(model, partition)
            if foreign:
                raise ValueError(
                    "dp_collective='fsdp' shards params over the mesh 'data' "
                    "axis only; these param_partition specs name other axes "
                    "(expert-, tensor- and pipeline-parallel specs ride the "
                    "implicit mode, as in the reference):\n  "
                    + "\n  ".join(foreign))
            problems = validate_partition(model, partition, mesh)
            if problems:
                raise ValueError(
                    "param_partition does not fit this mesh; fix these rules "
                    "first:\n  " + "\n  ".join(problems))
            dp.specs = {name: spec_dim(tuple(partition.get(name, ())))
                        for name in dp.canon_params}
            dp._shard(model)
        if has_model_state:
            floats = {b.dtype for b in model.buffers() if b.is_floating_point()}
            if mode == "ordered" and len(floats) > 1:
                raise ValueError(
                    "dp_collective='ordered' averages the model state as one "
                    f"flat buffer: its floating buffers must share a dtype, "
                    f"not {sorted(map(str, floats))}")
        if mode == "ordered":
            dtypes = {p.dtype for p in model.parameters() if p.requires_grad}
            if len(dtypes) > 1:
                raise ValueError(
                    "dp_collective='ordered' gathers the gradients as one flat "
                    f"buffer: the parameters must share a dtype, not "
                    f"{sorted(map(str, dtypes))}")
        return dp

    def _implicit_partition(self, partition, model: nn.Module) -> None:
        """The implicit mode's ``param_partition``: specs over axes of 1
        replicate, ``data`` above 1 needs fsdp, ``expert``, ``model`` and
        ``pipe`` mark the parameters a module holds a slice of, which must
        be the module's own slice (built on the mesh), over one axis or
        several (an MoE expert weight over ``expert`` and ``model``).
        Every slice a module holds is
        ``held`` whatever its spec, and with no partition at all: a
        column-parallel layer's bias follows its weight (the reference's
        rules name the kernels and leave the biases to XLA)."""
        params = dict(model.named_parameters())
        if partition is not None:
            self._check_specs(partition, model, params)
        for name in params:
            for axis, (dim, _) in held_slices(model, name).items():
                if self.mesh.axis_size(axis) > 1:
                    self.held.setdefault(name, {})[axis] = dim

    def _check_specs(self, partition, model: nn.Module, params) -> None:
        problems = validate_partition(model, partition, self.mesh)
        partition = effective_partition(partition, self.mesh)
        over_data = [f"{n}: {s}" for n, s in partition.items()
                     if spec_dim(s, "data") is not None]
        if over_data:
            raise ValueError(
                "the implicit mode keeps params whole over 'data'; these "
                "param_partition specs shard them over it and require "
                "dp_collective='fsdp':\n  " + "\n  ".join(over_data))
        for name, spec in partition.items():
            axes = {a: d for a in SLICE_AXES if (d := spec_dim(spec, a)) is not None}
            if not axes or name not in params:
                continue
            self.held[name] = axes
            for axis, dim in axes.items():
                if not _holds(model, name, axis, dim, self.mesh.axis_group(axis)):
                    problems.append(
                        f"{name}: spec {spec} shards it over {axis!r} (size "
                        f"{self.mesh.axis_size(axis)}), but its module holds "
                        f"the whole {tuple(params[name].shape)} (build the model "
                        "with the mesh, so each rank holds its slice)")
        if problems:
            raise ValueError(
                "param_partition does not fit this mesh; fix these rules "
                "first:\n  " + "\n  ".join(problems))

    def _shard(self, model: nn.Module) -> None:
        from torch.nn.utils import parametrize

        modules = dict(model.named_modules())
        for name, dim in self.specs.items():
            if dim is None or self.mesh.group is None:
                continue
            owner, _, leaf = name.rpartition(".")
            parametrize.register_parametrization(
                modules[owner], leaf, _Sharded(dim, self.mesh), unsafe=True)

    def _set_layout(self, model: nn.Module, seq_split: bool,
                    whole_batch: bool) -> None:
        """The token layout the model sees (``seq_split``) and whether a
        rank's loss is its share of the whole batch's (``whole_batch``):
        on the loop's mesh and on every mesh the model's modules hold (one
        built apart from the loop's)."""
        meshes = [self.mesh] + [getattr(m, "mesh", None) for m in model.modules()]
        for mesh in {id(m): m for m in meshes if isinstance(m, DeviceMesh)}.values():
            mesh.seq_split, mesh.whole_batch = seq_split, whole_batch

    def parameters(self, model: nn.Module) -> List[nn.Parameter]:
        """The model's parameters in the order of the unsharded model's
        ``named_parameters()`` (under fsdp the shards), so the optimizer's
        state indexes the same parameters at every world size."""
        by_name = {_canonical(n): p for n, p in model.named_parameters()}
        return [by_name[n] for n in self.canon_params]

    def attach(self, model: nn.Module) -> None:
        """psum_bucketed: deal the gradient leaves into buckets and hook
        each parameter's gradient accumulation."""
        if self.mode != "psum_bucketed":
            return
        named = dict(zip(self.canon_params, self.parameters(model)))
        leaves = [named[n] for n in jax_leaf_order(list(named))
                  if named[n].requires_grad]
        k = max(1, min(self.buckets, len(leaves)))
        self._bucket_params = [leaves[i::k] for i in range(k)]
        self._bucket_of = {id(p): i for i, b in enumerate(self._bucket_params)
                           for p in b}
        for p in leaves:
            self._hooks.append(p.register_post_accumulate_grad_hook(self._on_grad))

    def detach(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def unshard(self, model: nn.Module) -> None:
        """Make every parameter whole again (a collective on every rank),
        for the model ``train_loop`` returns: fsdp's shards and every slice
        a module holds over ``expert``, ``model`` or ``pipe``; its meshes go back to whole rows,
        as its callers hold them."""
        from torch.nn.utils import parametrize

        self._set_layout(model, False, whole_batch=False)
        for module in model.modules():
            gather_slices(module)
        if self.mode != "fsdp":
            return
        for module in list(model.modules()):
            if parametrize.is_parametrized(module):
                for leaf in list(module.parametrizations.keys()):
                    parametrize.remove_parametrizations(
                        module, leaf, leave_parametrized=True)

    # ---- batches

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows: a global batch (``batch_size`` rows, or a
        short tail, padded with the validity mask as the reference pads)
        is cut to its contiguous rows; a batch of ``batch_size / W`` rows
        is taken as this rank's own (per-host input,
        ``per_host_input_config``).  A world of one takes the batch as
        it is.  Features the ``batch_partition`` splits over ``seq`` are
        then cut to this rank's block of the sequence."""
        n = self.mesh.size
        rows = len(np.asarray(next(iter(batch.values()))))
        if n > 1 and rows * n != self.batch_size:
            batch = local_rows(batch, self.mesh)
        return sequence_block(batch, self.mesh, self.batch_partition)

    def eval_block(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """An eval batch (whole on every rank) cut to this rank's block of
        the sequence, the layout of the step's batches."""
        return sequence_block(batch, self.mesh, self.batch_partition)

    def generator_count(self) -> int:
        blocks = self.grad_blocks // self.mesh.size if self.mode == "ordered" else 1
        return self.accum * blocks

    def seed_generators(self, generators: List[torch.Generator],
                        seed_of_step: int) -> None:
        """Micro-batch i draws from the step's seed mixed with i (the
        step's own seed when there is one micro-batch), every block of
        it from the same seed, as the reference folds ``i`` into the key
        and hands every block the same key."""
        per = len(generators) // self.accum
        for i in range(self.accum):
            seed = seed_of_step if self.accum == 1 else step_seed(seed_of_step, i)
            for g in generators[i * per:(i + 1) * per]:
                g.manual_seed(seed)

    # ---- collectives (the identity without a group)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh.group is not None:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.mesh.group)
        return t

    def _all_gather0(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh.group is None:
            return t
        return all_gather_dim(t, 0, self.mesh.group)

    def _groups(self, held=()) -> List[Tuple[Any, int]]:
        """The groups a value is averaged over: ``data``, ``seq``,
        ``expert``, ``model``, ``pipe``, but the axes ``held`` (those a
        slice's own gradient is split over)."""
        axes = ("data", "seq", "expert", "model", "pipe")
        return [(g, self.mesh.axis_size(a)) for a in axes
                if a not in held and (g := self.mesh.axis_group(a)) is not None]

    def seq_mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over ``seq`` (the identity without its group)."""
        group = self.mesh.axis_group("seq")
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(t, group=group)
            t.mul_(1.0 / self.mesh.axis_size("seq"))
        return t

    def _mean(self, t: torch.Tensor, held=()) -> torch.Tensor:
        import torch.distributed as dist

        for group, n in self._groups(held):
            dist.all_reduce(t, group=group)
            t.mul_(1.0 / n)
        return t

    # ---- the step

    def _micros(self, batch: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        if self.accum == 1:
            return [batch]
        return [{k: v[i::self.accum].contiguous() for k, v in batch.items()}
                for i in range(self.accum)]

    def step(self, model: nn.Module, loss_fn, batch: Dict[str, torch.Tensor],
             generators: List[torch.Generator], optimizer,
             keys: Optional[List[str]]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward, backward, exchange and optimizer update of one step on
        this rank's rows; returns the loss and metrics, reduced as the
        mode reduces gradients."""
        optimizer.zero_grad(set_to_none=True)
        if self.mode == "ordered":
            loss, metrics = self._ordered(model, loss_fn, batch, generators, keys)
        else:
            loss, metrics = self._summed(model, loss_fn, batch, generators)
        optimizer.step()
        return loss, metrics

    def _summed(self, model, loss_fn, batch, generators):
        params = self.parameters(model)
        l_sum, m_sum = None, None
        for i, mb in enumerate(self._micros(batch)):
            self._armed = (self.mode == "psum_bucketed" and i == self.accum - 1)
            if self._armed:
                self._pending = [len(b) for b in self._bucket_params]
                self._reduced = [False] * len(self._bucket_params)
            hooks = (torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
                     if self.mode == "fsdp" and self.mesh.group is not None
                     else contextlib.nullcontext())
            with hooks:
                loss, metrics = loss_fn(model, mb, generators[i])
            loss.backward()
            loss = loss.detach().float()
            metrics = {k: torch.as_tensor(v, device=loss.device).detach().float()
                       for k, v in metrics.items()}
            l_sum = loss if l_sum is None else l_sum + loss
            m_sum = metrics if m_sum is None else {k: m_sum[k] + v
                                                   for k, v in metrics.items()}
        self._armed = False
        if self.accum > 1:
            inv_a = 1.0 / self.accum
            l_sum = l_sum * inv_a
            m_sum = {k: v * inv_a for k, v in m_sum.items()}
        if self.mode == "psum_bucketed":
            for i, done in enumerate(self._reduced):
                if not done:  # a bucket some leaf of which got no gradient
                    self._reduce(self._bucket_params[i])
        elif self.mode == "fsdp":
            sharded, replicated = [], []
            for name, p in zip(self.canon_params, params):
                dim = self.specs.get(name)
                (sharded if dim is not None and self.mesh.group is not None
                 else replicated).append(p)
            inv = 1.0 / self.mesh.size
            for p in sharded:  # reduce-scattered sums over the ranks
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if self.accum > 1:
                    p.grad.mul_(1.0 / self.accum)
                p.grad.mul_(inv)
            if replicated:
                self._reduce([p for p in replicated if p.requires_grad])
        else:
            # Replicated parameters first, then each set of held axes in
            # the order its first parameter comes.
            by_axes: Dict[Tuple[str, ...], List[nn.Parameter]] = {(): []}
            for n, p in zip(self.canon_params, params):
                if p.requires_grad:
                    by_axes.setdefault(tuple(self.held.get(n, ())), []).append(p)
            for held, ps in by_axes.items():
                self._reduce(ps, held)
        keys = sorted(m_sum)
        row = self._mean(torch.stack([l_sum, *(m_sum[k] for k in keys)]))
        if self.has_model_state:
            self._sync_state(model)
        return row[0], {k: row[j + 1] for j, k in enumerate(keys)}

    def _on_grad(self, p: nn.Parameter) -> None:
        if not self._armed:
            return
        i = self._bucket_of[id(p)]
        self._pending[i] -= 1
        if self._pending[i] == 0:
            self._reduce(self._bucket_params[i])
            self._reduced[i] = True

    def _reduce(self, params: List[nn.Parameter], held=()) -> None:
        """One all-reduce of ``params``' gradients as a flat buffer, then
        the mean (scaled by 1/accum first, as the reference scales its
        accumulated sum), written back into ``.grad``.  Without a group
        only the 1/accum scale is left, in place (a gradient that is None
        stays None, so the optimizer skips its parameter)."""
        if not params:
            return
        if not self._groups(held):
            if self.accum > 1:
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(1.0 / self.accum)
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        if self.accum > 1:
            flat.mul_(1.0 / self.accum)
        self._mean(flat, held)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n

    def _sync_state(self, model: nn.Module) -> None:
        """Sync-BN: the floating buffers' mean over ``data`` (and every other
        axis above 1)."""
        if not self._groups():
            return
        groups: Dict[torch.dtype, list] = {}
        for b in model.buffers():
            if b.is_floating_point():
                groups.setdefault(b.dtype, []).append(b)
        for bufs in groups.values():
            flat = self._mean(torch.cat([b.detach().reshape(-1) for b in bufs]))
            offset = 0
            with torch.no_grad():
                for b in bufs:
                    b.copy_(flat[offset:offset + b.numel()].view_as(b))
                    offset += b.numel()

    def _ordered(self, model, loss_fn, batch, generators, keys):
        params = self.parameters(model)
        trained = [p for p in params if p.requires_grad]
        per_rank = self.grad_blocks // self.mesh.size
        inv = 1.0 / self.grad_blocks
        floats = ([b for b in model.buffers() if b.is_floating_point()]
                  if self.has_model_state else [])
        buffers = list(model.buffers()) if self.has_model_state else []
        acc = l_acc = None
        names: Optional[List[str]] = None
        for i, mb in enumerate(self._micros(batch)):
            rows = len(next(iter(mb.values())))
            size = rows // per_rank
            start = [b.detach().clone() for b in buffers] if per_rank > 1 else []
            g_rows, l_rows, s_rows = [], [], []
            for j in range(per_rank):
                block = {k: v[j * size:(j + 1) * size] for k, v in mb.items()}
                if j and start:
                    with torch.no_grad():
                        for b, s in zip(buffers, start):
                            b.copy_(s)
                loss, metrics = loss_fn(model, block, generators[i * per_rank + j])
                grads = torch.autograd.grad(loss, trained, allow_unused=True)
                g_rows.append(torch.cat([
                    (g if g is not None else torch.zeros_like(p)).reshape(-1)
                    for g, p in zip(grads, trained)]))
                if names is None:
                    names = sorted(metrics) if keys is None else list(keys)
                l_rows.append(torch.stack(
                    [loss.detach().float()]
                    + [torch.as_tensor(metrics[k], device=loss.device).detach()
                       .float().reshape(()) for k in names]))
                if floats:
                    s_rows.append(torch.cat([b.detach().reshape(-1) for b in floats]))
            g = torch.sum(self._all_gather0(torch.stack(g_rows)), dim=0).mul_(inv)
            l_m = torch.sum(self._all_gather0(torch.stack(l_rows)), dim=0).mul_(inv)
            if floats:
                s = torch.sum(self._all_gather0(torch.stack(s_rows)), dim=0).mul_(inv)
                offset = 0
                with torch.no_grad():
                    for b in floats:
                        b.copy_(s[offset:offset + b.numel()].view_as(b))
                        offset += b.numel()
            acc = g if acc is None else acc + g
            l_acc = l_m if l_acc is None else l_acc + l_m
        if self.accum > 1:
            acc = acc * (1.0 / self.accum)
            l_acc = l_acc * (1.0 / self.accum)
        offset = 0
        for p in trained:
            p.grad = acc[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return l_acc[0], {k: l_acc[j + 1] for j, k in enumerate(names)}

    # ---- fsdp: gather again in the backward

    def _pack(self, t: torch.Tensor):
        base = t._base if t._is_view() else t
        node = base.grad_fn
        if node is not None and type(node).__name__ == "ToCopyBackward0":
            node = node.next_functions[0][0]
        if node is None or not isinstance(node, GatherLeaf._backward_cls):
            return t
        return (node.shard, node.dim, node.group, base.dtype,
                tuple(t.shape), t.stride(), t.storage_offset())

    @staticmethod
    def _unpack(packed):
        if torch.is_tensor(packed):
            return packed
        shard, dim, group, dtype, shape, stride, offset = packed
        with torch.no_grad():
            full = all_gather_dim(shard.detach(), dim, group).to(dtype)
        return full.as_strided(shape, stride, offset)

    # ---- checkpoints (W-independent: the full, unsharded state)

    def _sharded_dims(self) -> Dict[str, List[Tuple[int, Any, int, int]]]:
        """name -> [(dim, group, axis size, axis rank), ...] of every
        parameter a rank holds a slice of: fsdp's shards over ``data``,
        then the slices over ``expert``, ``model`` and ``pipe``."""
        out: Dict[str, List[Tuple[int, Any, int, int]]] = {}
        if self.mode == "fsdp" and self.mesh.group is not None:
            for n, d in self.specs.items():
                if d is not None:
                    out[n] = [(d, self.mesh.group, self.mesh.size, self.mesh.rank)]
        for name, axes in self.held.items():
            for axis, dim in axes.items():
                group = self.mesh.axis_group(axis)
                if group is not None:
                    out.setdefault(name, []).append(
                        (dim, group, self.mesh.axis_size(axis),
                         self.mesh.axis_rank(axis)))
        return out

    def gathers_checkpoint(self) -> bool:
        """Whether a checkpoint needs every rank (the gathers of fsdp's
        shards or of the slices)."""
        return bool(self._sharded_dims())

    def full_payload(self, step: int, model: nn.Module, optimizer) -> Dict[str, Any]:
        """The checkpoint payload of the whole model: every slice
        (parameters and optimizer moments) gathered, a collective on every
        rank; otherwise the state as it is."""
        dims = self._sharded_dims()
        state = model.state_dict()
        opt = optimizer.state_dict()
        if not dims:
            return {"step": step, "model": state, "optimizer": opt}

        def whole(name, v):
            for dim, group, _, _ in dims[name]:
                v = all_gather_dim(v, dim, group)
            return v

        by_canon = {_canonical(k): v for k, v in state.items()}
        full = OrderedDict()
        with torch.no_grad():
            for key in self.canon_keys:
                v = by_canon[key]
                full[key] = whole(key, v) if key in dims else v
            shards = self.parameters(model)
            for idx, slots in opt["state"].items():
                name = self.canon_params[idx]
                if name not in dims:
                    continue
                shape = shards[idx].shape
                opt["state"][idx] = {
                    k: (whole(name, v)
                        if torch.is_tensor(v) and v.shape == shape else v)
                    for k, v in slots.items()}
        return {"step": step, "model": full, "optimizer": opt}

    def load_payload(self, model: nn.Module, optimizer, payload) -> None:
        """Restore a full payload, cutting this rank's slices."""
        dims = self._sharded_dims()
        if not dims:
            model.load_state_dict(payload["model"])
            optimizer.load_state_dict(payload["optimizer"])
            return

        def cut(name, v):
            for dim, _, n, rank in dims[name]:
                k = v.shape[dim] // n
                v = v.narrow(dim, rank * k, k)
            return v.contiguous()

        keys = {_canonical(k): k for k in model.state_dict()}
        model.load_state_dict({
            keys[name]: cut(name, v) if name in dims else v
            for name, v in payload["model"].items()})
        opt = payload["optimizer"]
        for idx, slots in opt["state"].items():
            name = self.canon_params[int(idx)]
            if name in dims:
                full_shape = payload["model"][name].shape
                opt["state"][idx] = {
                    k: (cut(name, v)
                        if torch.is_tensor(v) and v.shape == full_shape else v)
                    for k, v in slots.items()}
        optimizer.load_state_dict(opt)

    # ---- estimates

    def collective_fraction(self, model: nn.Module, local_batch_bytes: int) -> float:
        """The reference's ``_collective_fraction``: the share of a step's
        device span the exchange is estimated to take, from bytes: per step
        the exchange moves factor x (W-1)/W x param bytes (2 for an
        all-reduce, 3 for fsdp's gathers and reduce-scatter) against an
        HBM proxy of 3 x param bytes plus the local batch."""
        n = self.mesh.size
        if n <= 1:
            return 0.0
        dims = self._sharded_dims()
        param_bytes = sum(
            p.numel() * p.element_size()
            * int(np.prod([d[2] for d in dims.get(name, ())], dtype=np.int64))
            for name, p in zip(self.canon_params, self.parameters(model)))
        if param_bytes <= 0:
            return 0.0
        factor = 3.0 if self.mode == "fsdp" else 2.0
        coll = factor * (n - 1) / n * param_bytes
        hbm = 3.0 * param_bytes + local_batch_bytes
        return coll / max(coll + hbm, 1.0)

