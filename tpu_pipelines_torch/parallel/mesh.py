"""The mesh, the port of ``tpu_pipelines/parallel/mesh.py``.

One process per device.  :func:`make_mesh` lays the processes of the
default group out on the reference's axes (``AXES``, row-major, the last
axis fastest, as the reference reshapes its devices) and returns a
:class:`DeviceMesh`: this process's coordinate on every axis, one process
group per axis (the ranks that differ on that axis alone), the axis sizes
and the device.  ``data`` shards batch rows (gradients averaged over it),
``seq`` the sequence of a long-context batch (ring and Ulysses attention,
``parallel/ring_attention.py``), ``expert`` the experts of a
mixture-of-experts layer (``models/transformer.py``), ``model`` the heads,
MLP columns and vocabulary rows of a tensor-parallel model (Megatron's
split, ``models/transformer.py`` and ``models/bert.py``), ``pipe`` the
stages of a GPipe pipeline (``parallel/pipeline_parallel.py``).  Rows are
dealt over ``data`` alone: ranks that differ only on the other axes read
the same rows.

Where a batch is sequence-split (``shard_batch`` with a partition naming
``seq``, as the train loop does for ``batch_partition``), the mesh says so
in ``DeviceMesh.seq_split``, which the model reads: set, a rank's token
tensors hold its block of the sequence; unset (the default), whole rows.

The reference's ``data_parallel_sharding`` and ``replicate`` have no
counterpart: there are no global arrays to annotate.  Each process holds
its rows of the batch (:func:`shard_batch`) and a replica of the
parameters (or, under fsdp, its shards: ``parallel/partition.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_pipelines_torch.parallel.partition import spec_dim

# Canonical axis names, in fixed order: data = batch/DP, model = tensor
# parallelism, seq = sequence/context parallelism, expert = MoE expert
# parallelism, pipe = pipeline-stage parallelism.
AXES = ("data", "model", "seq", "expert", "pipe")


@dataclasses.dataclass
class MeshConfig:
    """Declarative mesh shape; unspecified axes default to 1."""

    data: int = -1      # -1 = all remaining devices
    model: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {"data": self.data, "model": self.model, "seq": self.seq,
                 "expert": self.expert, "pipe": self.pipe}
        fixed = math.prod(v for v in sizes.values() if v > 0)
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if free:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}"
                )
            sizes[free[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} does not cover {n_devices} devices"
            )
        return sizes


def data_coordinate(mesh: Optional["DeviceMesh"] = None) -> "tuple[int, int]":
    """(this process's coordinate on ``data``, the axis's size): what a
    ``run_fn`` deals its train rows over, as the reference shards its
    batch over ``data`` alone, so the ranks that differ only on the other
    axes read the same rows.  Without a mesh every process of the group is
    a data coordinate of its own."""
    if mesh is None:
        from tpu_pipelines_torch.parallel.distributed import process_topology

        return process_topology()
    return mesh.rank, mesh.size


@dataclasses.dataclass
class DeviceMesh:
    """The port's mesh.  ``group`` and ``rank`` are the ``data`` axis's
    process group (None where the axis holds this process alone and there
    is no group, whose collectives are the identity) and this process's
    coordinate on it; ``groups`` / ``coords`` hold every other axis's
    group (None for an axis of 1) and coordinate; ``process_rank`` is the
    rank in the default group.  ``seq_split``: the token tensors a model
    sees hold this rank's block of the sequence (``shard_batch`` with a
    partition naming ``seq``): positions are offset by the block's start,
    the [CLS] row lives on the first ``seq`` rank, attention gathers or
    rings its keys.  Unset, a rank holds whole rows.  The train loop sets
    it for a run with a ``batch_partition`` over ``seq``.  ``whole_batch``:
    a rank's loss is its share of one loss over the whole batch, as the
    reference's implicit (GSPMD) mode computes it, so a statistic over the
    batch's tokens (a masked mean's count, the MoE aux loss's means) is
    summed over ``data`` (``models.transformer.batch_groups``).  The train
    loop sets it in its implicit mode; the explicit modes average the
    ranks' own losses, as the reference's do."""

    group: Any
    rank: int
    shape: Dict[str, int]
    device: torch.device
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    process_rank: Optional[int] = None
    seq_split: bool = False
    whole_batch: bool = False

    @property
    def size(self) -> int:
        """The ``data`` axis: the number of processes a batch's rows are
        dealt over."""
        return int(self.shape["data"])

    @property
    def world(self) -> int:
        """The number of processes of the mesh: every axis's size."""
        return int(math.prod(int(v) for v in self.shape.values()))

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_rank(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        if axis == "data":
            return self.rank
        return int(self.coords.get(axis, 0))

    def axis_group(self, axis: str) -> Any:
        """The process group of ``axis`` (None: the identity)."""
        if axis == "data":
            return self.group
        return self.groups.get(axis)

    @property
    def global_rank(self) -> int:
        return self.rank if self.process_rank is None else self.process_rank

    @property
    def backend(self) -> str:
        """The groups' backend ("nccl", "gloo"), "" without a group."""
        for group in (self.group, *self.groups.values()):
            if group is not None:
                import torch.distributed as dist

                return str(dist.get_backend(group))
        return ""


def as_mesh_config(config: Any) -> MeshConfig:
    """A ``MeshConfig`` from a ``MeshConfig``, a dict of axis sizes (the
    Trainer's ``mesh_config``) or None (all devices on ``data``)."""
    if config is None:
        return MeshConfig()
    if isinstance(config, MeshConfig):
        return config
    return MeshConfig(**dict(config))


def coords_of(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """The coordinates of process ``rank`` on the axes: ``AXES`` order,
    row-major, the last axis fastest (the reference's reshape)."""
    out = {}
    for axis in reversed(AXES):
        n = int(sizes[axis])
        out[axis] = rank % n
        rank //= n
    return {a: out[a] for a in AXES}


def _axis_groups(sizes: Dict[str, int], rank: int, world_group: Any) -> Dict[str, Any]:
    """One process group per axis above 1: the processes whose coordinates
    differ on that axis alone.  ``dist.new_group`` is collective over the
    default group, so every process creates every group, axis by axis in
    ``AXES`` order and each axis's groups in rank order, and keeps its own;
    an axis that spans every process is the default group itself."""
    import torch.distributed as dist

    world = math.prod(sizes.values())
    every = [coords_of(r, sizes) for r in range(world)]
    groups: Dict[str, Any] = {}
    for axis in AXES:
        n = int(sizes[axis])
        if n == 1:
            groups[axis] = None
            continue
        if n == world:
            groups[axis] = world_group
            continue
        seen = []
        for r in range(world):
            key = tuple(v for a, v in every[r].items() if a != axis)
            if key in seen:
                continue
            seen.append(key)
            members = [q for q in range(world) if tuple(
                v for a, v in every[q].items() if a != axis) == key]
            group = dist.new_group(members)
            if rank in members:
                groups[axis] = group
    return groups


def make_mesh(config: Any = None, *, device: Any = "cuda",
              group: Any = None) -> DeviceMesh:
    """The mesh over ``group`` (default: the default process group when
    one exists, else a mesh of this one process).

    ``device``: this process's device; a CUDA device without an index is
    the current one (``maybe_initialize_from_env`` set it to the local
    rank's).  Raises the reference's ``ValueError`` when the axes do not
    cover the processes.  Axes other than ``data`` above 1 need the
    default group (their groups are made from it, collectively: every
    process calls ``make_mesh`` with the same config)."""
    import torch.distributed as dist

    config = as_mesh_config(config)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is not None:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    sizes = config.resolve(world)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if sizes["data"] == world:
        return DeviceMesh(group=group, rank=rank, shape=sizes, device=dev,
                          process_rank=rank)
    if group is not dist.group.WORLD:
        raise ValueError("a mesh with an axis other than 'data' above 1 is "
                         "made over the default process group")
    groups = _axis_groups(sizes, rank, group)
    coords = coords_of(rank, sizes)
    return DeviceMesh(group=groups.pop("data"), rank=coords["data"],
                      shape=sizes, device=dev, groups=groups, coords=coords,
                      process_rank=rank)


# Key under which shard_batch records row validity when it had to pad a
# short batch to the mesh data axis: float32 [batch], 1.0 = real row,
# 0.0 = zero padding.  Loss/metric code weights by it via masked_mean().
VALID_MASK_KEY = "__valid__"


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n (static batch padding helper)."""
    return ((n + k - 1) // k) * k


def local_rows(batch: Any, mesh: DeviceMesh, *, pad_to_mesh: bool = True) -> Any:
    """This process's contiguous rows of a global host batch, on the host.

    A dict batch whose row count does not divide the mesh ``data`` axis
    (a short tail) is zero-padded up to the next multiple and gains a
    ``VALID_MASK_KEY`` float32 row-validity mask (1.0 real, 0.0 padding)
    first, exactly as the reference pads; a batch that divides takes the
    exact unpadded path with no mask key.  A non-dict batch (one array)
    must divide."""
    n_data = mesh.size
    if (pad_to_mesh and n_data > 1 and isinstance(batch, dict) and batch
            and VALID_MASK_KEY not in batch):
        n = len(np.asarray(next(iter(batch.values()))))
        target = pad_to_multiple(n, n_data)
        if target != n:
            pad = target - n

            def pad_rows(x):
                arr = np.asarray(x)
                return np.concatenate(
                    [arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)]
                )

            batch = {k: pad_rows(v) for k, v in batch.items()}
            batch[VALID_MASK_KEY] = np.concatenate(
                [np.ones(n, np.float32), np.zeros(pad, np.float32)]
            )

    def rows(x):
        arr = np.asarray(x)
        if arr.shape[0] % n_data:
            raise ValueError(
                f"batch dim {arr.shape[0]} not divisible by the mesh data "
                f"axis ({n_data})"
            )
        k = arr.shape[0] // n_data
        return arr[mesh.rank * k:(mesh.rank + 1) * k]

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)


def sequence_block(batch: Dict[str, Any], mesh: DeviceMesh,
                   partition: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Each feature ``partition`` splits over ``seq`` cut to this rank's
    contiguous block along that dim (host arrays or tensors); the others
    whole.  The identity on a ``seq`` axis of 1."""
    n = mesh.axis_size("seq")
    if n == 1 or not partition:
        return batch
    r = mesh.axis_rank("seq")
    out = dict(batch)
    for key, spec in partition.items():
        dim = spec_dim(tuple(spec or ()), "seq")
        if dim is None or key not in out:
            continue
        x = out[key]
        length = x.shape[dim]
        if length % n:
            raise ValueError(
                f"batch feature {key!r}: dim {dim} of {tuple(x.shape)} not "
                f"divisible by mesh axis seq={n}")
        k = length // n
        index = [slice(None)] * len(x.shape)
        index[dim] = slice(r * k, (r + 1) * k)
        out[key] = x[tuple(index)]
    return out


def shard_batch(batch: Any, mesh: DeviceMesh, *, pad_to_mesh: bool = True,
                partition: Optional[Dict[str, Any]] = None) -> Any:
    """This process's part of a global host batch, as tensors on the
    mesh's device: its rows (:func:`local_rows`, the reference's padding
    and mask), and, for the features ``partition`` (a ``batch_partition``:
    key -> spec such as ``("data", "seq")``) splits over ``seq``, its
    block of the sequence (:func:`sequence_block`); then one copy to the
    device.  The processes' parts, concatenated in rank order along each
    axis, are the reference's global (padded) arrays."""
    local = local_rows(batch, mesh, pad_to_mesh=pad_to_mesh)
    if isinstance(local, dict):
        local = sequence_block(local, mesh, partition)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)

    if isinstance(local, dict):
        return {k: put(v) for k, v in local.items()}
    return put(local)


def masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Mean of per-row ``values`` over valid rows.

    ``mask=None`` (the unpadded case) is exactly ``torch.mean``, so callers
    can write ``masked_mean(per_row, batch.get(VALID_MASK_KEY))``.  With a
    mask, padded rows are weighted out of both numerator and denominator;
    ``values`` may carry trailing dims (per-row vectors), the mask
    broadcasts from the batch dim."""
    values = torch.as_tensor(values)
    if mask is None:
        return torch.mean(values)
    mask = torch.as_tensor(mask, device=values.device).to(values.dtype)
    weights = mask.reshape(mask.shape + (1,) * (values.ndim - mask.ndim))
    per_row = float(np.prod(values.shape[mask.ndim:], dtype=np.int64) or 1)
    denom = torch.sum(mask) * per_row
    return torch.sum(values * weights) / torch.clamp(denom, min=1.0)
