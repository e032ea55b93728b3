"""The data-parallel mesh, the port of ``tpu_pipelines/parallel/mesh.py``.

The reference's only scaling axis is synchronous data parallelism: batch
rows sharded over the mesh's ``data`` axis, gradients reduced over it.
Here the ``data`` axis is the ``torch.distributed`` process group, one
process per device, and :func:`make_mesh` returns a :class:`DeviceMesh`:
the group, this process's rank, the axis sizes and the device.  The other
axes (``model``, ``seq``, ``expert``, ``pipe``) keep their names and
default to 1; any of them above 1 raises ``NotImplementedError`` naming
``ROADMAP.md`` A6, where tensor, sequence, expert and pipeline parallelism
wait.

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


def refuse_unported_axes(sizes: Dict[str, int], what: str = "mesh") -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md A6 when an axis
    other than ``data`` is above 1."""
    others = {a: s for a, s in sizes.items() if a != "data" and s != 1}
    if others:
        raise NotImplementedError(
            f"{what} axes {others} are not ported yet (tensor, sequence, "
            "expert and pipeline parallelism, ROADMAP.md A6); the port "
            "shards the batch over 'data' only"
        )


@dataclasses.dataclass
class DeviceMesh:
    """The port's mesh: the process group over the ``data`` axis (None for
    a run of one process with no group, whose collectives are the
    identity), this process's rank in it, the axis sizes and this
    process's device."""

    group: Any
    rank: int
    shape: Dict[str, int]
    device: torch.device

    @property
    def size(self) -> int:
        """The ``data`` axis: the number of processes."""
        return int(self.shape["data"])

    @property
    def backend(self) -> str:
        """The group's backend ("nccl", "gloo"), "" without a group."""
        if self.group is None:
            return ""
        import torch.distributed as dist

        return str(dist.get_backend(self.group))


def as_mesh_config(config: Any) -> MeshConfig:
    """A ``MeshConfig`` from a ``MeshConfig``, a dict of axis sizes (the
    Trainer's ``mesh_config``) or None (all devices on ``data``)."""
    if config is None:
        return MeshConfig()
    if isinstance(config, MeshConfig):
        return config
    return MeshConfig(**dict(config))


def make_mesh(config: Any = None, *, device: Any = "cuda",
              group: Any = None) -> DeviceMesh:
    """The mesh over ``group`` (default: the default process group when
    one exists, else a mesh of this one process).

    ``device``: this process's device; a CUDA device without an index is
    the current one (``maybe_initialize_from_env`` set it to the local
    rank's).  Raises ``NotImplementedError`` (ROADMAP.md A6) for an axis
    other than ``data`` above 1, and the reference's ``ValueError`` when
    the axes do not cover the processes."""
    import torch.distributed as dist

    config = as_mesh_config(config)
    refuse_unported_axes(dataclasses.asdict(config))
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
    return DeviceMesh(group=group, rank=rank, shape=sizes, device=dev)


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


def shard_batch(batch: Any, mesh: DeviceMesh, *, pad_to_mesh: bool = True) -> Any:
    """This process's rows of a global host batch, as tensors on the
    mesh's device: :func:`local_rows` (the reference's padding and mask),
    then one copy to the device.  The processes' rows, concatenated in rank
    order, are the reference's global (padded) arrays."""
    local = local_rows(batch, mesh, pad_to_mesh=pad_to_mesh)

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
