"""Parallelism layer: the mesh over ``torch.distributed``, parameter
partitions, the multi-process bootstrap and sequence-parallel attention
(the port of ``tpu_pipelines/parallel``).

One process per device joins a process group (``distributed.py``); the
mesh lays the processes out on its axes, one group per axis
(``mesh.py``); fsdp's and the experts' partitions are in
``partition.py``; the differentiable exchanges over an axis in
``collectives.py``; ring and Ulysses attention over ``seq`` in
``ring_attention.py``.  The reference's ``shard_map`` (its
``compat.py``) has no counterpart: each process runs its own part.
Tensor and pipeline parallelism wait for ROADMAP.md A6b.
"""

from tpu_pipelines_torch.parallel.mesh import (  # noqa: F401
    VALID_MASK_KEY,
    DeviceMesh,
    MeshConfig,
    make_mesh,
    masked_mean,
    shard_batch,
)
